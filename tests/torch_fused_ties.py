"""Rows of x that put the fused int8 GEMMs' quantizer on its ties: a test
helper shared by the CPU tests and the card tests.

This file imports neither JAX nor either package.
"""

from __future__ import annotations

import torch


def tie_rows(dtype: torch.dtype) -> torch.Tensor:
    """Rows whose absmax (the first value) sets s = absmax / 127, then values
    at (k + 0.5) s for every k in [-127, 126], one ulp of the dtype on
    either side of each, and +-absmax: with s a power of two (absmax 127
    2^e: every tie exact in any dtype) and with s not one (the ties rounded
    to the dtype); then an all-zero row (the 1e-30 floor). Rows are
    zero-padded to the longest."""
    rows = []
    for e, a in ((-3, None), (0, None), (5, None), (None, 3.7), (None, 0.0123)):
        amax = 127 * 2.0 ** e if a is None else a
        s = torch.tensor(amax, dtype=torch.float32) / 127
        t = ((torch.arange(-127, 127, dtype=torch.float64) + 0.5) * s.double()).to(dtype)
        inf = torch.tensor(float("inf"), dtype=dtype)
        vals = torch.cat([t, torch.nextafter(t, inf), torch.nextafter(t, -inf),
                          torch.tensor([amax, -amax], dtype=dtype)])
        top = torch.tensor(amax, dtype=dtype)
        vals = vals[vals.abs() <= top]
        rows.append(torch.cat([top.reshape(1), vals]))
    width = max(len(r) for r in rows)
    out = torch.zeros(len(rows) + 1, width, dtype=dtype)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out
