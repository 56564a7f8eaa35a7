"""Short-sequence attention: softmax(q k^T * scale) v over equal (B, H, N,
hd) q, k and v with N <= 512, whole score rows on chip.

Arithmetic follows the Pallas kernel: f32 scores times scale, key columns
past N at -1e30 (the kernel pads N to its tile), an exact softmax (max,
exp, divide by the sum) in f32, p rounded to v's dtype before p V, whose
sum runs in f32, and the output in q's dtype. The Hopper kernel's 16-bit
path takes the fast exp and multiplies by the sum's reciprocal; p is
rounded to 8 or 11 bits next.

Replaces the Pallas kernel `smelter_tpu/kernels/attention_short.py::
short_attention`. The Hopper kernel is `csrc/attention_short.cu` on the
pieces of `csrc/attention.cuh`:

- What bounds it on an H100: the bytes. At ViT-B/16 224 px (B 128, H 12,
  N 197, hd 64) a call moves 155 MB of q, k, v and out (46 us at 3.35
  TB/s) for 15.3 GFLOP.
- What the simple design does about it: one block of 4 warps a (batch,
  head, 64 query rows) holds those rows' f32 scores over every key in
  shared memory (128 KB at N 512), takes the softmax there and writes p
  over the scores, so the (N, N) matrix never reaches device memory; K and
  V stream through one 64-key tile; mma.sync with f32 accumulation. f32 (in
  full f32), other head dims and unaligned rows take a warp-per-query-row
  kernel.

Operands are read through their strides and the output takes q's, as
`kernels/flash_attention.py` describes. On a CPU or `meta` tensor
`short_attention` takes the plain version (`short_attention_plain`); on a
CUDA tensor it launches the kernel or raises. `launches` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import torch

from . import _build
from .flash_attention import check_operands, strided

launches = 0

MAX_N = 512  # score rows held in shared memory (csrc/attention_short.cu)


def short_attention_plain(q, k, v, *, scale: float) -> torch.Tensor:
    """The Pallas kernel's arithmetic in plain PyTorch."""
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(v.dtype)
    return torch.einsum("bhnm,bhmd->bhnd", p.float(), v.float()).to(q.dtype)


def short_attention(q, k, v, *, scale: float) -> torch.Tensor:
    """Attention over equal (B, H, N, hd) q, k, v with N <= 512; returns
    (B, H, N, hd) in q's dtype."""
    global launches
    if q.device.type in ("cpu", "meta"):
        return short_attention_plain(q, k, v, scale=scale)
    check_operands("short_attention", q, k, v)
    B, H, N, hd = q.shape
    if k.shape != q.shape or N > MAX_N:
        raise ValueError(f"short_attention: q {tuple(q.shape)} and k {tuple(k.shape)} must be "
                         f"equal, with N <= {MAX_N}")
    (q, qs), (k, ks), (v, vs) = strided(q), strided(k), strided(v)
    out = torch.empty_like(q)
    lib = _build.library("attention_short")
    with torch.cuda.device(q.device):
        rc = lib.smelter_short_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, N, hd, *qs, *ks,
            *vs, *strided(out)[1], float(scale), _build.DTYPE_CODES[q.dtype],
            _build.stream_of(q))
    _build.check(lib, rc, "short_attention")
    launches += 1
    return out
