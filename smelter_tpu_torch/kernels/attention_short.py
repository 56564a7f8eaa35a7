"""Short-sequence attention: softmax(q k^T * scale) v over equal (B, H, N,
hd) q, k and v with N <= 512, whole score rows on chip.

Arithmetic follows the Pallas kernel: f32 scores times scale, key columns
past N at -1e30 (the kernel pads N to its tile; the Hopper kernels -inf),
an exact softmax (max, exp, divide by the sum) in f32, p rounded to v's
dtype before p V, whose sum runs in f32, and the output in q's dtype. The
Hopper kernels' 16-bit paths take the fast exp and multiply by the sum's
reciprocal; p is rounded to 8 or 11 bits next.

Replaces the Pallas kernel `smelter_tpu/kernels/attention_short.py::
short_attention`. The Hopper kernel is `csrc/attention_short.cu`:

- What bounds it on an H100: the bytes. At ViT-B/16 224 px (B 128, H 12,
  N 197, hd 64) a call moves 155 MB of q, k, v and out (46 us at 3.35
  TB/s) for 15.3 GFLOP.
- What the design does about it: bf16/f16 at hd 16, 32, 64, 128 run the
  normalised form of `csrc/wgmma_attention.cuh`, the Pallas kernel's order
  (each row's exact max and sum over all keys, then p = e / sum rounded
  before p V): a persistent CTA an SM takes work items of 128 query rows of
  one (batch, head), a producer thread brings Q and all the head's K and V
  into shared memory by TMA through 4-D maps of their strides (the next
  item's while the consumers work), two consumer warpgroups run S = Q K^T
  and P V on wgmma, one pass over up to 256 keys (the first 128-key tile's
  exps staged in shared memory), two passes over resident K and V past that;
  the output goes out through q's strides. `attention_plan.short_plan` picks
  the form; what it does not take (f32 in full f32, other head dims, strides
  or bases a TMA map cannot take, hd 128 past 384 keys) keeps the file's
  mma.sync kernel or its warp-per-query-row kernel.

Operands are read through their strides and the output takes q's, as
`kernels/flash_attention.py` describes. On a CPU or `meta` tensor
`short_attention` takes the plain version (`short_attention_plain`); on a
CUDA tensor it launches the kernel or raises. `launches` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import torch

from . import _build, attention_plan
from .flash_attention import check_operands, strided

launches = 0

MAX_N = 512  # score rows held in shared memory (csrc/attention_short.cu)


def short_attention_plain(q, k, v, *, scale: float) -> torch.Tensor:
    """The Pallas kernel's arithmetic in plain PyTorch."""
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(v.dtype)
    return torch.einsum("bhnm,bhmd->bhnd", p.float(), v.float()).to(q.dtype)


def plan(q, k, v, out) -> attention_plan.AttnPlan:
    """The form `short_attention` takes for these CUDA operands (each with a
    contiguous last axis) and its output."""
    B, H, N, hd = q.shape
    strides = [[t.stride(0), t.stride(1), t.stride(2)] for t in (q, k, v, out)]
    return attention_plan.short_plan(B, H, N, hd, strides, q.dtype,
                                     aligned=_build.aligned16(q, k, v, out),
                                     sms=_build.sms(q.device))


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
    form = plan(q, k, v, out)
    lib = _build.library("attention_short")
    with torch.cuda.device(q.device):
        rc = lib.smelter_short_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, N, hd, *qs, *ks,
            *vs, *strided(out)[1], float(scale), _build.DTYPE_CODES[q.dtype], form.code,
            form.tiles, form.stages, form.grid, _build.stream_of(q))
    _build.check(lib, rc, "short_attention")
    launches += 1
    return out
