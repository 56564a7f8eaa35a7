"""Cross-attention block against constant keys and values: q = x Wq -> per
head softmax(q k^T * scale) v -> att Wp + bp.

x (B, N, D), already normalized (the upstream SkipLayerNormalization owns
the LN); wq and wp (D, D), k and v (Bk, heads, S, hd) with Bk 1 (one context
for every image) or B (one an image), all in x's dtype; bp (D,) in f32 or
x's dtype. The residual stays outside. Rounding follows the Pallas kernel:
q rounded to x's dtype; scores summed in f32 and times scale; the softmax in
f32 (exp(s - max) / sum), p rounded to x's dtype; p v summed in f32; the
heads' outputs side by side rounded to x's dtype; att Wp in f32 with bp
added in f32; one rounding.

Replaces the Pallas kernel `smelter_tpu/kernels/vit_block.py::
cross_attn_block`. The Hopper kernels are `csrc/cross_attn_block.cu`'s:

- What bounds it on an H100: at SD-UNet's sizes not the bytes or the
  operations but latency. At (B 8, N 1024, D 128, 8 heads, S 16) a call does
  0.60 GFLOP (0.6 us at 989 TFLOP/s dense bf16) against 4.3 MB of operands
  and output (1.3 us at 3.35 TB/s); at (B 8, N 256, D 256) 0.57 GFLOP and
  2.5 MB (0.74 us). What is left is the launch and a chain of dependent
  load -> product -> softmax -> product steps.
- What the design does about it (the "wgmma" form, 16-bit x with D a
  multiple of 64; `attention_plan.cross_plan`): a CTA takes 64 query rows
  of one image x a group of 64 / hd heads, so the card holds D / 64 CTAs
  a row tile (128 at (N 256, D 256), where one block a tile gave 32). One
  thread brings x, Wq's and Wp's group columns and the group's k and v by
  TMA at once; q, the scores and p v run on wgmma with q and p kept in
  registers as A fragments; the row tile's CTAs form a cluster that shares
  their attention outputs (bf16, 8 KB a CTA) through distributed shared
  memory, and each CTA then computes its group's output columns over the
  whole of D, adds bp in f32 and rounds once (no K split, no atomics: a
  row's result does not depend on its batch position).
- Other 16-bit shapes take the "mma" form (one block of 4 warps a 64-row
  tile on mma.sync, the weights streamed through shared memory), f32 the
  CUDA-core kernel in full f32. Head dims 16, 32 and 64, S at most 64 and D
  at most 256 are taken; anything else raises.

On a CPU or `meta` tensor `cross_attn_block` takes the plain version
(`cross_attn_block_plain`); on a CUDA tensor it launches the kernel or
raises. `launches` counts calls that launched it, `forms` the same by form.
"""

from __future__ import annotations

import math

import torch

from . import _build, attention_plan

launches = 0
forms = {"wgmma": 0, "mma": 0, "f32": 0}

_X_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_HEAD_DIMS = (16, 32, 64)
_MAX_S = 64
_MAX_D = 256


def cross_attn_block_plain(x, wq, k, v, wp, bp, *, heads: int,
                           scale: float | None = None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch."""
    B, N, D = x.shape
    hd = D // heads
    scale = scale if scale else 1.0 / math.sqrt(hd)
    dt = x.dtype
    q = (x.reshape(B * N, D).float() @ wq.to(dt).float()).to(dt)
    q = q.reshape(B, N, heads, hd).transpose(1, 2).float()
    kf = k.to(dt).float().expand(B, -1, -1, -1)
    vf = v.to(dt).float().expand(B, -1, -1, -1)
    s = torch.einsum("bhnd,bhsd->bhns", q, kf) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(dt)
    a = torch.einsum("bhns,bhsd->bhnd", p.float(), vf)
    att = a.transpose(1, 2).reshape(B * N, D).to(dt)
    out = att.float() @ wp.to(dt).float() + bp.float().reshape(-1)
    return out.to(dt).reshape(B, N, D)


def _check(x, wq, k, v, wp, bp, heads: int) -> None:
    if x.dim() != 3 or x.dtype not in _X_DTYPES:
        raise TypeError(f"cross_attn_block: x {tuple(x.shape)} {x.dtype} not taken")
    B, N, D = x.shape
    hd = D // heads if heads > 0 else 0
    if heads <= 0 or D % heads or hd not in _HEAD_DIMS or D > _MAX_D:
        raise ValueError(f"cross_attn_block: D {D} in {heads} heads not taken (head dim one "
                         f"of {_HEAD_DIMS}, D at most {_MAX_D})")
    if tuple(wq.shape) != (D, D) or tuple(wp.shape) != (D, D):
        raise ValueError(f"cross_attn_block: weights {tuple(wq.shape)}, {tuple(wp.shape)} do "
                         f"not match D {D}")
    if k.dim() != 4 or tuple(v.shape) != tuple(k.shape) or k.shape[0] not in (1, B) \
            or tuple(k.shape[1:2]) + tuple(k.shape[3:]) != (heads, hd):
        raise ValueError(f"cross_attn_block: k {tuple(k.shape)} and v {tuple(v.shape)}; the "
                         f"kernel takes (1 or {B}, {heads}, S, {hd})")
    if not 1 <= k.shape[2] <= _MAX_S:
        raise ValueError(f"cross_attn_block: S {k.shape[2]} keys; the kernel takes 1 to "
                         f"{_MAX_S}")
    if any(t.dtype != x.dtype for t in (wq, k, v, wp)):
        raise TypeError("cross_attn_block: the weights, k and v must hold x's dtype")
    if bp.dtype not in (torch.float32, x.dtype) or bp.numel() != D:
        raise TypeError("cross_attn_block: bp must be (D,) in f32 or x's dtype")
    for t in (x, wq, k, v, wp, bp):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("cross_attn_block: operands must be contiguous, on one device")
    if any(t.data_ptr() % 16 for t in (x, wq, k, v, wp)):
        raise ValueError("cross_attn_block: x, the weights, k and v must be 16-byte aligned")


def plan(x, k, heads: int) -> attention_plan.CrossPlan:
    """The kernel `cross_attn_block` launches for x (B, N, D) and k (Bk,
    heads, S, hd)."""
    B, N, D = x.shape
    return attention_plan.cross_plan(B, N, D, heads, k.shape[2], x.dtype)


def cross_attn_block(x, wq, k, v, wp, bp, *, heads: int,
                     scale: float | None = None) -> torch.Tensor:
    """The block on x (B, N, D); returns (B, N, D) in x's dtype. scale None
    or 0 means 1/sqrt(hd)."""
    global launches
    if x.device.type in ("cpu", "meta"):
        return cross_attn_block_plain(x, wq, k, v, wp, bp, heads=heads, scale=scale)
    if x.device.type != "cuda":
        raise ValueError(f"cross_attn_block: no kernel for device {x.device}")
    _check(x, wq, k, v, wp, bp, heads)
    p = plan(x, k, heads)
    out = _launch(x, wq, k, v, wp, bp, heads, scale, p)
    launches += 1
    forms[p.form] += 1
    return out


def _launch(x, wq, k, v, wp, bp, heads: int, scale, p) -> torch.Tensor:
    """One launch of plan p's kernel on checked CUDA operands."""
    B, N, D = x.shape
    scale = scale if scale else 1.0 / math.sqrt(D // heads)
    out = torch.empty_like(x)
    lib = _build.library("cross_attn_block")
    with torch.cuda.device(x.device):
        rc = lib.smelter_cross_attn_block(
            x.data_ptr(), wq.data_ptr(), k.data_ptr(), v.data_ptr(), wp.data_ptr(),
            bp.data_ptr(), out.data_ptr(), B, N, D, heads, k.shape[2], k.shape[0],
            float(scale), _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[bp.dtype], p.code,
            _build.stream_of(x))
    _build.check(lib, rc, "cross_attn_block")
    return out
