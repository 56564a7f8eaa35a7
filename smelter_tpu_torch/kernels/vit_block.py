"""Whole-block ViT attention: [LN ->] packed QKV projection + f32 bias ->
per-head softmax(Q K^T * scale [+ mask]) V -> output projection + f32 bias
[+ residual].

x (B, N, D); the QKV weight packed per head group (`head_group` heads a
group) as `passes/vit_block.py::pack_qkv_weights` packs it, (3 n_groups,
D, group*hd) ordered [q_g0, k_g0, v_g0, q_g1, ...] with its bias (1,
3 n_groups, group*hd); w_proj (D, D). Rounding follows the Pallas kernel: the
normalized x, q, k and v, the probabilities and the concatenated attention
output are each rounded to x's dtype; every product sums in f32 and both
biases are added in f32. The mask is ORT's key-padding form, either (B, N)
keep flags (keys get (1 - m) * mask_filter) or (B,) valid lengths (keys at
or past the length get mask_filter).

Replaces the Pallas kernel `smelter_tpu/kernels/vit_block.py::
_vit_block_impl`. The Hopper kernel is `csrc/vit_block.cu`:

- What bounds it on an H100: the tensor cores. At ViT-B/16's batch 128 (B
  128, N 197, D 768, 12 heads) a call does 134.2 GFLOP (~136 us at 989
  TFLOP/s dense bf16) against ~80 MB of operands and output.
- What the simple design does about it: the Pallas kernel keeps an image
  and all weights in VMEM; a ViT-B image alone (302 KB in bf16) exceeds a
  block's shared memory, so one call is a fixed sequence of the library's
  own launches (pre-LN, the QKV GEMM, attention with K and V streamed
  through shared memory, the projection GEMM), on mma.sync with f32
  accumulators. Intermediates (xn, q/k/v, the attention output) go through
  device memory in scratch the wrapper allocates.

On a CPU or `meta` tensor `vit_attention_block` takes the plain version
(`vit_attention_block_plain`), and on a CUDA tensor it launches the kernel
or raises. `launches` counts calls that launched the kernel sequence, once a
call, and nothing else.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .layer_norm import layer_norm_plain

launches = 0

_X_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_MAX_D = 4096   # rows of the pre-LN held in registers
_MAX_HD = 256   # the warp-per-row attention kernel's head dim


def head_group(heads: int, hd: int) -> int:
    """Heads per projection group: the largest divisor of `heads` whose
    group width group*hd fits a 128-lane tile. 2 for hd=64 (ViT/BERT), 4
    for hd=32; odd geometries still get a correct (if narrower) grouping."""
    g = max(1, min(128 // max(hd, 1), heads))
    while heads % g:
        g -= 1
    return g


def _mask_add(mask, B: int, N: int, mask_filter: float, device) -> torch.Tensor:
    """The additive key mask (B, 1, 1, N) in f32."""
    if mask.dim() == 1:
        keys = torch.arange(N, device=device)
        add = torch.where(keys[None] < mask.reshape(B, 1).long(), 0.0, mask_filter)
    else:
        add = (1.0 - mask.float()) * mask_filter
    return add.float().reshape(B, 1, 1, N)


def vit_attention_block_plain(x, ln_g, ln_b, wqkv_packed, bqkv_packed, w_proj, b_proj,
                              mask=None, *, heads: int, scale: float | None = None,
                              eps: float = 1e-5, residual: bool = False, pre_ln: bool = True,
                              mask_filter: float = -10000.0) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch."""
    B, N, D = x.shape
    hd = D // heads
    group = head_group(heads, hd)
    scale = scale if scale else 1.0 / math.sqrt(hd)
    dt = x.dtype
    xn = layer_norm_plain(x, ln_g, ln_b, eps=eps) if pre_ln else x
    # the packed blocks side by side: column j G + c is block j's column c
    w = wqkv_packed.to(dt).permute(1, 0, 2).reshape(D, -1)
    qkv = (xn.reshape(B * N, D).float() @ w.float() + bqkv_packed.float().reshape(-1)).to(dt)
    qkv = qkv.reshape(B, N, heads // group, 3, group, hd)
    q, k, v = (qkv[:, :, :, i].reshape(B, N, heads, hd).transpose(1, 2) for i in range(3))
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * scale
    if mask is not None:
        s = s + _mask_add(mask, B, N, mask_filter, x.device)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(dt)
    a = torch.einsum("bhnm,bhmd->bhnd", p.float(), v.float())
    attn = a.transpose(1, 2).reshape(B * N, D).to(dt)
    out = attn.float() @ w_proj.to(dt).float() + b_proj.float().reshape(-1)
    if residual:
        out = x.reshape(B * N, D).float() + out
    return out.to(dt).reshape(B, N, D)


def _check(x, params, wqkv, w_proj, mask, heads: int) -> None:
    if x.dim() != 3 or x.dtype not in _X_DTYPES:
        raise TypeError(f"vit_attention_block: x {tuple(x.shape)} {x.dtype} not taken")
    B, N, D = x.shape
    hd = D // heads if heads > 0 else 0
    if heads <= 0 or D % heads or hd % 8 or hd > _MAX_HD or D > _MAX_D:
        raise ValueError(f"vit_attention_block: D {D} in {heads} heads not taken (head dim a "
                         f"multiple of 8, at most {_MAX_HD}; D at most {_MAX_D})")
    group = head_group(heads, hd)
    if tuple(wqkv.shape) != (3 * heads // group, D, group * hd) or tuple(w_proj.shape) != (D, D):
        raise ValueError(f"vit_attention_block: weights {tuple(wqkv.shape)}, "
                         f"{tuple(w_proj.shape)} do not match D {D} in {heads} heads")
    if wqkv.dtype != x.dtype or w_proj.dtype != x.dtype:
        raise TypeError("vit_attention_block: the weights must hold x's dtype")
    ln_g, ln_b, bqkv, b_proj = params
    if any(t.dtype != ln_g.dtype for t in params) or ln_g.dtype not in (torch.float32, x.dtype):
        raise TypeError("vit_attention_block: LN gamma/beta and both biases must share one "
                        "dtype, f32 or x's")
    if (ln_g.numel(), ln_b.numel(), bqkv.numel(), b_proj.numel()) != (D, D, 3 * D, D):
        raise ValueError("vit_attention_block: LN gamma/beta and biases do not match D")
    if mask is not None:
        want = ((B,), torch.int32) if mask.dim() == 1 else ((B, N), torch.float32)
        if (tuple(mask.shape), mask.dtype) != want:
            raise TypeError(f"vit_attention_block: mask {tuple(mask.shape)} {mask.dtype}; "
                            f"takes (B,) int32 lengths or (B, N) f32 keep flags")
    for t in [x, wqkv, w_proj, *params] + ([] if mask is None else [mask]):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("vit_attention_block: operands must be contiguous, on one device")
    if x.data_ptr() % 16 or wqkv.data_ptr() % 16 or w_proj.data_ptr() % 16:
        raise ValueError("vit_attention_block: x and the weights must be 16-byte aligned")


def vit_attention_block(x, ln_g, ln_b, wqkv_packed, bqkv_packed, w_proj, b_proj, mask=None,
                        *, heads: int, scale: float | None = None, eps: float = 1e-5,
                        residual: bool = False, pre_ln: bool = True,
                        mask_filter: float = -10000.0) -> torch.Tensor:
    """The block on x (B, N, D); returns (B, N, D) in x's dtype. scale None
    or 0 means 1/sqrt(hd)."""
    global launches
    kw = dict(heads=heads, scale=scale, eps=eps, residual=residual, pre_ln=pre_ln,
              mask_filter=mask_filter)
    if x.device.type in ("cpu", "meta"):
        return vit_attention_block_plain(x, ln_g, ln_b, wqkv_packed, bqkv_packed, w_proj,
                                         b_proj, mask, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"vit_attention_block: no kernel for device {x.device}")
    params = (ln_g, ln_b, bqkv_packed, b_proj)
    _check(x, params, wqkv_packed, w_proj, mask, heads)
    B, N, D = x.shape
    hd = D // heads
    M = B * N
    out = torch.empty_like(x)
    xn = torch.empty((M, D), dtype=x.dtype, device=x.device) if pre_ln else None
    qkv = torch.empty((M, 3 * D), dtype=x.dtype, device=x.device)
    attn = torch.empty((M, D), dtype=x.dtype, device=x.device)
    kind = 0 if mask is None else (2 if mask.dim() == 1 else 1)
    lib = _build.library("vit_block")
    with torch.cuda.device(x.device):
        rc = lib.smelter_vit_block(
            x.data_ptr(), ln_g.data_ptr(), ln_b.data_ptr(), wqkv_packed.data_ptr(),
            bqkv_packed.data_ptr(), w_proj.data_ptr(), b_proj.data_ptr(),
            None if mask is None else mask.data_ptr(), x.data_ptr() if residual else None,
            None if xn is None else xn.data_ptr(), qkv.data_ptr(), attn.data_ptr(),
            out.data_ptr(), B, N, D, heads, head_group(heads, hd), int(bool(pre_ln)), kind,
            float(scale if scale else 1.0 / math.sqrt(hd)), float(eps), float(mask_filter),
            _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[ln_g.dtype], _build.stream_of(x))
    _build.check(lib, rc, "vit_attention_block")
    launches += 1
    return out
