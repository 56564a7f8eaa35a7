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
  TFLOP/s dense bf16) against ~80 MB of operands and output; the two
  projections are 89 % of it (on mma.sync they took 0.75 of 1.03 ms,
  attention 0.26: `experiments/torch_vit_block_split.py`).
- What the design does about it: the Pallas kernel keeps an image and all
  weights in VMEM; a ViT-B image alone (302 KB in bf16) exceeds a block's
  shared memory, so one call is a fixed sequence of four launches: pre-LN;
  the QKV product on `csrc/wgmma_gemm.cuh`'s `gemm_tma` (wgmma fed by TMA,
  the packed weight read in place through a 3-D map, the f32 bias added in
  the epilogue); attention on `csrc/wgmma_attention.cuh`'s normalised form
  (wgmma for Q K^T and for P V, Q, K and V by TMA, one pass over the keys
  up to 256 of them, else K and V resident in shared memory); the output
  projection on `gemm_tma` with the bias and the residual added in f32 and
  one rounding. `plans` picks each launch's form from the shape
  (`wgmma_plan.block_plan`, `attention_plan.vit_plan`); what the new forms
  do not take, and f32, keep `csrc/gemm.cuh`'s mma.sync or FMA GEMM and
  the file's mma.sync or warp-per-row attention. Intermediates (xn, q/k/v,
  the attention output) go through device memory in scratch the wrapper
  allocates.

On a CPU or `meta` tensor `vit_attention_block` takes the plain version
(`vit_attention_block_plain`), and on a CUDA tensor it launches the kernel
or raises. `launches` counts calls that launched the kernel sequence, once a
call, and nothing else.
"""

from __future__ import annotations

import math

import torch

from . import _build, attention_plan, wgmma_plan
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


def legacy_plans():
    """Every launch on the earlier kernels: csrc/gemm.cuh's GEMM and the
    file's mma.sync (f32: warp-per-row) attention, as f32 always runs."""
    mma = wgmma_plan.Plan("mma", wgmma_plan.BM, wgmma_plan.TMA_BN, 1, 0, 0, 0)
    return mma, mma, attention_plan.MMA


def plans(B: int, N: int, D: int, heads: int, dtype, *, sms: int = wgmma_plan.SMS):
    """The forms of the QKV product, the output projection and attention for
    x (B, N, D) of `dtype` (bases 16-byte aligned, as the wrapper requires)."""
    if dtype not in (torch.bfloat16, torch.float16):
        return legacy_plans()
    hd = D // heads
    M = B * N
    return (wgmma_plan.block_plan(M, 3 * D, D, group=head_group(heads, hd) * hd, sms=sms),
            wgmma_plan.block_plan(M, D, D, sms=sms),
            attention_plan.vit_plan(B, N, heads, hd, sixteen_bit=True, sms=sms))


def _launch(x, ln_g, ln_b, wqkv_packed, bqkv_packed, w_proj, b_proj, mask, forms, *,
            heads: int, scale, eps: float, residual: bool, pre_ln: bool,
            mask_filter: float) -> torch.Tensor:
    """The kernel sequence on checked operands, each launch on the form
    `forms` (qkv, proj, attn) gives it."""
    B, N, D = x.shape
    hd = D // heads
    M = B * N
    qkv_p, proj_p, attn_p = forms
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
            _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[ln_g.dtype],
            qkv_p.code, qkv_p.grid, proj_p.code, proj_p.grid, attn_p.code, attn_p.tiles,
            attn_p.stages, attn_p.grid, _build.stream_of(x))
    _build.check(lib, rc, "vit_attention_block")
    return out


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
    _check(x, (ln_g, ln_b, bqkv_packed, b_proj), wqkv_packed, w_proj, mask, heads)
    B, N, D = x.shape
    forms = plans(B, N, D, heads, x.dtype, sms=_build.sms(x.device))
    out = _launch(x, ln_g, ln_b, wqkv_packed, bqkv_packed, w_proj, b_proj, mask, forms, **kw)
    launches += 1
    return out
