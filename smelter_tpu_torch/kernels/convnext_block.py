"""Whole ConvNeXt block: depthwise 7x7 (+ bias) -> LayerNorm over C -> FC1
(+ b1) -> exact GELU -> FC2 (+ b2) -> * gamma -> + x.

x (B, H, W, C) NHWC; dw_w (7, 7, 1, C) HWIO depthwise, w1 (C, F) and w2
(F, C) in x's dtype; dw_b, LN gamma and beta, b1, b2 and the layer scale
gamma in f32 or in x's dtype. Rounding follows the Pallas kernel, not
`convnext_block_reference`: the 49 products of x and the weights summed in
f32 with the bias added in f32; the LayerNorm in f32, xn rounded once; x @
w1 summed in f32 with b1 added in f32 before the GELU (the exact form as the
Abramowitz-Stegun 7.1.26 polynomial over exp, which is what the Pallas
kernel spells); h rounded once; h @ w2 in f32 with b2 added in f32, times
gamma, x added in f32; one rounding. (The JAX package's reference instead
rounds the conv output and x @ w1 to x's dtype before their biases, and
uses erf.)

Replaces the Pallas kernel `smelter_tpu/kernels/convnext_block.py::
convnext_block`. The Hopper kernel is `csrc/convnext_block.cu`:

- What bounds it on an H100: the tensor cores for FC1 and FC2 (at
  ConvNeXt-T's batch 64 a stage-1 call does 29.6 GFLOP there, ~30 us at 989
  TFLOP/s dense bf16) and the CUDA cores for the depthwise taps (0.94 G f32
  FMAs, ~28 us at 67 TFLOP/s), against ~77 MB of x, weights and output (~23
  us at 3.35 TB/s).
- What the design does about it: the Pallas kernel keeps one padded image
  and both weights in VMEM; the padded stage-1 image alone is 738 KB, three
  times a block's shared memory, so one call is a fixed sequence of the
  library's own launches. The depthwise conv and LayerNorm read each input
  row (and its halo) into shared memory once and sum the taps in registers
  (`dw_ln_staged`; more than 384 channels read through the cache); FC1 (b1
  and GELU in the epilogue) and FC2 (b2, gamma and the
  residual in the epilogue) run on the wgmma GEMM core (`gemm_tma` of
  `csrc/wgmma_gemm.cuh`) where `plans` says "tma", else on `csrc/gemm.cuh`'s
  mma.sync GEMM; f32 on its full-f32 FMA kernel. xn and the hidden h go
  through device memory in scratch the wrapper allocates.

On a CPU or `meta` tensor `convnext_block` takes the plain version
(`convnext_block_plain`); on a CUDA tensor it launches the kernel sequence
or raises. `launches` counts calls that launched it, once a call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build, wgmma_plan
from .mlp_block import gelu_kernel_form

launches = 0

_X_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_MAX_C = 3072  # channels of the cache-read depthwise step's f32 tile (48 KB at 4 pixels)


def convnext_block_plain(x, dw_w, dw_b, ln_g, ln_b, w1, b1, w2, b2, gamma, *,
                         eps: float = 1e-6) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch."""
    dt = x.dtype
    C = x.shape[-1]
    wd = dw_w.to(dt).float().permute(3, 2, 0, 1)  # (C, 1, 7, 7)
    y = F.conv2d(x.float().permute(0, 3, 1, 2), wd, padding=3, groups=C).permute(0, 2, 3, 1)
    y = y + dw_b.float().reshape(-1)
    mu = y.mean(-1, keepdim=True)
    yc = y - mu
    var = (yc * yc).mean(-1, keepdim=True)
    xn = (yc * torch.rsqrt(var + eps) * ln_g.float().reshape(-1)
          + ln_b.float().reshape(-1)).to(dt)
    h = xn.float() @ w1.to(dt).float() + b1.float().reshape(-1)
    h = gelu_kernel_form(h, False).to(dt)
    y2 = (h.float() @ w2.to(dt).float() + b2.float().reshape(-1)) * gamma.float().reshape(-1)
    return (x.float() + y2).to(dt)


def _check(x, dw_w, w1, w2, params) -> None:
    if x.dim() != 4 or x.dtype not in _X_DTYPES:
        raise TypeError(f"convnext_block: x {tuple(x.shape)} {x.dtype} not taken")
    C = x.shape[-1]
    if tuple(dw_w.shape) != (7, 7, 1, C):
        raise ValueError(f"convnext_block: depthwise weight {tuple(dw_w.shape)}; the kernel "
                         f"takes (7, 7, 1, {C})")
    if w1.dim() != 2 or w1.shape[0] != C or tuple(w2.shape) != (w1.shape[1], C):
        raise ValueError(f"convnext_block: w1 {tuple(w1.shape)} and w2 {tuple(w2.shape)} do "
                         f"not chain with C {C}")
    F_ = w1.shape[1]
    if C % 8 or F_ % 8 or C > _MAX_C:
        raise ValueError(f"convnext_block: C {C} and F {F_} must be multiples of 8, C at most "
                         f"{_MAX_C}")
    if dw_w.dtype != x.dtype or w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise TypeError("convnext_block: the weights must hold x's dtype")
    dw_b, ln_g, ln_b, b1, b2, gamma = params
    if any(t.dtype != dw_b.dtype for t in params) or dw_b.dtype not in (torch.float32, x.dtype):
        raise TypeError("convnext_block: the biases, LN gamma/beta and the layer scale must "
                        "share one dtype, f32 or x's")
    if tuple(t.numel() for t in params) != (C, C, C, F_, C, C):
        raise ValueError("convnext_block: the biases, LN gamma/beta and the layer scale do "
                         "not match C and F")
    for t in (x, dw_w, w1, w2, *params):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("convnext_block: operands must be contiguous, on one device")
    if any(t.data_ptr() % 16 for t in (x, dw_w, w1, w2)):
        raise ValueError("convnext_block: x and the weights must be 16-byte aligned")


def legacy_plans():
    """FC1 and FC2 on `csrc/gemm.cuh` (mma.sync; f32: the full-f32 FMA
    kernel)."""
    mma = wgmma_plan.Plan("mma", wgmma_plan.BM, wgmma_plan.TMA_BN, 1, 0, 0, 0)
    return mma, mma


def plans(M: int, C: int, F: int, dtype, *, sms: int = wgmma_plan.SMS):
    """The forms of FC1 (M, F) = xn @ w1 (`wgmma_plan.block_plan` with the
    GELU epilogue) and FC2 (M, C) = h @ w2 (`wgmma_plan.layer_scale_plan`)
    for rows of `dtype` (bases 16-byte aligned, as the wrapper requires):
    "tma" or "mma" each; f32 always "mma"."""
    if dtype not in (torch.bfloat16, torch.float16):
        return legacy_plans()
    return (wgmma_plan.block_plan(M, F, C, gelu=True, sms=sms),
            wgmma_plan.layer_scale_plan(M, C, F, sms=sms))


def _launch(x, dw_w, dw_b, ln_g, ln_b, w1, b1, w2, b2, gamma, forms, *,
            eps: float) -> torch.Tensor:
    """The kernel sequence on checked operands, FC1 and FC2 on the forms
    `forms` gives them."""
    B, H, W, C = x.shape
    F_ = w1.shape[1]
    M = B * H * W
    fc1, fc2 = forms
    out = torch.empty_like(x)
    xn = torch.empty((M, C), dtype=x.dtype, device=x.device)
    h = torch.empty((M, F_), dtype=x.dtype, device=x.device)
    lib = _build.library("convnext_block")
    with torch.cuda.device(x.device):
        rc = lib.smelter_convnext_block(
            x.data_ptr(), dw_w.data_ptr(), dw_b.data_ptr(), ln_g.data_ptr(), ln_b.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), gamma.data_ptr(),
            xn.data_ptr(), h.data_ptr(), out.data_ptr(), B, H, W, C, F_, float(eps),
            _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[dw_b.dtype], fc1.code, fc1.grid,
            fc2.code, fc2.grid, _build.stream_of(x))
    _build.check(lib, rc, "convnext_block")
    return out


def convnext_block(x, dw_w, dw_b, ln_g, ln_b, w1, b1, w2, b2, gamma, *,
                   eps: float = 1e-6) -> torch.Tensor:
    """The block on x (B, H, W, C); returns x's shape and dtype."""
    global launches
    if x.device.type in ("cpu", "meta"):
        return convnext_block_plain(x, dw_w, dw_b, ln_g, ln_b, w1, b1, w2, b2, gamma, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"convnext_block: no kernel for device {x.device}")
    params = (dw_b, ln_g, ln_b, b1, b2, gamma)
    _check(x, dw_w, w1, w2, params)
    B, H, W, C = x.shape
    forms = plans(B * H * W, C, w1.shape[1], x.dtype, sms=_build.sms(x.device))
    out = _launch(x, dw_w, dw_b, ln_g, ln_b, w1, b1, w2, b2, gamma, forms, eps=eps)
    launches += 1
    return out
