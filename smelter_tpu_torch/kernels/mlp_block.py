"""Whole transformer MLP: [LN ->] FC1 + b1 -> GELU -> FC2 + b2 [+ residual].

x (..., D); w1 (D, F) and w2 (F, D) in x's dtype, laid out as the graph
holds them; LN gamma and beta, b1 and b2 in f32 or in x's dtype. Rounding
follows the Pallas kernel, not `mlp_block_reference`: the LayerNorm in f32
rounded to x's dtype; x @ w1 summed in f32 with b1 added in f32; GELU in f32
(the exact form as the Abramowitz-Stegun 7.1.26 polynomial over exp, which
is what the Pallas kernel spells, or the tanh form); h rounded to x's dtype;
h @ w2 in f32 with b2 added in f32; for residual, the input x (not its LN)
added in f32; one rounding to x's dtype. pre_ln False feeds x to FC1 as it
is.

Replaces the Pallas kernel `smelter_tpu/kernels/mlp_block.py::mlp_block`.
The Hopper kernel is `csrc/mlp_block.cu`:

- What bounds it on an H100: the tensor cores. At ViT-B/16's batch 128
  (25,216 rows, D 768, F 3072) a call does 238 GFLOP (241 us at 989 TFLOP/s
  dense bf16) against ~87 MB of x, weights and output.
- What the design does about it: the Pallas kernel keeps an image's f32
  hidden tile in VMEM; at ViT-B one image's is 2.4 MB, ten times a block's
  shared memory, so one call is a fixed sequence of the library's own
  launches: the pre-LN (`csrc/layer_norm.cuh`), FC1 with its bias and GELU
  in the epilogue, FC2 with its bias and the residual in the epilogue; xn
  and the hidden h go through device memory in scratch the wrapper
  allocates. FC1 and FC2 run on the wgmma GEMM core (`gemm_tma` of
  `csrc/wgmma_gemm.cuh`, TMA loads, wgmma, one persistent CTA an SM) where
  `plans` says "tma" (`wgmma_plan.block_plan`: 16-bit x and shapes its TMA
  maps can read), else on `csrc/gemm.cuh`'s mma.sync GEMM; f32 on its
  full-f32 FMA kernel (no TF32).

On a CPU or `meta` tensor `mlp_block` takes the plain version
(`mlp_block_plain`); on a CUDA tensor it launches the kernel sequence or
raises. `launches` counts calls that launched it, once a call.
"""

from __future__ import annotations

import torch

from . import _build, wgmma_plan
from .layer_norm import layer_norm_plain

launches = 0

_X_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_MAX_D = 4096  # rows of the pre-LN held in registers (csrc/layer_norm.cuh)


def gelu_kernel_form(h: torch.Tensor, approximate: bool) -> torch.Tensor:
    """GELU of f32 h as the Pallas kernel spells it: the tanh form, or the
    exact form through the Abramowitz-Stegun 7.1.26 polynomial for erf
    (|error| < 1.5e-7)."""
    if approximate:
        return 0.5 * h * (1.0 + torch.tanh(0.7978845608028654 * (h + 0.044715 * h * h * h)))
    z = h * 0.7071067811865476
    az = z.abs()
    t = 1.0 / (1.0 + 0.3275911 * az)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    erf = torch.sign(z) * (1.0 - poly * torch.exp(-az * az))
    return 0.5 * h * (1.0 + erf)


def mlp_block_plain(x, ln_g, ln_b, w1, b1, w2, b2, *, eps: float = 1e-5,
                    approximate: bool = False, residual: bool = True,
                    pre_ln: bool = True) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch."""
    dt = x.dtype
    D = x.shape[-1]
    rows = x.reshape(-1, D)
    xn = layer_norm_plain(rows, ln_g.reshape(-1), ln_b.reshape(-1), eps=eps) if pre_ln else rows
    h = xn.float() @ w1.to(dt).float() + b1.float().reshape(-1)
    h = gelu_kernel_form(h, approximate).to(dt)
    y = h.float() @ w2.to(dt).float() + b2.float().reshape(-1)
    if residual:
        y = rows.float() + y
    return y.to(dt).reshape(x.shape)


def _check(x, params, w1, w2, pre_ln: bool) -> None:
    if x.dtype not in _X_DTYPES or x.dim() < 2:
        raise TypeError(f"mlp_block: x {tuple(x.shape)} {x.dtype} not taken")
    D = x.shape[-1]
    if w1.dim() != 2 or w1.shape[0] != D or tuple(w2.shape) != (w1.shape[1], D):
        raise ValueError(f"mlp_block: w1 {tuple(w1.shape)} and w2 {tuple(w2.shape)} do not "
                         f"chain with D {D}")
    F = w1.shape[1]
    if D % 8 or F % 8 or (pre_ln and D > _MAX_D):
        raise ValueError(f"mlp_block: D {D} and F {F} must be multiples of 8, D at most "
                         f"{_MAX_D} under pre_ln")
    if w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise TypeError("mlp_block: the weights must hold x's dtype")
    ln_g, ln_b, b1, b2 = params
    if any(t.dtype != b1.dtype for t in params) or b1.dtype not in (torch.float32, x.dtype):
        raise TypeError("mlp_block: LN gamma/beta and both biases must share one dtype, f32 "
                        "or x's")
    if (ln_g.numel(), ln_b.numel(), b1.numel(), b2.numel()) != (D, D, F, D):
        raise ValueError("mlp_block: LN gamma/beta and biases do not match D and F")
    for t in (x, w1, w2, *params):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("mlp_block: operands must be contiguous, on one device")
    if x.data_ptr() % 16 or w1.data_ptr() % 16 or w2.data_ptr() % 16:
        raise ValueError("mlp_block: x and the weights must be 16-byte aligned")


def legacy_plans():
    """FC1 and FC2 on `csrc/gemm.cuh` (mma.sync; f32: the full-f32 FMA
    kernel)."""
    mma = wgmma_plan.Plan("mma", wgmma_plan.BM, wgmma_plan.TMA_BN, 1, 0, 0, 0)
    return mma, mma


def plans(M: int, D: int, F: int, dtype, *, sms: int = wgmma_plan.SMS):
    """The forms of FC1 (M, F) = xn @ w1 and FC2 (M, D) = h @ w2 for rows of
    `dtype` (bases 16-byte aligned, as the wrapper requires): "tma" or
    "mma" each (`wgmma_plan.block_plan`); f32 always "mma"."""
    if dtype not in (torch.bfloat16, torch.float16):
        return legacy_plans()
    return (wgmma_plan.block_plan(M, F, D, gelu=True, sms=sms),
            wgmma_plan.block_plan(M, D, F, sms=sms))


def _launch(x, ln_g, ln_b, w1, b1, w2, b2, forms, *, eps: float, approximate: bool,
            residual: bool, pre_ln: bool) -> torch.Tensor:
    """The kernel sequence on checked operands, FC1 and FC2 on the forms
    `forms` gives them."""
    D, F = w1.shape
    M = x.numel() // D
    fc1, fc2 = forms
    out = torch.empty_like(x)
    xn = torch.empty((M, D), dtype=x.dtype, device=x.device) if pre_ln else None
    h = torch.empty((M, F), dtype=x.dtype, device=x.device)
    lib = _build.library("mlp_block")
    with torch.cuda.device(x.device):
        rc = lib.smelter_mlp_block(
            x.data_ptr(), ln_g.data_ptr(), ln_b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), None if xn is None else xn.data_ptr(), h.data_ptr(),
            out.data_ptr(), M, D, F, int(bool(pre_ln)), 2 if approximate else 1,
            int(bool(residual)), float(eps), _build.DTYPE_CODES[x.dtype],
            _build.DTYPE_CODES[b1.dtype], fc1.code, fc1.grid, fc2.code, fc2.grid,
            _build.stream_of(x))
    _build.check(lib, rc, "mlp_block")
    return out


def mlp_block(x, ln_g, ln_b, w1, b1, w2, b2, *, eps: float = 1e-5, approximate: bool = False,
              residual: bool = True, pre_ln: bool = True) -> torch.Tensor:
    """The MLP on x (..., D); returns x's shape and dtype."""
    global launches
    kw = dict(eps=eps, approximate=approximate, residual=residual, pre_ln=pre_ln)
    if x.device.type in ("cpu", "meta"):
        return mlp_block_plain(x, ln_g, ln_b, w1, b1, w2, b2, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_block: no kernel for device {x.device}")
    _check(x, (ln_g, ln_b, b1, b2), w1, w2, pre_ln)
    D, F = w1.shape
    forms = plans(x.numel() // D, D, F, x.dtype, sms=_build.sms(x.device))
    out = _launch(x, ln_g, ln_b, w1, b1, w2, b2, forms, **kw)
    launches += 1
    return out
