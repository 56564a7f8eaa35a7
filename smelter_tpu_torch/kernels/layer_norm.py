"""LayerNorm over the last axis: `fused_layer_norm` and `residual_layer_norm`
(a skip add and the LayerNorm of the sum, returning both).

Statistics in f32: the mean, then the variance as the mean of (x - mean)^2,
then (x - mean) * rsqrt(var + eps) * gamma + beta, rounded once to x's
dtype. The residual form sums x + skip in f32, rounds the sum to x's dtype
and normalizes the rounded sum, so its carry equals the composite's
`x + skip` bit for bit.

Replaces the Pallas kernels `smelter_tpu/kernels/layer_norm.py::
_layer_norm_impl` and `::_residual_layer_norm_impl`. The Hopper kernels are
`csrc/layer_norm.cu` (one entry point for both forms) on the row kernel of
`csrc/layer_norm.cuh`:

- What bounds them on an H100: the bytes. At ViT-B/16's batch 128 (M
  25,216 rows of D 768, bf16) the plain form moves 77.5 MB (~23 us at 3.35
  TB/s), the residual form 154.9 MB (~46 us).
- What the simple design does about it: one warp a row, the row held in
  registers, so each element crosses device memory once each way in 8- or
  16-byte lane loads.

`fused_layer_norm` and `residual_layer_norm` take any rank. A CPU or `meta`
tensor takes the kernels' plain versions (`layer_norm_plain`,
`residual_layer_norm_plain`); a CUDA tensor launches the kernel at any row
count, or raises where the kernel takes no such row (D % 4 != 0, D > 4096).
The JAX entry points' shape rule (D % 128 == 0 and a row count that is a
multiple of 8) is a TPU tiling rule; outside it they take a composite whose
arithmetic is the plain version's. `fused_launches` and `residual_launches`
count the two kernels' launches and nothing else.
"""

from __future__ import annotations

import torch

from . import _build

fused_launches = 0
residual_launches = 0

_X_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_MAX_D = 4096  # rows held in registers (csrc/layer_norm.cuh)


def layer_norm_plain(x, gamma, beta=None, *, eps: float = 1e-5, dims=-1) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, over the last axis or over
    `dims`: the LayerNorm ops' composite too (beta may be None). The
    variance, the mean of (x - mean)^2, comes with the mean from one
    reduction (`torch.var_mean`); the kernel sums the squares after the
    mean: the same quantity summed in another order."""
    xf = x.float()
    var, mu = torch.var_mean(xf, dims, correction=0, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * gamma.float()
    return (y if beta is None else y + beta.float()).to(x.dtype)


def residual_layer_norm_plain(x, skip, gamma, beta, *, eps: float = 1e-5):
    """(sum, LN(sum)) with the sum taken in f32 and rounded to x's dtype."""
    s = (x.float() + skip.float()).to(x.dtype)
    return s, layer_norm_plain(s, gamma, beta, eps=eps)


def _launch(x, skip, gamma, beta, eps: float):
    """One launch of csrc/layer_norm.cu over (M, D) rows; returns (sum or
    None, out)."""
    global fused_launches, residual_launches
    M, D = x.shape
    if x.dtype not in _X_DTYPES or (skip is not None and skip.dtype != x.dtype):
        raise TypeError(f"layer_norm: x {x.dtype} (and skip) not taken")
    if D % 4 or D > _MAX_D:
        raise ValueError(f"layer_norm: rows of {D} not taken (D % 4 == 0, D <= {_MAX_D})")
    if gamma.dtype != beta.dtype or gamma.dtype not in (torch.float32, x.dtype) \
            or gamma.numel() != D or beta.numel() != D:
        raise TypeError("layer_norm: gamma and beta must be (D,) in f32 or x's dtype")
    ops = [x, gamma, beta] + ([] if skip is None else [skip])
    for t in ops:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("layer_norm: operands must be contiguous, on one device")
    if any(t.data_ptr() % (4 * x.element_size()) for t in ops[:1] + ops[3:]):
        raise ValueError("layer_norm: rows are read four elements at a time: x and skip "
                         "must be aligned to four elements")
    out = torch.empty_like(x)
    s = None if skip is None else torch.empty_like(x)
    lib = _build.library("layer_norm")
    with torch.cuda.device(x.device):
        rc = lib.smelter_layer_norm(
            x.data_ptr(), None if skip is None else skip.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), None if s is None else s.data_ptr(), out.data_ptr(), M, D,
            float(eps), _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[gamma.dtype],
            _build.stream_of(x))
    _build.check(lib, rc, "layer_norm")
    if skip is None:
        fused_launches += 1
    else:
        residual_launches += 1
    return s, out


def _device_ok(x) -> bool:
    """Whether x lies where the plain version runs (CPU, `meta`); raises for
    a device with no kernel."""
    if x.device.type in ("cpu", "meta"):
        return True
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: no kernel for device {x.device}")
    return False


def fused_layer_norm(x, gamma, beta, *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis of any-rank x; gamma, beta (D,)."""
    if _device_ok(x):
        return layer_norm_plain(x, gamma, beta, eps=eps)
    D = x.shape[-1]
    return _launch(x.reshape(-1, D).contiguous(), None, gamma.reshape(-1).contiguous(),
                   beta.reshape(-1).contiguous(), eps)[1].reshape(x.shape)


def residual_layer_norm(x, skip, gamma, beta, *, eps: float = 1e-5):
    """(x + skip, LayerNorm(x + skip)) over the last axis, the sum rounded
    to x's dtype; on the card skip has x's shape and dtype."""
    if _device_ok(x):
        return residual_layer_norm_plain(x, skip, gamma, beta, eps=eps)
    if x.shape != skip.shape:
        raise ValueError(f"residual_layer_norm: skip {tuple(skip.shape)} is not x's "
                         f"{tuple(x.shape)}")
    D = x.shape[-1]
    s, y = _launch(x.reshape(-1, D).contiguous(), skip.reshape(-1, D).contiguous(),
                   gamma.reshape(-1).contiguous(), beta.reshape(-1).contiguous(), eps)
    return s.reshape(x.shape), y.reshape(x.shape)
