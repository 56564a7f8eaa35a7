"""Fused dequant + KxK convolution: NHWC float activations, int8 HWIO
weights, a per-output-channel scale after the sum.

    out[n, i, j, co] = s[co] * sum over ky, kx, ci of
        w_q[ky, kx, ci, co] * x[n, i + ky - ph0, j + kx - pw0, ci]

with zeros outside the map, stride 1, dilation 1, groups 1. The weight is
cast to x's dtype (exact: int8 fits every float type), the products are
summed in f32, the sum times s in f32 is rounded once to x's dtype. This is
the Pallas kernel's arithmetic (`_kernel`: a dot per tap with f32
accumulation, then `acc * s`), not the JAX reference's, which rounds
`w * s` to x's dtype before an XLA conv; the port's `dequant_matmul` made
the same choice.

Replaces the Pallas kernel `smelter_tpu/kernels/dequant_conv.py::
_dequant_conv_impl` (its entry `dequant_conv`). The JAX entry falls back to
XLA's conv outside Mosaic's alignment rule (C_out % 128, (tile_h * W_out) %
8), a TPU tiling rule the port does not copy: the kernel takes every
stride-1 shape. The TPU tiling arguments (`tile_h`, `block_cout`) and
`interpret` have no counterpart. No path of the JAX package reaches this
kernel; nor does one of the port's. The Hopper kernel is
`csrc/dequant_conv.cu`:

- What bounds it on an H100: at ResNet-50's four stride-1 3x3 convs at
  batch 128 in bf16, each 3.0e10 operations (0.030 ms at 989 TFLOP/s), the
  bytes tie with the tensor cores at 56 x 56 x 64 (103 MB, 0.031 ms at
  3.35 TB/s) and the tensor cores bound the three smaller maps. f32 runs on
  CUDA cores (67 TFLOP/s), since TF32 would break the 1e-5 bound.
- What the design does about it: an implicit GEMM, M = N * H_o * W_o
  output pixels, N = C_out, K = kh * kw * C_in, with f32 accumulators, in
  the form `wgmma_plan.conv_plan` picks from the shape before the launch.
  "wgmma" (C_in % 64 == 0, C_out % 16 == 0, aligned bases: ResNet-50's
  convs) runs the wgmma/TMA core `csrc/wgmma_gemm.cuh`'s persistent
  `gemm_tma_ra`: the TMA unit gathers A through an im2col map of x (128
  pixels x 64 channels of one tap a box, the padding its zero fill), the
  int8 weight lands as it lies and is converted exactly into wgmma's
  register operand, and 64- or 128-channel tiles follow C_out. "mma"
  (every other shape: C_in 3, odd channel counts, unaligned bases) runs
  mma.sync m16n8k16 over 128 x 128 tiles, A gathered 16 bytes at a time
  from the NHWC input and the weight converted on its way to shared
  memory. f32 takes a register-tiled FMA kernel on the same loader.

A CPU or `meta` tensor takes the plain version (`dequant_conv_plain`); a
CUDA tensor launches the kernel or raises. `launches` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build, wgmma_plan
from .qlinear_conv import pad_arg

launches = 0

_X_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_FMA = wgmma_plan.ConvPlan("mma", 64, 64, 0, 1, 0, 0)  # f32 x: the FMA kernel, its own grid


def dequant_conv_plain(x: torch.Tensor, w_q: torch.Tensor, scales: torch.Tensor, *,
                       pads=((0, 0), (0, 0))) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: a conv of the NCHW view in
    f32 on the weight cast to x's dtype, times the f32 scales, one rounding
    to x's dtype."""
    xf = F.pad(x.permute(0, 3, 1, 2).float(), pad_arg(pads))
    wf = w_q.permute(3, 2, 0, 1).to(x.dtype).float()
    y = F.conv2d(xf, wf) * scales.float().reshape(1, -1, 1, 1)
    return y.to(x.dtype).permute(0, 2, 3, 1).contiguous()


def dequant_conv(x: torch.Tensor, w_q: torch.Tensor, scales: torch.Tensor, *,
                 pads=((0, 0), (0, 0))) -> torch.Tensor:
    """x (N, H, W, C_in) f32/bf16/f16; w_q (kh, kw, C_in, C_out) int8;
    scales (C_out,) f32; pads ((ph0, ph1), (pw0, pw1)). Returns (N, H_o,
    W_o, C_out) in x's dtype."""
    global launches
    if x.device.type in ("cpu", "meta"):
        return dequant_conv_plain(x, w_q, scales, pads=pads)
    if x.device.type != "cuda":
        raise ValueError(f"dequant_conv: no kernel for device {x.device}")
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"dequant_conv: x {x.dtype} not taken")
    if w_q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"dequant_conv: w_q {w_q.dtype} must be int8 and scales "
                        f"{scales.dtype} f32")
    if x.dim() != 4 or w_q.dim() != 4 or w_q.shape[2] != x.shape[3]:
        raise ValueError(f"dequant_conv: x {tuple(x.shape)} (N, H, W, C_in) and w_q "
                         f"{tuple(w_q.shape)} (kh, kw, C_in, C_out) do not fit")
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w_q.shape
    if scales.numel() != cout:
        raise ValueError(f"dequant_conv: scales must hold C_out = {cout} values")
    if w_q.device != x.device or scales.device != x.device:
        raise ValueError("dequant_conv: operands must lie on one device")
    pw0, pw1, ph0, ph1 = pad_arg(pads)
    ho, wo = h + ph0 + ph1 - kh + 1, wd + pw0 + pw1 - kw + 1
    if ho < 1 or wo < 1 or cin < 1 or cout < 1:
        raise ValueError(f"dequant_conv: empty output ({ho} x {wo}) or channels")
    if max(x.numel(), w_q.numel(), n * ho * wo * cout) >= 2 ** 31:
        raise ValueError("dequant_conv: tensors of 2^31 elements or more are not taken")
    x, w_q, scales = x.contiguous(), w_q.contiguous(), scales.contiguous()
    out = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    lib = _build.library("dequant_conv")
    p = (wgmma_plan.conv_plan(n, h, wd, cin, cout, kh, kw, ((ph0, ph1), (pw0, pw1)),
                              aligned=_build.aligned16(x, w_q), sms=_build.sms(x.device))
         if x.dtype != torch.float32 else _FMA)
    with torch.cuda.device(x.device):
        rc = lib.smelter_dequant_conv(
            x.data_ptr(), w_q.data_ptr(), scales.data_ptr(), out.data_ptr(),
            n, h, wd, cin, ho, wo, cout, kh, kw, ph0, pw0, _build.DTYPE_CODES[x.dtype],
            p.code, p.bn, p.grid, _build.stream_of(x))
    _build.check(lib, rc, "dequant_conv")
    launches += 1
    return out
