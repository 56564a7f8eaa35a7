"""Fused dequant + matmul (int8 weights, per-channel scales).

`out = (x @ float(w_q)) * scales[n]`, with x (M, K) in bf16, f16 or f32,
w_q (K, N) int8 and scales (N,) f32; the sum runs in f32 and the scale is
applied once after it, as the per-N scale commutes with the K sum.

Replaces the Pallas kernel `smelter_tpu/kernels/dequant_matmul.py::
_dequant_matmul_impl`. The Hopper kernel is `csrc/dequant_matmul.cu` on the
wgmma/TMA core `csrc/wgmma_gemm.cuh`:

- What bounds it on an H100: HBM at the ResNet-50 head (M 128, K 2048,
  N 1000: ~2.8 MB moved, ~0.85 us), the bf16 tensor cores at the serving
  GEMM (M 8192, K 4096, N 4096: ~275 GFLOP, ~278 us).
- What the design does about it: W crosses HBM as int8 only and is
  converted exactly to the activation type on the chip. `wgmma_plan.plan`
  picks the form from the shape: the persistent TMA kernel where there are
  tiles enough to fill the card (the serving GEMM; W^T is wgmma's A operand,
  converted in registers), else a K split over a cluster of up to 8 CTAs
  summed in a fixed order through distributed shared memory (the head: 128
  CTAs, not 8; W converted on its way into shared memory). f32 activations
  take a full-f32 FMA kernel.

`dequant_matmul` takes the plain PyTorch version for a tensor on the CPU or
the `meta` device, and launches the kernel for a CUDA tensor or raises.
`launches` counts kernel launches and nothing else.
"""

from __future__ import annotations

import torch

from . import _build, wgmma_plan

launches = 0

_X_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def dequant_matmul_plain(x: torch.Tensor, w_q: torch.Tensor,
                         scales: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: f32 sum, scale, cast. bf16
    and f16 activations and int8 weights are exact in f32, so an f32 matmul
    is the kernel's f32 accumulation."""
    out_dtype = out_dtype or x.dtype
    acc = torch.matmul(x.float(), w_q.float())
    return (acc * scales.float()).to(out_dtype)


def dequant_matmul_reference(x: torch.Tensor, w_q: torch.Tensor,
                             scales: torch.Tensor) -> torch.Tensor:
    """The composite FusedDequantMatMul takes without `Config.use_pallas`, as
    the JAX package's `dequant_matmul_reference`: W * s in f32, rounded to
    x's dtype, then x @ W summed in f32 and rounded to x's dtype. On the
    card the product is one `torch.matmul` (f32 accumulation in cuBLAS)."""
    w = (w_q.float() * scales.float().reshape(1, -1)).to(x.dtype)
    if x.device.type == "cuda":
        return torch.matmul(x, w)
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def dequant_matmul(x: torch.Tensor, w_q: torch.Tensor, scales: torch.Tensor,
                   *, out_dtype=None) -> torch.Tensor:
    """(M, K) float @ (K, N) int8 with per-N scales -> (M, N) out_dtype
    (default x.dtype)."""
    global launches
    out_dtype = out_dtype or x.dtype
    if x.device.type in ("cpu", "meta"):
        return dequant_matmul_plain(x, w_q, scales, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"dequant_matmul: no kernel for device {x.device}")
    M, K = x.shape
    if w_q.dim() != 2 or w_q.shape[0] != K:
        raise ValueError(f"dequant_matmul: x {tuple(x.shape)} and w_q "
                         f"{tuple(w_q.shape)} do not chain")
    N = w_q.shape[1]
    if x.dtype not in _X_DTYPES or out_dtype not in _X_DTYPES:
        raise TypeError(f"dequant_matmul: x {x.dtype} -> {out_dtype} not taken")
    if w_q.dtype != torch.int8 or scales.dtype != torch.float32 \
            or scales.numel() != N:
        raise TypeError("dequant_matmul: w_q must be int8 and scales (N,) f32")
    for t in (w_q, scales):
        if t.device != x.device:
            raise ValueError("dequant_matmul: operands on different devices")
    if not (x.is_contiguous() and w_q.is_contiguous() and scales.is_contiguous()):
        raise ValueError("dequant_matmul: operands must be contiguous")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    p = wgmma_plan.plan(M, N, K, int8_b=True, aligned=_build.aligned16(x, w_q),
                        sms=_build.sms(x.device))
    lib = _build.library("dequant_matmul")
    with torch.cuda.device(x.device):
        rc = lib.smelter_dequant_matmul(
            x.data_ptr(), w_q.data_ptr(), scales.data_ptr(), out.data_ptr(), M, N, K,
            _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[out_dtype],
            p.code, p.bn, p.split, p.k_chunk, p.grid, _build.stream_of(x))
    _build.check(lib, rc, "dequant_matmul")
    launches += 1
    return out
