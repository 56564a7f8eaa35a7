"""int8 x int8 -> int32 matmul with a scaled epilogue.

`out = float(x_q @ w_q) * s_row[m] * s_col[n]`, with x_q (M, K) int8,
w_q (K, N) int8, s_row (M, 1) f32 and s_col (N,) f32. `dequant_matmul_int8`
puts float activations in front of it: `quantize_rows` (plain PyTorch, as it
was plain XLA) quantizes each row to int8 with its own scale.

Replaces the Pallas kernel `smelter_tpu/kernels/int8_matmul.py::
_int8_matmul_impl`. The Hopper kernel is `csrc/int8_matmul.cu`:

- What bounds it on an H100: HBM at the ResNet-50 head (M 128, K 2048,
  N 1000: ~2.6 MB moved, ~0.77 us), the int8 tensor cores at the serving
  GEMM (M 8192, K 4096, N 4096: ~275 GOP, ~139 us).
- What the simple design does about it: mma.sync.m16n8k32 on 128x128 tiles
  with the int32 sum in registers, so the K loop does no float work; the
  (K, N) row-major weight tile is transposed into the B fragment's [n][k]
  layout in shared memory, per tile, so weights need no second copy. The
  next K step loads into registers during the current one. At the head the
  8 output tiles leave most SMs idle; one launch is one kernel, with no
  split-K or workspace.

`int8_matmul` takes the plain PyTorch version for a tensor on the CPU or the
`meta` device, and launches the kernel for a CUDA tensor or raises.
`launches` counts kernel launches and nothing else.
"""

from __future__ import annotations

import torch

from . import _build

launches = 0

_OUT_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int32)


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization: (x_q int8, s_row f32 (M, 1)).
    s = max(absmax, 1e-30) / 127 and q = clip(round(x / s), -127, 127),
    rounding half to even; the division is kept, not a reciprocal."""
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-30) / 127.0
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def int8_matmul_plain(x_q: torch.Tensor, w_q: torch.Tensor,
                      row_scales: torch.Tensor, col_scales: torch.Tensor,
                      *, out_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch. The int32 sum is taken in
    float64, which is exact here (|sum| <= 127 * 127 * K < 2**53) and runs
    on every device; out_dtype=int32 returns it as it is."""
    acc = torch.matmul(x_q.double(), w_q.double()).to(torch.int32)
    if out_dtype == torch.int32:
        return acc
    return (acc.float() * row_scales.float()
            * col_scales.float()[None, :]).to(out_dtype)


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, row_scales: torch.Tensor,
                col_scales: torch.Tensor, *, out_dtype=torch.bfloat16) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> int32 sum -> * s_row * s_col -> out_dtype
    (int32: the raw sum)."""
    global launches
    if x_q.device.type in ("cpu", "meta"):
        return int8_matmul_plain(x_q, w_q, row_scales, col_scales,
                                 out_dtype=out_dtype)
    if x_q.device.type != "cuda":
        raise ValueError(f"int8_matmul: no kernel for device {x_q.device}")
    M, K = x_q.shape
    if w_q.dim() != 2 or w_q.shape[0] != K:
        raise ValueError(f"int8_matmul: x_q {tuple(x_q.shape)} and w_q "
                         f"{tuple(w_q.shape)} do not chain")
    N = w_q.shape[1]
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError("int8_matmul: x_q and w_q must be int8")
    if row_scales.dtype != torch.float32 or row_scales.numel() != M \
            or col_scales.dtype != torch.float32 or col_scales.numel() != N:
        raise TypeError("int8_matmul: scales must be f32 (M, 1) and (N,)")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"int8_matmul: out_dtype {out_dtype} not taken")
    ops = (x_q, w_q, row_scales, col_scales)
    if any(t.device != x_q.device for t in ops):
        raise ValueError("int8_matmul: operands on different devices")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("int8_matmul: operands must be contiguous")
    out = torch.empty((M, N), dtype=out_dtype, device=x_q.device)
    if M == 0 or N == 0:
        return out
    lib = _build.library("int8_matmul")
    with torch.cuda.device(x_q.device):
        rc = lib.smelter_int8_matmul(
            x_q.data_ptr(), w_q.data_ptr(), row_scales.data_ptr(),
            col_scales.data_ptr(), out.data_ptr(), M, N, K,
            _build.DTYPE_CODES[out_dtype], _build.stream_of(x_q))
    _build.check(lib, rc, "int8_matmul")
    launches += 1
    return out


def dequant_matmul_int8(x: torch.Tensor, w_q: torch.Tensor,
                        scales: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """Float activations, int8 weights with per-N scales: quantize the rows,
    then the int8 kernel."""
    x_q, s_row = quantize_rows(x)
    return int8_matmul(x_q, w_q, s_row, scales, out_dtype=out_dtype or x.dtype)
