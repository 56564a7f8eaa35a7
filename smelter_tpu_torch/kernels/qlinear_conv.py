"""int8 x int8 -> int32 convolution with the folded requant epilogue: the
symmetric, static form of QLinearConv.

    acc[n, co, i, j] = sum over ky, kx, ci of
        w[co, ci, ky, kx] * x[n, ci, i * sh + ky - pt, j * sw + kx - pl]
    y = clip(round(f32(acc) * m[co] + b[co]), -128, 127) as int8

with zeros outside the map, m = x_s * w_s / y_s and b = b_q * x_s * w_s / y_s
folded once per node (`ops/quant_ops.py`). `f32(acc)` rounds the int32 sum
to f32, `acc * m + b` is one fused multiply-add (a single rounding), and
the round is half to even. Without a bias, y = round(f32(acc) * m).

The JAX package computes this with XLA's int8 convolution and an int32
accumulator (`smelter_tpu/ops/quant_ops.py::qlinear_conv`,
`lax.conv_general_dilated(..., preferred_element_type=jnp.int32)`), which is
not a Pallas kernel; PyTorch has no int8 convolution with an int32
accumulator. Its compiled epilogue contracts `acc * m + b` into one fused
multiply-add (XLA on the CPU: `tests/test_torch_static_quant.py` holds a
crafted case where the two forms round apart), so the kernel writes
`__fmaf_rn` and the plain version takes the product and the sum in f64 and
rounds once to f32. The Hopper kernel is `csrc/qlinear_conv.cu` on the
implicit-GEMM tile loader of `csrc/implicit_conv.cuh`:

- What bounds it on an H100: the int8 tensor cores at most of ResNet-50's
  convs at batch 128 (a forward's 53 convs are about 1.05e12 int8
  operations, 0.53 ms at 1,979 TOP/s), the bytes at the small-K 1x1 convs
  and the stem.
- What the simple design does about it: an implicit GEMM, M = N * H_o * W_o
  output pixels, N = C_out, K = kh * kw * C_in, on mma.sync m16n8k32 (s8 x
  s8 -> s32) over 128 x 128 tiles with the int32 sum in registers. A's rows
  are gathered a 16-byte chunk at a time from the channels-last input, with
  zeros where the padding lies; the OHWI weight is already [n][k]. The next
  K step loads into registers while the tensor cores work. A C_in that is
  not a multiple of 16 (the stem's 3) is gathered a byte at a time over the
  flattened K, its last chunk zero-filled. No cp.async, TMA or wgmma yet.

Memory layout: the kernel reads x channels-last and writes channels-last,
so a chain of these convs passes NHWC memory along with no copy; the
wrapper copies an input that is not (the stem's, from the graph's NCHW
input) and counts it in `layout_copies`. `weights.params_from_numpy` stores
QLinearConv weights once over an OHWI buffer (an OIHW view of it), so no
weight is relaid per call.

A CPU or `meta` tensor takes the plain version (`qlinear_conv_plain`); a
CUDA tensor launches the kernel at any batch, size, stride and kernel size
with dilation 1 and groups 1, or raises. `launches` counts kernel launches
and nothing else.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

launches = 0
layout_copies = 0  # inputs the wrapper copied to channels-last


def pad_arg(pads) -> tuple[int, int, int, int]:
    """((top, bottom), (left, right)) -> F.pad's (left, right, top, bottom)."""
    (pt, pb), (pl, pr) = pads
    return int(pl), int(pr), int(pt), int(pb)


def qlinear_conv_plain(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor,
                       b: torch.Tensor | None = None, *, stride=(1, 1),
                       pads=((0, 0), (0, 0))) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch. The int8 products are
    summed in f64, where every sum is exact (|sum| < 2^53), so the sums are
    the kernel's int32 sums; f64 -> f32 of those integers rounds as
    __int2float_rn does. With a bias, the product and the sum are taken in
    f64 (the product of two f32 values is exact there) and rounded once to
    f32: the fused multiply-add."""
    acc = F.conv2d(F.pad(x.double(), pad_arg(pads)), w.double(),
                   stride=tuple(int(s) for s in stride)).float()
    shape = (1, -1, 1, 1)
    if b is None:
        y = acc * m.float().reshape(shape)
    else:
        y = (acc.double() * m.double().reshape(shape) + b.double().reshape(shape)).float()
    return torch.clamp(torch.round(y), -128, 127).to(torch.int8)


def qlinear_conv(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor,
                 b: torch.Tensor | None = None, *, stride=(1, 1),
                 pads=((0, 0), (0, 0))) -> torch.Tensor:
    """x (N, C_in, H, W) int8, any memory format; w (C_out, C_in, kh, kw)
    int8; m and b f32 (C_out,), b optional; stride (sh, sw); pads ((pt, pb),
    (pl, pr)). Returns (N, C_out, H_o, W_o) int8; on the card in
    channels-last memory."""
    global launches, layout_copies
    if x.device.type in ("cpu", "meta"):
        return qlinear_conv_plain(x, w, m, b, stride=stride, pads=pads)
    if x.device.type != "cuda":
        raise ValueError(f"qlinear_conv: no kernel for device {x.device}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"qlinear_conv: x {x.dtype} and w {w.dtype} must be int8")
    if x.dim() != 4 or w.dim() != 4 or w.shape[1] != x.shape[1]:
        raise ValueError(f"qlinear_conv: x {tuple(x.shape)} (N, C_in, H, W) and w "
                         f"{tuple(w.shape)} (C_out, C_in, kh, kw) do not fit")
    n, cin, h, wd = x.shape
    cout, _, kh, kw = w.shape
    vecs = (m,) if b is None else (m, b)
    if any(v.dtype != torch.float32 or v.numel() != cout for v in vecs):
        raise TypeError(f"qlinear_conv: m and b must be f32 with C_out = {cout} values")
    if any(t.device != x.device for t in (w,) + vecs):
        raise ValueError("qlinear_conv: operands must lie on one device")
    sh, sw = (int(s) for s in stride)
    pl, pr, pt, pb = pad_arg(pads)
    if sh < 1 or sw < 1:
        raise ValueError(f"qlinear_conv: strides {stride} must be positive")
    ho, wo = (h + pt + pb - kh) // sh + 1, (wd + pl + pr - kw) // sw + 1
    if ho < 1 or wo < 1 or cin < 1 or kh < 1 or kw < 1:
        raise ValueError(f"qlinear_conv: empty output or kernel ({ho} x {wo}, {kh} x {kw})")
    if max(x.numel(), w.numel(), n * ho * wo * cout) >= 2 ** 31:
        raise ValueError("qlinear_conv: tensors of 2^31 elements or more are not taken")
    if not x.is_contiguous(memory_format=torch.channels_last):
        x = x.contiguous(memory_format=torch.channels_last)
        layout_copies += 1
    wp = w.permute(0, 2, 3, 1)  # OHWI, K contiguous
    if not wp.is_contiguous():
        wp = wp.contiguous()
    m = m.contiguous()
    b = None if b is None else b.contiguous()
    out = torch.empty((n, cout, ho, wo), dtype=torch.int8, device=x.device,
                      memory_format=torch.channels_last)
    if n == 0:
        return out
    lib = _build.library("qlinear_conv")
    with torch.cuda.device(x.device):
        rc = lib.smelter_qlinear_conv(
            x.data_ptr(), wp.data_ptr(), m.data_ptr(), None if b is None else b.data_ptr(),
            out.data_ptr(), n, h, wd, cin, ho, wo, cout, kh, kw, sh, sw, pt, pl,
            _build.stream_of(x))
    _build.check(lib, rc, "qlinear_conv")
    launches += 1
    return out
