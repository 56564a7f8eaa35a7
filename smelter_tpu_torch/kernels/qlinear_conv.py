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
- What the design does about it: an implicit GEMM, M = N * H_o * W_o
  output pixels, N = C_out, K = kh * kw * C_in, both operands K-major as
  they lie (the channels-last input's windows; the OHWI weight's rows). The
  wgmma forms of `csrc/wgmma_qconv.cuh` (`wgmma_plan.qconv_plan`) bring
  both into shared memory by TMA, A through a 2-D map of the input ("gemm":
  1x1 stride 1) or an im2col map ("im2col": any kernel; the conv's stride
  is the map's traversal stride), and run wgmma.s32.s8.s8 over 128 x 128
  (or 128 x 64) tiles, persistent CTAs, a producer warpgroup and two
  consumers, the int8 tile staged in shared memory for 16-byte stores. An
  input of fewer than 16 channels (the RGB stem's 3) is read unfolded
  (`unfold_input`, the layout copy the wrapper makes anyway): pixel (i, j)
  of the copy holds the kw input pixels of output column j's window side by
  side, kw x C_in channels zero-padded to a multiple of 32 (the stem's 21
  to 32), so the conv is a kh x 1 conv with stride (sh, 1) over the copy
  by the weight laid out alike (`unfold_weight`, once at fold time: the
  `w_padded` argument); the zero products keep the int32 sums exact. Shapes
  and pointers the maps cannot take keep the mma.sync m16n8k32 kernel of
  `csrc/qlinear_conv.cu` (A gathered a 16-byte chunk at a time, 128 x 128
  tiles).
- `relu`: the walk folds an int8 Relu that is the conv's only reader into
  the epilogue (`runtime/chains.py`): clip to [0, 127], not [-128, 127],
  which is max(y, 0) of the clipped value.

Memory layout: the kernel reads x channels-last and writes channels-last,
so a chain of these convs passes NHWC memory along with no copy; the
wrapper copies an input that is not (the stem's, from the graph's NCHW
input) and counts it in `layout_copies`. `weights.params_from_numpy` stores
QLinearConv weights once over an OHWI buffer (an OIHW view of it), so no
weight is relaid per call.

A CPU or `meta` tensor takes the plain version (`qlinear_conv_plain`); a
CUDA tensor launches a kernel at any batch, size, stride and kernel size
with dilation 1 and groups 1, or raises. `launches` counts kernel launches
and nothing else; `forms` counts them by the plan's form.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build, wgmma_plan

launches = 0
layout_copies = 0  # inputs the wrapper copied to channels-last (or unfolded)
forms = {"mma": 0, "gemm": 0, "im2col": 0}  # launches by form


def pad_arg(pads) -> tuple[int, int, int, int]:
    """((top, bottom), (left, right)) -> F.pad's (left, right, top, bottom)."""
    (pt, pb), (pl, pr) = pads
    return int(pl), int(pr), int(pt), int(pb)


def qlinear_conv_plain(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor,
                       b: torch.Tensor | None = None, *, stride=(1, 1),
                       pads=((0, 0), (0, 0)), relu: bool = False) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch. The int8 products are
    summed in f64, where every sum is exact (|sum| < 2^53), so the sums are
    the kernel's int32 sums; f64 -> f32 of those integers rounds as
    __int2float_rn does. With a bias, the product and the sum are taken in
    f64 (the product of two f32 values is exact there) and rounded once to
    f32: the fused multiply-add. `relu` clips at 0."""
    acc = F.conv2d(F.pad(x.double(), pad_arg(pads)), w.double(),
                   stride=tuple(int(s) for s in stride)).float()
    shape = (1, -1, 1, 1)
    if b is None:
        y = acc * m.float().reshape(shape)
    else:
        y = (acc.double() * m.double().reshape(shape) + b.double().reshape(shape)).float()
    return torch.clamp(torch.round(y), 0 if relu else -128, 127).to(torch.int8)


def unfold_input(x: torch.Tensor, kw: int, sw: int, pads_w, c_unf: int) -> torch.Tensor:
    """x (N, C, H, W) -> (N, c_unf, H, Wo), channels-last: channel kx * C + c
    of pixel (i, j) is x[:, c, i, j * sw + kx - pl] (zero in the pad), and
    channels kw * C and on are zero."""
    n, c, h, w = x.shape
    pl, pr = pads_w
    wo = (w + pl + pr - kw) // sw + 1
    # NHWC with the side pads: a window's kw pixels are kw * C contiguous bytes
    xp = F.pad(x.permute(0, 2, 3, 1), (0, 0, pl, pr)).contiguous()
    windows = xp.as_strided((n, h, wo, kw * c), (xp.stride(0), xp.stride(1), sw * c, 1))
    out = x.new_zeros((n, h, wo, c_unf))
    out[..., :kw * c].copy_(windows)
    return out.permute(0, 3, 1, 2)


def unfold_weight(w: torch.Tensor, c_unf: int) -> torch.Tensor:
    """w (C_out, C, kh, kw) -> (C_out, c_unf, kh, 1), stored OHWI (an OIHW
    view, channels-last): channel kx * C + c of tap row ky is w[:, c, ky, kx],
    the rest zero; `unfold_input`'s weight."""
    cout, c, kh, kw = w.shape
    out = w.new_zeros((cout, kh, 1, c_unf))
    out[..., :kw * c] = w.permute(0, 2, 3, 1).reshape(cout, kh, 1, kw * c)
    return out.permute(0, 3, 1, 2)


def padded_weight(w: torch.Tensor) -> torch.Tensor | None:
    """The unfolded weight the wgmma forms read where they read the input
    unfolded (C_in < 16: an RGB stem), else None: what a caller folds once
    per weight and hands to `qlinear_conv` as `w_padded`."""
    cout, c, kh, kw = w.shape
    if c >= wgmma_plan.QC_PAD_BELOW:
        return None
    return unfold_weight(w, wgmma_plan.cdiv(kw * c, wgmma_plan.QC_PAD_TO) * wgmma_plan.QC_PAD_TO)


def qlinear_conv(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor,
                 b: torch.Tensor | None = None, *, stride=(1, 1),
                 pads=((0, 0), (0, 0)), relu: bool = False,
                 w_padded: torch.Tensor | None = None) -> torch.Tensor:
    """x (N, C_in, H, W) int8, any memory format; w (C_out, C_in, kh, kw)
    int8; m and b f32 (C_out,), b optional; stride (sh, sw); pads ((pt, pb),
    (pl, pr)); relu: clip at 0; w_padded: `padded_weight(w)`, made once by
    the caller where the plan unfolds the input (else the call unfolds w
    itself).
    Returns (N, C_out, H_o, W_o) int8; on the card in channels-last
    memory."""
    global launches, layout_copies
    if x.device.type in ("cpu", "meta"):
        return qlinear_conv_plain(x, w, m, b, stride=stride, pads=pads, relu=relu)
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
    channels_last = x.is_contiguous(memory_format=torch.channels_last)
    # a copy (of x not channels-last, of w not OHWI) starts aligned
    aligned = ((not channels_last or _build.aligned16(x))
               and (not w.permute(0, 2, 3, 1).is_contiguous() or _build.aligned16(w)))
    plan = wgmma_plan.qconv_plan(n, h, wd, cin, cout, kh, kw, sh, sw, ((pt, pb), (pl, pr)),
                                 aligned=aligned, sms=_build.sms(x.device))
    if plan.unfold:  # one layout copy: the unfolded input, a kh x 1 conv over it
        x = unfold_input(x, kw, sw, (pl, pr), plan.c_in)
        layout_copies += 1
        if w_padded is None:
            w_padded = unfold_weight(w, plan.c_in)
        if tuple(w_padded.shape) != (cout, plan.c_in, kh, 1) or w_padded.dtype != torch.int8:
            raise ValueError(f"qlinear_conv: w_padded {tuple(w_padded.shape)} is not w "
                             f"unfolded to {plan.c_in} channels")
        w, wd, kw, sw, pl = w_padded, wo, 1, 1, 0
        if x.numel() >= 2 ** 31:
            raise ValueError("qlinear_conv: the unfolded input has 2^31 elements or more")
    elif not channels_last:
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
            out.data_ptr(), n, h, wd, plan.c_in, ho, wo, cout, kh, kw, sh, sw, pt, pl,
            int(relu), plan.code, plan.bk, plan.bn, plan.grid, _build.stream_of(x))
    _build.check(lib, rc, "qlinear_conv")
    launches += 1
    forms[plan.form] += 1
    return out
