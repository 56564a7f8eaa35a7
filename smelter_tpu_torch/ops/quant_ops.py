"""Quantization op lowerings: QuantizeLinear / DequantizeLinear, and the
static int8 ops QLinearConv / QLinearMatMul.

Counterparts of `smelter_tpu/ops/quant_ops.py`. DequantizeLinear is how
int8 weight-only models express their weights (quant/weight_quant.py); it
computes in f32, and the consumer casts to its activation dtype.

QLinearConv and QLinearMatMul take the form `quant/static_quant.py` emits:
int8 activations and weights, zero points 0, scales known before the run.
The requant epilogue folds to y = round(acc * m (+ b)) with m = x_s * w_s /
y_s combined in f64 and rounded to f32, as the JAX lowering folds it; the
constants are folded once per forward function (`Ctx.memo`), on the
device. QLinearConv runs on `kernels/qlinear_conv.py` (the Hopper int8
convolution on the card), QLinearMatMul's int32 product on
`kernels/int8_matmul.py::int32_matmul`. The forms the rewrite never emits
raise `NotSupportedError` on every device: nonzero or run-time zero points
(the ORT QOperator models), run-time scales, uint8 tensors, and for
QLinearConv groups > 1, dilation > 1 and other than 2 spatial dims.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ir.errors import NotSupportedError
from ..ir.graph import Node
from ..kernels import qlinear_conv as qc
from . import padding as P
from .registry import Ctx, register


def _scale_shape(scale, x_ndim: int, axis: int):
    if scale.ndim == 0 or scale.numel() == 1:
        return scale.reshape(())
    shape = [1] * x_ndim
    shape[axis] = scale.shape[0] if scale.ndim == 1 else -1
    return scale.reshape(shape)


def _blocked_param(p, x_shape, axis: int, block: int):
    """Opset-21 blocked quantization: the scale/zero-point tensor has x's
    rank with dim `axis` = ceil(x.shape[axis]/block); expand each block
    entry `block` times along `axis` and trim to x's length."""
    return torch.repeat_interleave(p, block, dim=axis).narrow(axis, 0, x_shape[axis])


def _shaped(p, x, axis: int, block: int):
    if block > 0:
        return _blocked_param(p, x.shape, axis, block)
    return _scale_shape(p, x.ndim, axis)


@register("DequantizeLinear", since=10)
def dequantize_linear(ctx: Ctx, node: Node):
    x = ctx.get(node.inputs[0])
    axis = node.attr("axis", 1)
    if axis < 0:
        axis += x.ndim
    block = int(node.attr("block_size", 0))
    s = _shaped(ctx.get(node.inputs[1]), x, axis, block).float()
    y = x.float() * s
    if len(node.inputs) > 2 and node.inputs[2]:
        zp_c = ctx.static(node.inputs[2], required=False)
        if zp_c is None or np.any(zp_c):  # y - 0 * s is y: a zero point of zeros adds nothing
            zp = _shaped(ctx.get(node.inputs[2]), x, axis, block)
            y = y - zp.float() * s
    ctx.set(node.outputs[0], y)


@register("QuantizeLinear", since=10, static={1, 2})
def quantize_linear(ctx: Ctx, node: Node):
    x = ctx.get(node.inputs[0])
    axis = node.attr("axis", 1)
    if axis < 0:
        axis += x.ndim
    block = int(node.attr("block_size", 0))

    def host(p, tag: str):
        """A static value on x's device, uploaded once per forward function."""
        return ctx.memo((id(node), x.device, tag),
                        lambda: torch.as_tensor(np.asarray(p, np.float32), device=x.device))

    # A scale known before the run: multiply by its reciprocal (taken in
    # f64, then rounded to f32), as the JAX lowering folds it.
    s_c = ctx.static(node.inputs[1], required=False)
    if s_c is not None:
        inv = host(np.reciprocal(np.asarray(s_c, np.float64)), "inv_scale")
        y = torch.round(x.float() * _shaped(inv, x, axis, block))
    else:
        s = _shaped(ctx.get(node.inputs[1]), x, axis, block)
        y = torch.round(x.float() / s.float())
    out_dtype = torch.int8
    if len(node.inputs) > 2 and node.inputs[2]:
        zp_c = ctx.static(node.inputs[2], required=False)
        if zp_c is not None:
            zp_c = np.asarray(zp_c)
            if np.any(zp_c):  # symmetric (zp=0) adds nothing
                y = y + _shaped(host(zp_c, "zero_point"), x, axis, block)
            out_dtype = torch.from_numpy(zp_c.reshape(-1)[:0]).dtype
        else:
            zp = ctx.get(node.inputs[2])
            y = y + _shaped(zp, x, axis, block).float()
            out_dtype = zp.dtype
    info = torch.iinfo(out_dtype)
    ctx.set(node.outputs[0], torch.clamp(y, info.min, info.max).to(out_dtype))


def _static_inputs(ctx: Ctx, node: Node, positions) -> list:
    """Host values of the given input positions (None for an absent input);
    raises for an input computed at run time."""
    out = []
    for i in positions:
        name = node.inputs[i] if i < len(node.inputs) else ""
        if not name:
            out.append(None)
            continue
        c = ctx.static(name, required=False)
        if c is None:
            raise NotSupportedError(
                f"{node.op_type} {node.name!r}: input {i} ({name!r}) is computed at run time; "
                f"the port takes scales and zero points known before the run")
        out.append(np.asarray(c))
    return out


def _symmetric_int8(node: Node, zero_points, *tensors) -> None:
    """Raise unless the zero points are all 0 and x, w and y are int8."""
    for zp in zero_points:
        if zp is None or np.any(zp):
            raise NotSupportedError(
                f"{node.op_type} {node.name!r}: nonzero or absent zero points (the asymmetric "
                f"form) are not in the port")
    dtypes = [t.dtype for t in tensors] + [zero_points[-1].dtype]
    if any(d not in (torch.int8, np.int8) for d in dtypes):
        raise NotSupportedError(f"{node.op_type} {node.name!r}: int8 tensors only, not {dtypes}")


def _fold(x_s, w_s, y_s, b, n: int, device) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The folded epilogue's constants for n output columns on `device`:
    m = x_s * w_s / y_s and b * (x_s * w_s / y_s), combined in f64 and
    rounded to f32, as the JAX lowering folds them. A single weight scale
    gives one m for every column."""
    x_s64 = np.asarray(x_s, np.float64).reshape(())
    w_s64 = np.asarray(w_s, np.float64).reshape(-1)
    y_s64 = np.asarray(y_s, np.float64).reshape(())
    m = np.broadcast_to((x_s64 * w_s64 / y_s64).astype(np.float32), (n,))
    bias = None
    if b is not None:
        bias = (np.asarray(b, np.float64) * (x_s64 * w_s64 / y_s64)).astype(np.float32)
    return (torch.tensor(m, device=device),
            None if bias is None else torch.as_tensor(bias.reshape(-1), device=device))


@register("QLinearMatMul", since=10, static={1, 2, 4, 5, 6, 7})
def qlinear_matmul(ctx: Ctx, node: Node):
    """The static quantizer's int8 matmul: acc = a @ b summed in int32 (a
    (..., K) int8, b (K, N) int8 with per-column or one scale), then
    round(acc * m) clipped to int8. The int32 product is `int32_matmul`'s
    (`torch._int_mm` on the card, which takes K and N multiples of 8)."""
    from ..kernels.int8_matmul import int32_matmul

    a = ctx.get(node.inputs[0])
    b = ctx.get(node.inputs[3])
    a_s, a_z, b_s, b_z, y_s, y_z = _static_inputs(ctx, node, (1, 2, 4, 5, 6, 7))
    _symmetric_int8(node, (a_z, b_z, y_z), a, b)
    if b.dim() != 2:
        raise NotSupportedError(f"QLinearMatMul {node.name!r}: a 2-D weight only")
    K, N = b.shape
    if a.device.type == "cuda" and (K % 8 or N % 8):
        raise NotSupportedError(
            f"QLinearMatMul {node.name!r}: K {K} and N {N} must be multiples of 8 on the card")

    m, _ = ctx.memo((id(node), a.device), lambda: _fold(a_s, b_s, y_s, None, N, a.device))
    acc = int32_matmul(a.reshape(-1, K).contiguous(), b).reshape(tuple(a.shape[:-1]) + (N,))
    y = torch.round(acc.float() * m)
    ctx.set(node.outputs[0], torch.clamp(y, -128, 127).to(torch.int8))


@register("QLinearConv", since=10, static={1, 2, 4, 5, 6, 7, 8})
def qlinear_conv(ctx: Ctx, node: Node):
    """The static quantizer's int8 conv on `kernels/qlinear_conv.py`: the
    int32 sum, then round(f32(acc) * m + b) as one fused multiply-add, as
    the JAX package's compiled epilogue computes it. Either layout: NCHW
    with an OIHW weight (what the rewrite emits), or data_layout=NHWC with
    an HWIO weight."""
    ctx.set(node.outputs[0], qlinear_conv_out(ctx, node))


def _qconv_spec(ctx: Ctx, node: Node, x, w) -> tuple:
    """What QLinearConv's lowering works out from the node, its static
    inputs and the operands' types and shapes: the layout, strides, pads and
    folded constants; raises for the forms the port does not take."""
    from .nn import _conv_attrs, _layout

    x_s, x_z, w_s, w_z, y_s, y_z, b_q = _static_inputs(ctx, node, (1, 2, 4, 5, 6, 7, 8))
    _symmetric_int8(node, (x_z, w_z, y_z), x, w)
    rank = x.ndim - 2
    if rank != 2:
        raise NotSupportedError(f"QLinearConv {node.name!r}: {rank} spatial dims (2 taken)")
    strides, dilations, group = _conv_attrs(node, rank)
    if group != 1 or any(d != 1 for d in dilations):
        raise NotSupportedError(
            f"QLinearConv {node.name!r}: group {group} and dilations {dilations} (1 taken)")
    nhwc = _layout(node) == "NHWC"
    if nhwc:
        x = x.permute(0, 3, 1, 2)  # (N, C, H, W) view, channels-last
        w = w.permute(3, 2, 0, 1)  # HWIO -> OIHW view
    pads = P.resolve_pads(node, tuple(x.shape[2:]), tuple(w.shape[2:]), strides, dilations)
    m, b = ctx.memo((id(node), x.device),
                    lambda: _fold(x_s, w_s, y_s, b_q, w.shape[0], x.device))
    return nhwc, strides, pads, m, b


def qlinear_conv_out(ctx: Ctx, node: Node, relu: bool = False):
    """QLinearConv's int8 output; `relu` folds an int8 Relu of it into the
    epilogue (the walk's plan, `runtime/chains.py`). The node's static work
    (checks, pads, folded constants) is done once per forward function and
    input type and shape, the unfolded weight where the kernel reads one (an
    RGB stem's) once per weight tensor: the walk's host time is the step's
    on the card."""
    x = ctx.get(node.inputs[0])
    w = w_param = ctx.get(node.inputs[3])
    nhwc, strides, pads, m, b = ctx.memo(
        (id(node), x.device, x.dtype, tuple(x.shape), w.dtype, tuple(w.shape)),
        lambda: _qconv_spec(ctx, node, x, w))
    if nhwc:
        x = x.permute(0, 3, 1, 2)  # (N, C, H, W) view, channels-last
        w = w.permute(3, 2, 0, 1)  # HWIO -> OIHW view
    w_padded = None
    if x.device.type == "cuda":  # the memo holds the param, so its id names it
        w_padded = ctx.memo((id(node), id(w_param)),
                            lambda: (w_param, qc.padded_weight(w)))[1]
    y = qc.qlinear_conv(x, w, m, b, stride=strides, pads=pads, relu=relu, w_padded=w_padded)
    return y.permute(0, 2, 3, 1) if nhwc else y
