"""Quantization op lowerings: QuantizeLinear / DequantizeLinear.

Counterparts of `smelter_tpu/ops/quant_ops.py`. DequantizeLinear is how
int8 weight-only models express their weights (quant/weight_quant.py); it
computes in f32, and the consumer casts to its activation dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ir.graph import Node
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

    def host(p):
        return torch.as_tensor(np.asarray(p, np.float32), device=x.device)

    # A scale known before the run: multiply by its reciprocal (taken in
    # f64, then rounded to f32), as the JAX lowering folds it.
    s_c = ctx.static(node.inputs[1], required=False)
    if s_c is not None:
        inv = host(np.reciprocal(np.asarray(s_c, np.float64)))
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
                y = y + _shaped(host(zp_c), x, axis, block)
            out_dtype = torch.from_numpy(zp_c.reshape(-1)[:0]).dtype
        else:
            zp = ctx.get(node.inputs[2])
            y = y + _shaped(zp, x, axis, block).float()
            out_dtype = zp.dtype
    info = torch.iinfo(out_dtype)
    ctx.set(node.outputs[0], torch.clamp(y, info.min, info.max).to(out_dtype))
