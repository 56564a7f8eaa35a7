"""Reduction op lowerings: ReduceMax (the decode path) and ReduceMean
(ConvNeXt's global pool, over axes (1, 2) after the layout pass).

Counterpart of `smelter_tpu/ops/reduce_ops.py`. ONNX moved the axes of a
reduction from an attribute to an input at opset 18; both forms are read.
"""

from __future__ import annotations

import torch

from ..ir.graph import Node
from .registry import Ctx, register


def _axes_for(ctx: Ctx, node: Node, ndim: int):
    axes = None
    if len(node.inputs) > 1 and node.inputs[1]:
        axes = tuple(int(a) for a in ctx.static(node.inputs[1]).reshape(-1))
    elif node.attr("axes") is not None:
        axes = tuple(node.attr("axes"))
    if axes is None:
        if node.attr("noop_with_empty_axes", 0):
            return ()
        return tuple(range(ndim))
    return tuple(a + ndim if a < 0 else a for a in axes)


def _reduce(op_type: str, fn):
    @register(op_type, static={1})
    def _lower(ctx: Ctx, node: Node, _fn=fn):
        x = ctx.get(node.inputs[0])
        axes = _axes_for(ctx, node, x.ndim)
        keep = bool(node.attr("keepdims", 1))
        if axes == ():
            ctx.set(node.outputs[0], x)
            return
        ctx.set(node.outputs[0], _fn(x, axes, keep))


def _mean(x, axes, keep):
    # jnp.mean of an integer tensor is the f32 mean (ONNX would keep T)
    if not x.is_floating_point():
        x = x.to(torch.float32)
    return torch.mean(x, dim=axes, keepdim=keep)


_reduce("ReduceMean", _mean)
_reduce("ReduceMax", lambda x, a, k: torch.amax(x, dim=a, keepdim=k))
