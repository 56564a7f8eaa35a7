"""Elementwise op lowerings of the ResNet path: Relu, Identity, Add.

Counterparts of `smelter_tpu/ops/math_ops.py`; a binary op casts its second
operand to the first one's dtype, as there.
"""

from __future__ import annotations

import torch

from ..ir.graph import Node
from .registry import Ctx, register


def _unary(op_type: str, fn, since: int = 1):
    @register(op_type, since=since)
    def _lower(ctx: Ctx, node: Node, _fn=fn):
        ctx.set(node.outputs[0], _fn(ctx.get(node.inputs[0])))


def _binary(op_type: str, fn, since: int = 1):
    @register(op_type, since=since)
    def _lower(ctx: Ctx, node: Node, _fn=fn):
        a = ctx.get(node.inputs[0])
        b = ctx.get(node.inputs[1])
        if a.dtype != b.dtype:
            b = b.to(a.dtype)
        ctx.set(node.outputs[0], _fn(a, b))


_unary("Relu", torch.relu)
_unary("Identity", lambda x: x)
_binary("Add", torch.add)
