"""Elementwise op lowerings: Relu, Identity, Add (the ResNet path), Sigmoid,
Abs, Round, Clip, Mul, Div, Max (the decode path), LessOrEqual and Where
(the static-cache step's dense attention mask), Gelu (the ViT MLP) and
LeakyRelu (ESRGAN).

Counterparts of `smelter_tpu/ops/math_ops.py`; a binary op casts its second
operand to the first one's dtype, as there, and a comparison compares the
two as they are. Round is half to even, as `jnp.round`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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
_unary("Sigmoid", torch.sigmoid)
_unary("Abs", torch.abs)
_unary("Round", torch.round)
_binary("Add", torch.add)
_binary("Mul", torch.mul)
_binary("Div", torch.div)


def _compare(op_type: str, fn, since: int = 1):
    @register(op_type, since=since)
    def _lower(ctx: Ctx, node: Node, _fn=fn):
        ctx.set(node.outputs[0], _fn(ctx.get(node.inputs[0]), ctx.get(node.inputs[1])))


_compare("LessOrEqual", torch.le, since=12)


@register("LeakyRelu")
def leaky_relu(ctx: Ctx, node: Node):
    """x where x >= 0, else x times alpha in x's dtype, as the JAX lowering."""
    x = ctx.get(node.inputs[0])
    alpha = torch.as_tensor(node.attr("alpha", 0.01), dtype=x.dtype, device=x.device)
    ctx.set(node.outputs[0], torch.where(x >= 0, x, x * alpha))


@register("Where", since=9)
def where(ctx: Ctx, node: Node):
    cond = ctx.get(node.inputs[0])
    a = ctx.get(node.inputs[1])
    b = ctx.get(node.inputs[2])
    ctx.set(node.outputs[0], torch.where(cond, a, b.to(a.dtype)))


@register("Clip")
def clip(ctx: Ctx, node: Node):
    x = ctx.get(node.inputs[0])
    if ctx.opset >= 11:
        lo = ctx.get(node.inputs[1]) if len(node.inputs) > 1 and node.inputs[1] else None
        hi = ctx.get(node.inputs[2]) if len(node.inputs) > 2 and node.inputs[2] else None
    else:
        lo = node.attr("min")
        hi = node.attr("max")
    y = x
    if lo is not None:
        y = torch.maximum(y, torch.as_tensor(lo, device=x.device).to(x.dtype))
    if hi is not None:
        y = torch.minimum(y, torch.as_tensor(hi, device=x.device).to(x.dtype))
    ctx.set(node.outputs[0], y)


@register("Max")
def max_n(ctx: Ctx, node: Node):
    vals = [ctx.get(n) for n in node.inputs]
    out = vals[0]
    for v in vals[1:]:
        out = torch.maximum(out, v.to(out.dtype))
    ctx.set(node.outputs[0], out)


# Official since opset 20, accepted at any opset, as the JAX package does.
@register("Gelu")
def gelu(ctx: Ctx, node: Node):
    """Gelu, exact or tanh. `Config.gelu="auto"` takes the tanh form under a
    reduced compute dtype (its error is below bf16 resolution), as the JAX
    lowering does; "exact"/"tanh" force a form."""
    x = ctx.get(node.inputs[0])
    approx = node.attr("approximate", "none")
    if isinstance(approx, bytes):
        approx = approx.decode()
    use_tanh = approx == "tanh"
    mode = getattr(ctx.config, "gelu", "auto") if ctx.config else "auto"
    if mode == "tanh":
        use_tanh = True
    elif mode == "auto" and not use_tanh:
        cd = getattr(ctx.config, "compute_dtype", "float32") if ctx.config else "float32"
        if cd != "float32" and x.dtype != torch.float32:
            use_tanh = True
    ctx.set(node.outputs[0], F.gelu(x, approximate="tanh" if use_tanh else "none"))
