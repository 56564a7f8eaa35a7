"""Tensor-manipulation op lowerings of the ResNet path: Constant, Reshape,
Flatten, Transpose, DepthToSpace.

Counterparts of `smelter_tpu/ops/tensor_ops.py`. Constant publishes its
value into the static env, so a Reshape whose shape comes from it resolves
before the run.
"""

from __future__ import annotations

import numpy as np

from ..ir.errors import NotSupportedError
from ..ir.graph import Node
from .registry import Ctx, register


@register("Constant")
def constant(ctx: Ctx, node: Node):
    for key in ("value", "value_float", "value_int", "value_floats", "value_ints"):
        v = node.attr(key)
        if v is not None:
            arr = np.asarray(v)
            if key in ("value_int", "value_ints"):
                arr = arr.astype(np.int64)
            elif key in ("value_float", "value_floats"):
                arr = arr.astype(np.float32)
            ctx.set_static(node.outputs[0], arr)
            return
    raise NotSupportedError(f"Constant node {node.name!r} without value attr")


def _resolve_reshape(shape_spec: np.ndarray, in_shape: tuple[int, ...], allowzero: int) -> tuple[int, ...]:
    out = []
    for i, d in enumerate(int(x) for x in shape_spec.reshape(-1)):
        if d == 0 and not allowzero:
            out.append(in_shape[i])  # 0 = copy the input dim
        else:
            out.append(d)
    if out.count(-1) > 1:
        raise NotSupportedError(f"reshape spec {out} has multiple -1")
    if -1 in out:
        known = int(np.prod([d for d in out if d != -1]))
        total = int(np.prod(in_shape))
        out[out.index(-1)] = total // max(known, 1)
    return tuple(out)


@register("Reshape", static={1})
def reshape(ctx: Ctx, node: Node):
    x = ctx.get(node.inputs[0])
    if ctx.opset >= 5:
        spec = ctx.static(node.inputs[1])
    else:
        spec = np.asarray(node.attr("shape"), np.int64)
    allowzero = int(node.attr("allowzero", 0))
    new_shape = _resolve_reshape(spec, tuple(x.shape), allowzero)
    ctx.set(node.outputs[0], x.reshape(new_shape))
    st = ctx.static(node.inputs[0], required=False)
    if st is not None:
        ctx.set_static(node.outputs[0], st.reshape(new_shape))


@register("Flatten")
def flatten(ctx: Ctx, node: Node):
    x = ctx.get(node.inputs[0])
    axis = node.attr("axis", 1)
    if axis < 0:
        axis += x.ndim
    lead = int(np.prod(x.shape[:axis])) if axis else 1
    ctx.set(node.outputs[0], x.reshape(lead, -1))


@register("Transpose")
def transpose(ctx: Ctx, node: Node):
    x = ctx.get(node.inputs[0])
    perm = node.attr("perm")
    if perm is None:
        perm = tuple(reversed(range(x.ndim)))
    ctx.set(node.outputs[0], x.permute(*perm))


@register("DepthToSpace")
def depth_to_space(ctx: Ctx, node: Node):
    x = ctx.get(node.inputs[0])
    bs = int(node.attr("blocksize"))
    mode = node.attr("mode", "DCR")
    if isinstance(mode, bytes):
        mode = mode.decode()
    if node.attr("data_layout") == "NHWC":
        n, h, w, c = x.shape
        if mode == "DCR":
            y = x.reshape(n, h, w, bs, bs, c // (bs * bs)).permute(0, 1, 3, 2, 4, 5)
        else:  # CRD
            y = x.reshape(n, h, w, c // (bs * bs), bs, bs).permute(0, 1, 4, 2, 5, 3)
        ctx.set(node.outputs[0], y.reshape(n, h * bs, w * bs, c // (bs * bs)))
        return
    n, c, h, w = x.shape
    if mode == "DCR":
        y = x.reshape(n, bs, bs, c // (bs * bs), h, w).permute(0, 3, 4, 1, 5, 2)
    else:  # CRD
        y = x.reshape(n, c // (bs * bs), bs, bs, h, w).permute(0, 1, 4, 2, 5, 3)
    ctx.set(node.outputs[0], y.reshape(n, c // (bs * bs), h * bs, w * bs))
