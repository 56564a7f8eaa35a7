"""Tensor-manipulation op lowerings: Constant, Reshape, Flatten, Transpose,
DepthToSpace (the ResNet path), Gather, Cast, CastLike (the decode path),
ScatterND (the static-cache step's cache writes), Pad (the prefill
graph's padded caches), and Squeeze, Unsqueeze, Concat, Slice and Expand
(the ViT graph: its class token, head split and class-token read-out), and
Split (SD-UNet's GEGLU halves).

Counterparts of `smelter_tpu/ops/tensor_ops.py`. Constant publishes its
value into the static env, so a Reshape whose shape comes from it resolves
before the run.

ScatterND writes in place when its data input is a graph input the caller
donated (`Executor.build_fn(donate=...)`, the port's counterpart of JAX's
buffer donation): a decode step then updates its KV caches where they lie,
instead of copying every cache every step. Otherwise it returns a new
tensor, as the JAX lowering does.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ir.errors import NotSupportedError
from ..ir.graph import Node
from ..utils import dtypes as dt
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


@register("Squeeze", static={1})
def squeeze(ctx: Ctx, node: Node):
    x = ctx.get(node.inputs[0])
    if ctx.opset >= 13:
        axes = ctx.static(node.inputs[1] if len(node.inputs) > 1 else "", required=False)
        axes = None if axes is None else tuple(int(a) for a in axes.reshape(-1))
    else:
        a = node.attr("axes")
        axes = tuple(a) if a else None
    if axes is None:
        axes = tuple(i for i, d in enumerate(x.shape) if d == 1)
    axes = tuple(a + x.ndim if a < 0 else a for a in axes)
    y = x.reshape(tuple(d for i, d in enumerate(x.shape) if i not in axes))
    ctx.set(node.outputs[0], y)
    st = ctx.static(node.inputs[0], required=False)
    if st is not None:
        ctx.set_static(node.outputs[0], st.reshape(tuple(y.shape)))


@register("Unsqueeze", static={1})
def unsqueeze(ctx: Ctx, node: Node):
    x = ctx.get(node.inputs[0])
    if ctx.opset >= 13:
        axes = tuple(int(a) for a in ctx.static(node.inputs[1]).reshape(-1))
    else:
        axes = tuple(node.attr("axes"))
    out_rank = x.ndim + len(axes)
    axes = tuple(a + out_rank if a < 0 else a for a in axes)
    shape = []
    it = iter(x.shape)
    for i in range(out_rank):
        shape.append(1 if i in axes else next(it))
    y = x.reshape(tuple(shape))
    ctx.set(node.outputs[0], y)
    st = ctx.static(node.inputs[0], required=False)
    if st is not None:
        ctx.set_static(node.outputs[0], st.reshape(tuple(y.shape)))


@register("Concat")
def concat(ctx: Ctx, node: Node):
    """N-input concat; the inputs take the first one's dtype."""
    vals = [ctx.get(n) for n in node.inputs]
    axis = node.attr("axis", 1)
    ctx.set(node.outputs[0], torch.cat([v.to(vals[0].dtype) for v in vals], dim=axis))
    statics = [ctx.static(n, required=False) for n in node.inputs]
    if all(s is not None for s in statics):
        ctx.set_static(node.outputs[0], np.concatenate(statics, axis=axis))


def _take(x, idx):
    """x[idx] for a tuple of slices, any step: a negative step (which torch
    slicing does not take) gathers the indices Python's slice gives."""
    if all(s.step is None or s.step > 0 for s in idx):
        return x[idx]
    for ax, s in enumerate(idx):
        if s.step is not None and s.step < 0:
            rows = torch.arange(*s.indices(x.shape[ax]), device=x.device)
            x = x.index_select(ax, rows)
        elif s != slice(None):
            x = x[(slice(None),) * ax + (s,)]
    return x


@register("Slice", static={1, 2, 3, 4})
def slice_op(ctx: Ctx, node: Node):
    """Static starts, ends, axes and steps, with Python's slice semantics
    (as the JAX lowering indexes); an end at or past int32's max is open."""
    x = ctx.get(node.inputs[0])
    if ctx.opset >= 10:
        starts = ctx.static(node.inputs[1]).reshape(-1)
        ends = ctx.static(node.inputs[2]).reshape(-1)
        axes = ctx.static(node.inputs[3] if len(node.inputs) > 3 else "", required=False)
        steps = ctx.static(node.inputs[4] if len(node.inputs) > 4 else "", required=False)
        axes = axes.reshape(-1) if axes is not None else np.arange(len(starts))
        steps = steps.reshape(-1) if steps is not None else np.ones(len(starts), np.int64)
    else:
        starts = np.asarray(node.attr("starts"))
        ends = np.asarray(node.attr("ends"))
        a = node.attr("axes")
        axes = np.asarray(a) if a else np.arange(len(starts))
        steps = np.ones(len(starts), np.int64)
    idx = [slice(None)] * x.ndim
    for s, e, ax, st in zip(starts, ends, axes, steps):
        ax = int(ax) + (x.ndim if ax < 0 else 0)
        idx[ax] = slice(int(s), None if int(e) >= np.iinfo(np.int32).max else int(e), int(st))
    idx = tuple(idx)
    ctx.set(node.outputs[0], _take(x, idx))
    stv = ctx.static(node.inputs[0], required=False)
    if stv is not None:
        ctx.set_static(node.outputs[0], stv[idx])


@register("Expand", since=8, static={1})
def expand(ctx: Ctx, node: Node):
    """Numpy broadcasting of x against a static shape (a 1 in the shape
    keeps x's dim)."""
    x = ctx.get(node.inputs[0])
    shape = tuple(int(d) for d in ctx.static(node.inputs[1]).reshape(-1))
    ctx.set(node.outputs[0], x.expand(np.broadcast_shapes(tuple(x.shape), shape)))


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


@register("Gather")
def gather(ctx: Ctx, node: Node):
    x = ctx.get(node.inputs[0])
    axis = node.attr("axis", 0)
    st_idx = ctx.static(node.inputs[1], required=False)
    st_x = ctx.static(node.inputs[0], required=False)
    if st_idx is not None and st_x is not None:
        ctx.set_static(node.outputs[0], np.take(st_x, st_idx.astype(np.int64), axis=axis))
        return
    indices = ctx.get(node.inputs[1]).long()
    axis = axis if axis >= 0 else axis + x.ndim
    dim = x.shape[axis]
    # ONNX allows negative indices (from the end).
    indices = torch.where(indices < 0, indices + dim, indices)
    y = x.index_select(axis, indices.reshape(-1))
    ctx.set(node.outputs[0], y.reshape(
        tuple(x.shape[:axis]) + tuple(indices.shape) + tuple(x.shape[axis + 1:])))


@register("Cast", since=6)
def cast(ctx: Ctx, node: Node):
    x = ctx.get(node.inputs[0])
    code = int(node.attr("to"))
    ctx.set(node.outputs[0], dt.saturating_cast(x, dt.onnx_to_torch_dtype(code)))
    st = ctx.static(node.inputs[0], required=False)
    if st is not None:
        ctx.set_static(node.outputs[0], np.asarray(st).astype(dt.onnx_to_numpy_dtype(code)))


@register("CastLike", since=15)
def cast_like(ctx: Ctx, node: Node):
    x = ctx.get(node.inputs[0])
    like = ctx.get(node.inputs[1])
    ctx.set(node.outputs[0], dt.saturating_cast(x, like.dtype))


@register("ScatterND", since=11)
def scatter_nd(ctx: Ctx, node: Node):
    """x[idx[..., :k]] = updates. Negative indices count from the end and
    out-of-range ones are dropped, as JAX's scatter drops them; of several
    in-range rows with one target, the last wins. Every row writes to its
    index modulo the dims the update of the last in-range row with that
    target, or the old value where there is none, so all writes to one
    target carry one value and their order does not matter. No step waits
    on the device (no boolean-mask indexing), so a CUDA graph can capture
    it. The reduction attribute is not taken."""
    if node.attr("reduction", "none") not in ("none", b"none"):
        raise NotSupportedError("ScatterND with a reduction")
    x = ctx.get(node.inputs[0])
    idx = ctx.get(node.inputs[1]).long()
    upd = ctx.get(node.inputs[2])
    k = idx.shape[-1]
    flat = idx.reshape(-1, k)
    cols, inside, target = [], None, None
    for i in range(k):
        d = x.shape[i]
        col = flat[:, i]
        col = torch.where(col < 0, col + d, col)
        ok = (col >= 0) & (col < d)
        inside = ok if inside is None else inside & ok
        cols.append(torch.remainder(col, d))
        target = cols[-1] if target is None else target * d + cols[-1]
    cols = tuple(cols)
    n = flat.shape[0]
    order = torch.arange(n, device=flat.device)
    writer = torch.full((math.prod(x.shape[:k]),), -1, dtype=torch.long, device=flat.device)
    writer = writer.scatter_reduce(0, target, torch.where(inside, order, -1), "amax")[target]
    rows = upd.reshape((-1,) + tuple(x.shape[k:])).to(x.dtype)[writer.clamp_min(0)]
    keep = (writer >= 0).reshape((-1,) + (1,) * (x.ndim - k))
    rows = torch.where(keep, rows, x[cols])
    if node.inputs[0] in ctx.donated:
        out = x.index_put_(cols, rows)
    else:
        out = x.index_put(cols, rows)
    ctx.set(node.outputs[0], out)


@register("Pad", static={1, 2})
def pad(ctx: Ctx, node: Node):
    """Constant padding over any dims (the JAX lowering's reflect, edge and
    wrap modes are not taken)."""
    x = ctx.get(node.inputs[0])
    mode = node.attr("mode", "constant")
    if isinstance(mode, bytes):
        mode = mode.decode()
    if mode != "constant":
        raise NotSupportedError(f"Pad mode {mode!r}")
    if ctx.opset >= 11:
        pads = ctx.static(node.inputs[1]).reshape(-1).astype(np.int64)
        cval = 0.0
        if len(node.inputs) > 2 and node.inputs[2]:
            cval = float(ctx.static(node.inputs[2]).reshape(-1)[0])
    else:
        pads = np.asarray(node.attr("pads"), np.int64)
        cval = node.attr("value", 0.0)
    rank = x.ndim
    flat = []
    for i in reversed(range(rank)):  # F.pad takes the last dim first
        flat += [int(pads[i]), int(pads[i + rank])]
    ctx.set(node.outputs[0], F.pad(x, flat, mode="constant", value=cval))


@register("Split", since=2, static={1})
def split(ctx: Ctx, node: Node):
    """Sizes from the input (opset >= 13) or the attribute (earlier), else
    equal chunks of ceil(dim / outputs) with the remainder last (opset 18's
    rule, and GEGLU's `torch.chunk`)."""
    x = ctx.get(node.inputs[0])
    axis = int(node.attr("axis", 0))
    if axis < 0:
        axis += x.ndim
    sizes = None
    if ctx.opset >= 13:
        if len(node.inputs) > 1 and node.inputs[1]:
            sizes = [int(s) for s in ctx.static(node.inputs[1]).reshape(-1)]
    else:
        s = node.attr("split")
        sizes = list(s) if s else None
    n_out = len(node.outputs)
    if sizes is None:
        chunk = -(-x.shape[axis] // n_out)
        sizes = [chunk] * (n_out - 1) + [x.shape[axis] - chunk * (n_out - 1)]
        if sizes[-1] <= 0:
            raise NotSupportedError(f"Split: dim {x.shape[axis]} into {n_out} outputs leaves an "
                                    f"empty chunk")
    for out_name, part in zip(node.outputs, torch.split(x, sizes, dim=axis)):
        ctx.set(out_name, part)
