"""Neural-net op lowerings of the ResNet path: Conv, MaxPool,
GlobalAveragePool, BatchNormalization, Gemm, MatMul; GroupNormalization
(SD-UNet); Softmax (the
static-cache decode step's dense attention); LayerNormalization (the
ViT graph), which takes `kernels/layer_norm.py::fused_layer_norm` where the
configuration routes it there, as the JAX lowering takes its Pallas kernel;
the image-to-image ops: nearest Resize, PixelNearestUp, PixelConv and
PixelConvQ (ESRGAN, on `kernels/pixel_conv.py`), MaxPool's indices output
and MaxUnpool (SegNet, on `kernels/max_unpool.py`).

The port's counterparts of the lowerings in `smelter_tpu/ops/nn.py`, with
the same semantics. A node the layout pass rewrote (`data_layout=NHWC`)
holds its activations as (N, H, W, C) and, for Conv, an HWIO weight. PyTorch
convolves logically-NCHW tensors, so an NHWC activation is handed over as a
permuted view, which is NCHW with channels-last strides: no copy, and cuDNN
runs its channels-last kernels. `weights.params_from_numpy` stores HWIO
weights over an OHWI buffer so that their OIHW view is channels-last too.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ir.errors import NotSupportedError
from ..ir.graph import Node
from . import padding as P
from .registry import Ctx, register
from .resize_utils import resize_nearest

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _layout(node: Node) -> str:
    """Activation layout the layout pass (passes/layout.py) gave this node:
    "NCHW" (ONNX default) or "NHWC" (4-D only; conv weights relaid to HWIO
    offline)."""
    return node.attr("data_layout", "NCHW")


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> an (N, C, H, W) view with channels-last strides."""
    return x.permute(0, 3, 1, 2)


def _to_nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


def _conv_attrs(node: Node, rank: int):
    strides = tuple(node.attr("strides", [1] * rank))
    dilations = tuple(node.attr("dilations", [1] * rank))
    group = int(node.attr("group", 1))
    return strides, dilations, group


def _split_pads(x: torch.Tensor, pads, value: float = 0.0):
    """Explicit (lo, hi) pads over the trailing spatial dims -> the
    symmetric part the op pads itself, after padding (or cropping) x by
    the rest."""
    sym = [min(lo, hi) if lo >= 0 and hi >= 0 else 0 for lo, hi in pads]
    extra = []
    for (lo, hi), s in zip(reversed(pads), reversed(sym)):
        extra += [lo - s, hi - s]
    if any(extra):
        x = F.pad(x, extra, value=value)
    return x, tuple(sym)


@register("Conv")
def conv(ctx: Ctx, node: Node):
    x = ctx.get(node.inputs[0])
    w = ctx.get(node.inputs[1])
    nhwc = _layout(node) == "NHWC"
    rank = x.ndim - 2
    strides, dilations, group = _conv_attrs(node, rank)
    if nhwc:
        kernel = tuple(w.shape[:2])
        in_spatial = tuple(x.shape[1:3])
        x = _to_nchw(x)
        w = w.permute(3, 2, 0, 1)  # HWIO -> OIHW view
    else:
        kernel = tuple(w.shape[2:])
        in_spatial = tuple(x.shape[2:])
    if rank not in _CONV:
        raise NotSupportedError(f"conv with {rank} spatial dims")
    pads = P.resolve_pads(node, in_spatial, kernel, strides, dilations)
    x, sym = _split_pads(x, pads)
    y = _CONV[rank](x, w.to(x.dtype), None, strides, sym, dilations, group)
    if len(node.inputs) > 2 and node.inputs[2]:
        # the conv rounds to x's dtype first, then the bias adds in that
        # dtype, as the JAX lowering does (inside F.conv2d it would add
        # before the rounding)
        bias = ctx.get(node.inputs[2]).to(x.dtype)
        y = y + bias.reshape((1, -1) + (1,) * rank)
    ctx.set(node.outputs[0], _to_nhwc(y) if nhwc else y)


@register("Gemm")
def gemm(ctx: Ctx, node: Node):
    a = ctx.get(node.inputs[0])
    b = ctx.get(node.inputs[1])
    alpha = node.attr("alpha", 1.0)
    beta = node.attr("beta", 1.0)
    if a.ndim > 2:
        a = a.reshape(a.shape[0], -1)  # FC over feature maps: flatten to (N, -1)
    if node.attr("transA", 0):
        a = a.T
    if node.attr("transB", 0):
        b = b.T
    y = torch.matmul(a, b.to(a.dtype))
    if alpha != 1.0:
        y = y * alpha
    if len(node.inputs) > 2 and node.inputs[2]:
        c = ctx.get(node.inputs[2]).to(y.dtype)
        y = y + (c if beta == 1.0 else c * beta)
    ctx.set(node.outputs[0], y)


@register("MatMul")
def matmul(ctx: Ctx, node: Node):
    a = ctx.get(node.inputs[0])
    b = ctx.get(node.inputs[1])
    ctx.set(node.outputs[0], torch.matmul(a, b.to(a.dtype)))


def _pool_pads(node: Node, in_spatial, kernel, strides, dilations):
    """(lo, hi) pads of a pool, ceil_mode's extra high pad included."""
    pads = P.resolve_pads(node, in_spatial, kernel, strides, dilations)
    if node.attr("ceil_mode", 0):
        pads = [(lo, hi + P.pool_extra_ceil_pad(in_spatial[i], kernel[i], strides[i],
                                                 dilations[i], lo, hi))
                for i, (lo, hi) in enumerate(pads)]
    return pads


def _lowest(dtype: torch.dtype):
    return torch.finfo(dtype).min if dtype.is_floating_point else torch.iinfo(dtype).min


@register("MaxPool")
def max_pool(ctx: Ctx, node: Node):
    if len(node.outputs) > 1 and node.outputs[1]:
        return _max_pool_with_indices(ctx, node)
    x = ctx.get(node.inputs[0])
    nhwc = _layout(node) == "NHWC"
    rank = x.ndim - 2
    kernel = tuple(node.attr("kernel_shape"))
    strides = tuple(node.attr("strides", [1] * rank))
    dilations = tuple(node.attr("dilations", [1] * rank))
    if nhwc:
        x = _to_nchw(x)
    in_spatial = tuple(x.shape[2:])
    pads = _pool_pads(node, in_spatial, kernel, strides, dilations)
    if not x.dtype.is_floating_point:
        # int8 (static quantization's quant-transparent twin): the max of
        # the window's strided taps, which keeps x's memory format
        y = _max_pool_taps(x, kernel, strides, dilations, pads)
        ctx.set(node.outputs[0], _to_nhwc(y) if nhwc else y)
        return
    # PyTorch pads a pool by at most half the window: pad the rest here,
    # with the lowest value, so padding never wins the max.
    low = _lowest(x.dtype)
    if any(lo != hi or lo > k // 2 for (lo, hi), k in zip(pads, kernel)):
        x = F.pad(x, [p for lo, hi in reversed(pads) for p in (lo, hi)], value=low)
        sym = (0,) * rank
    else:
        sym = tuple(lo for lo, _ in pads)
    y = _MAX_POOL[rank](x, kernel, strides, sym, dilations)
    ctx.set(node.outputs[0], _to_nhwc(y) if nhwc else y)


def _max_pool_taps(x: torch.Tensor, kernel, strides, dilations, pads) -> torch.Tensor:
    """MaxPool as the elementwise max of the kernel's strided taps over x
    padded with its dtype's lowest value: exact for any dtype on any device
    (PyTorch's integer pools are not: on the CPU a channels-last int8 map
    of more than 127 positions is refused)."""
    rank = len(kernel)
    out_spatial = tuple(P.conv_out_size(x.shape[2 + i], kernel[i], strides[i], dilations[i],
                                        pads[i][0], pads[i][1]) for i in range(rank))
    xp = F.pad(x, [p for lo, hi in reversed(pads) for p in (lo, hi)], value=_lowest(x.dtype))
    y = None
    for taps in itertools.product(*(range(k) for k in kernel)):
        sl = (slice(None), slice(None)) + tuple(
            slice(t * d, t * d + (o - 1) * s + 1, s)
            for t, d, o, s in zip(taps, dilations, out_spatial, strides))
        y = xp[sl] if y is None else torch.maximum(y, xp[sl])
    return y if math.prod(kernel) > 1 else y.clone()  # one tap: a view of xp


@register("GlobalAveragePool")
def global_average_pool(ctx: Ctx, node: Node):
    x = ctx.get(node.inputs[0])
    axes = tuple(range(1, x.ndim - 1)) if _layout(node) == "NHWC" else tuple(range(2, x.ndim))
    ctx.set(node.outputs[0], x.mean(dim=axes, keepdim=True))


@register("BatchNormalization")
def batch_norm(ctx: Ctx, node: Node):
    """Inference-style BN in f32, cast back to the activation dtype."""
    x = ctx.get(node.inputs[0])
    scale, bias, mean, var = (ctx.get(n).float() for n in node.inputs[1:5])
    eps = node.attr("epsilon", 1e-5)
    shape = (-1,) if _layout(node) == "NHWC" else (1, -1) + (1,) * (x.ndim - 2)
    inv = torch.rsqrt(var + eps) * scale
    y = x.float() * inv.reshape(shape) + (bias - mean * inv).reshape(shape)
    ctx.set(node.outputs[0], y.to(x.dtype))


@register("Softmax")
def softmax(ctx: Ctx, node: Node):
    x = ctx.get(node.inputs[0])
    if ctx.opset >= 13:
        y = torch.softmax(x, dim=int(node.attr("axis", -1)))
    else:
        # opset < 13: softmax over the coalesced dims [axis:] (2-D flatten).
        axis = int(node.attr("axis", 1))
        axis = axis + x.ndim if axis < 0 else axis
        y = torch.softmax(x.reshape(tuple(x.shape[:axis]) + (-1,)), dim=-1).reshape(x.shape)
    ctx.set(node.outputs[0], y)


@register("LayerNormalization", since=17)
def layer_norm(ctx: Ctx, node: Node):
    """The JAX lowering's routing: the LayerNorm kernel engages under
    `fused_layernorm=True`, under `use_pallas`, or under "auto" for a tensor
    on the card (the JAX package: on the TPU), and is taken when engaged
    unless `fused_layernorm` is False, for a last-axis norm with no
    mean/inv-std outputs. Otherwise the f32 composite, the kernel's plain
    version over the normalized axes."""
    from ..kernels.layer_norm import fused_layer_norm, layer_norm_plain

    x = ctx.get(node.inputs[0])
    gamma = ctx.get(node.inputs[1])
    has_beta = len(node.inputs) > 2 and bool(node.inputs[2])
    axis = node.attr("axis", -1)
    eps = float(node.attr("epsilon", 1e-5))
    if axis < 0:
        axis += x.ndim
    cfg = ctx.config
    fln = getattr(cfg, "fused_layernorm", "auto") if cfg is not None else "auto"
    use_pallas = bool(cfg is not None and getattr(cfg, "use_pallas", False))
    engage = (fln is True or use_pallas
              or (fln == "auto" and x.device.type == "cuda"))
    if engage and fln is not False and axis == x.ndim - 1 and not any(node.outputs[1:]):
        beta = ctx.get(node.inputs[2]) if has_beta else torch.zeros_like(gamma)
        if beta.dtype != gamma.dtype:
            gamma, beta = gamma.float(), beta.float()
        ctx.set(node.outputs[0], fused_layer_norm(x, gamma, beta, eps=eps))
        return
    beta = ctx.get(node.inputs[2]) if has_beta else None
    ctx.set(node.outputs[0], layer_norm_plain(x, gamma, beta, eps=eps,
                                              dims=tuple(range(axis, x.ndim))))
    for extra in node.outputs[1:]:
        if extra:
            raise NotSupportedError("LayerNormalization mean/invstd outputs")


def _group_norm(x: torch.Tensor, num_groups: int, scale, bias, eps: float,
                layout: str = "NCHW") -> torch.Tensor:
    """GroupNorm in f32: the statistics over each group's channels and all
    spatial positions (mean, then the mean of squared deviations), then the
    per-channel scale and bias; returns f32."""
    xf = x.float()
    if layout == "NHWC":
        n, c = x.shape[0], x.shape[-1]
        xf = xf.reshape((n,) + tuple(x.shape[1:-1]) + (num_groups, c // num_groups))
        axes = tuple(range(1, xf.ndim - 2)) + (xf.ndim - 1,)
        shape = (-1,)
    else:
        n, c = x.shape[:2]
        xf = xf.reshape((n, num_groups, c // num_groups) + tuple(x.shape[2:]))
        axes = tuple(range(2, xf.ndim))
        shape = (1, -1) + (1,) * (x.ndim - 2)
    mean = xf.mean(dim=axes, keepdim=True)
    var = (xf - mean).square().mean(dim=axes, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return y * scale.reshape(shape) + bias.reshape(shape)


# Official since opset 18; taken at any opset, as the JAX lowering does.
@register("GroupNormalization")
def group_normalization(ctx: Ctx, node: Node):
    """SD-UNet's GroupNorm, in either data_layout (NHWC after the layout
    pass). Plain PyTorch, as the JAX package computes it outside any
    kernel."""
    x = ctx.get(node.inputs[0])
    scale = ctx.get(node.inputs[1]).float()
    bias = ctx.get(node.inputs[2]).float()
    y = _group_norm(x, int(node.attr("num_groups")), scale, bias,
                    float(node.attr("epsilon", 1e-5)), _layout(node))
    ctx.set(node.outputs[0], y.to(x.dtype))


# -- MaxPool indices, MaxUnpool (SegNet) ---------------------------------------

def _max_pool_with_indices(ctx: Ctx, node: Node):
    """MaxPool with its second output: int64 indices into the flattened
    [N, C, *spatial] input (ONNX MaxPool-12, storage_order=0), each the first
    max of its window in row-major tap order. The JAX lowering's two forms:
    kernel == stride with no pads or dilation (SegNet's encoder) argmaxes the
    taps of each window; otherwise a stack of the kernel's strided taps over
    the input padded with the lowest value."""
    x = ctx.get(node.inputs[0])
    if _layout(node) == "NHWC":
        raise NotSupportedError("MaxPool indices output under NHWC layout")
    if int(node.attr("storage_order", 0)):
        raise NotSupportedError("MaxPool indices with storage_order=1")
    rank = x.ndim - 2
    kernel = tuple(int(k) for k in node.attr("kernel_shape"))
    strides = tuple(int(s) for s in node.attr("strides", [1] * rank))
    dilations = tuple(int(d) for d in node.attr("dilations", [1] * rank))
    in_spatial = tuple(x.shape[2:])
    pads = _pool_pads(node, in_spatial, kernel, strides, dilations)
    if (strides == kernel and all(lo == 0 and hi == 0 for lo, hi in pads)
            and all(d == 1 for d in dilations)):
        y, spatial = _max_pool_windows(x, kernel)
    else:
        y, spatial = _max_pool_tap_stack(x, kernel, strides, dilations, pads)
    hw = math.prod(in_spatial)
    lead = (1,) * rank
    n_idx = torch.arange(x.shape[0], device=x.device).reshape((-1, 1) + lead)
    c_idx = torch.arange(x.shape[1], device=x.device).reshape((1, -1) + lead)
    ctx.set(node.outputs[0], y)
    ctx.set(node.outputs[1], (n_idx * x.shape[1] + c_idx) * hw + spatial)


def _axis_range(n: int, axis: int, rank: int, device) -> torch.Tensor:
    """arange(n) shaped to broadcast along spatial axis `axis` of `rank`."""
    return torch.arange(n, device=device).reshape(
        tuple(-1 if j == axis else 1 for j in range(rank)))


def _max_pool_windows(x: torch.Tensor, kernel: tuple[int, ...]):
    """Non-overlapping windows (kernel == stride): the max of each window and
    the flat spatial index of its first max (torch.max over the window's
    taps returns the first maximal one)."""
    rank = len(kernel)
    in_spatial = tuple(x.shape[2:])
    out = tuple(s // k for s, k in zip(in_spatial, kernel))
    xc = x[(slice(None), slice(None)) + tuple(slice(0, o * k) for o, k in zip(out, kernel))]
    split = xc.reshape(tuple(x.shape[:2]) + tuple(d for o, k in zip(out, kernel) for d in (o, k)))
    perm = (0, 1) + tuple(2 + 2 * i for i in range(rank)) + tuple(3 + 2 * i for i in range(rank))
    y, tap = split.permute(perm).reshape(tuple(x.shape[:2]) + out + (-1,)).max(dim=-1)
    offs = [None] * rank
    for i in reversed(range(rank)):
        offs[i] = tap % kernel[i]
        tap = tap // kernel[i]
    spatial = None
    for i in range(rank):
        coord = _axis_range(out[i], i, rank, x.device) * kernel[i] + offs[i]
        spatial = coord if spatial is None else spatial * in_spatial[i] + coord
    return y, spatial


def _max_pool_tap_stack(x: torch.Tensor, kernel, strides, dilations, pads):
    """Any window: the kernel's taps as strided slices of the padded input,
    stacked, and the first max over them."""
    rank = len(kernel)
    in_spatial = tuple(x.shape[2:])
    out_spatial = tuple(P.conv_out_size(in_spatial[i], kernel[i], strides[i], dilations[i],
                                        pads[i][0], pads[i][1]) for i in range(rank))
    xp = F.pad(x, [p for lo, hi in reversed(pads) for p in (lo, hi)], value=_lowest(x.dtype))
    vals, flats = [], []
    for taps in itertools.product(*(range(k) for k in kernel)):
        sl = [slice(None), slice(None)]
        flat = None
        for i in range(rank):
            start = taps[i] * dilations[i]
            sl.append(slice(start, start + (out_spatial[i] - 1) * strides[i] + 1, strides[i]))
            coord = _axis_range(out_spatial[i], i, rank, x.device) * strides[i] \
                + start - pads[i][0]
            flat = coord if flat is None else flat * in_spatial[i] + coord
        vals.append(xp[tuple(sl)])
        flats.append(flat.expand(out_spatial))
    y, best = torch.stack(vals).max(dim=0)
    tap_flat = torch.stack(flats).unsqueeze(1).unsqueeze(1).expand((len(vals),) + best.shape)
    return y, torch.gather(tap_flat, 0, best.unsqueeze(0))[0]


def _nearest_expand(t: torch.Tensor, kernel) -> torch.Tensor:
    """Nearest upsample of the trailing spatial dims by integer factors."""
    rank = len(kernel)
    lead = tuple(t.shape[:t.ndim - rank])
    sp = tuple(t.shape[t.ndim - rank:])
    t = t.reshape(lead + tuple(d for s in sp for d in (s, 1)))
    t = t.expand(lead + tuple(d for i, s in enumerate(sp) for d in (s, kernel[i])))
    return t.reshape(lead + tuple(sp[i] * kernel[i] for i in range(rank)))


def _unpool2x2_kernel_ok(x_shape, out_shape, kernel, strides, pads, rank: int) -> bool:
    """The JAX lowering's gate for its 2x2/s2 kernel, kept as it is: windows
    of 2x2 at stride 2, no pads, an output of twice the input and under 2^31
    elements (the JAX kernel's int32 indices; the port's reads int64)."""
    return (list(strides) == list(kernel) == [2, 2] and not any(pads) and rank == 2
            and tuple(out_shape[2:]) == (2 * x_shape[2], 2 * x_shape[3])
            and math.prod(int(d) for d in out_shape) < 2 ** 31)


@register("MaxUnpool", since=9, static={2})
def max_unpool(ctx: Ctx, node: Node):
    """Inverse of MaxPool with indices: X's values at the flat [N, C,
    *spatial] positions in I, zeros elsewhere. The output shape comes from
    input 2 when given, else (x - 1) * stride + kernel - pads. Under the
    JAX lowering's gate the `max_unpool2x2` kernel; other non-overlapping
    windows take the dense form (upsample x and I, keep the position I
    names); anything else a scatter."""
    x = ctx.get(node.inputs[0])
    idx = ctx.get(node.inputs[1])
    kernel = [int(k) for k in node.attr("kernel_shape")]
    rank = len(kernel)
    strides = [int(s) for s in node.attr("strides", [1] * rank)]
    pads = [int(p) for p in node.attr("pads", [0] * (2 * rank))]
    if len(node.inputs) > 2 and node.inputs[2]:
        out_shape = tuple(int(d) for d in ctx.static(node.inputs[2]).reshape(-1))
    else:
        out_shape = tuple(x.shape[:2]) + tuple(
            (x.shape[2 + i] - 1) * strides[i] + kernel[i] - pads[i] - pads[rank + i]
            for i in range(rank))
    if _unpool2x2_kernel_ok(tuple(x.shape), out_shape, kernel, strides, pads, rank):
        from ..kernels.max_unpool import max_unpool2x2

        ctx.set(node.outputs[0], max_unpool2x2(x, idx.reshape(x.shape)))
        return
    idx = idx.reshape(x.shape).to(torch.int64)
    if strides == kernel and not any(pads):
        up_spatial = tuple(x.shape[2 + i] * kernel[i] for i in range(rank))
        hw = math.prod(out_shape[2:])
        pos = None
        for i in range(rank):
            coord = _axis_range(up_spatial[i], i, rank, x.device)
            pos = coord if pos is None else pos * out_shape[2 + i] + coord
        lead = (1,) * rank
        n_idx = torch.arange(x.shape[0], device=x.device).reshape((-1, 1) + lead)
        c_idx = torch.arange(x.shape[1], device=x.device).reshape((1, -1) + lead)
        gpos = (n_idx * x.shape[1] + c_idx) * hw + pos
        y = torch.where(_nearest_expand(idx, kernel) == gpos, _nearest_expand(x, kernel),
                        torch.zeros((), dtype=x.dtype, device=x.device))
        # output_shape may ask for one more (never indexed) row or column a
        # dim (odd sizes before the pool): pad with zeros; crop if smaller.
        extra = [out_shape[2 + i] - y.shape[2 + i] for i in range(rank)]
        if any(d > 0 for d in extra):
            y = F.pad(y, [p for d in reversed(extra) for p in (0, max(0, d))])
        if any(d < 0 for d in extra):
            y = y[tuple(slice(None, d) for d in out_shape)]
        ctx.set(node.outputs[0], y)
        return
    flat = torch.zeros(math.prod(out_shape), dtype=x.dtype, device=x.device)
    flat[idx.reshape(-1)] = x.reshape(-1)
    ctx.set(node.outputs[0], flat.reshape(out_shape))


# -- Resize, and the pixel-conv region ops (ESRGAN) ---------------------------

def _as_str(v) -> str:
    return v.decode() if isinstance(v, bytes) else str(v)


def _spatial_axes(node: Node, ndim: int) -> tuple[int, ...]:
    """Spatial axes under the node's data_layout: NCHW from 2, NHWC from 1,
    NHCW (pixel-conv regions) (1, 3)."""
    layout = _layout(node)
    if layout == "NHWC":
        return tuple(range(1, ndim - 1))
    if layout == "NHCW":
        return (1, 3)
    return tuple(range(2, ndim))


@register("Resize", since=10, static={1, 2, 3})
def resize(ctx: Ctx, node: Node):
    """Nearest Resize under the asymmetric coordinate transform and floor
    rounding (what the fx exporter emits for F.interpolate(mode="nearest")),
    to the sizes input or to floor(scale * in). Other modes raise."""
    x = ctx.get(node.inputs[0])
    mode = _as_str(node.attr("mode", "nearest"))
    if mode != "nearest":
        raise NotSupportedError(f"Resize mode {mode!r} (the port takes nearest)")
    axes = _spatial_axes(node, x.ndim)
    if len(node.inputs) > 3 and node.inputs[3]:
        sizes = ctx.static(node.inputs[3]).astype(np.int64)
        out_sizes = tuple(int(s) for s in sizes[2:])  # NCHW-ordered vector
    else:
        scales_in = node.inputs[2] if len(node.inputs) > 2 else node.inputs[1]
        if ctx.opset == 10:
            scales_in = node.inputs[1]
        sc = ctx.static(scales_in).astype(np.float64)[2:]
        out_sizes = tuple(int(np.floor(s * x.shape[a])) for s, a in zip(sc, axes))
    ctx.set(node.outputs[0], resize_nearest(
        x, out_sizes, spatial_axes=axes,
        coord_mode=_as_str(node.attr("coordinate_transformation_mode", "half_pixel")),
        nearest_mode=_as_str(node.attr("nearest_mode", "round_prefer_floor"))))


@register("PixelNearestUp")
def pixel_nearest_up(ctx: Ctx, node: Node):
    """Integer-scale nearest upsample of (B, H, C, W) activations, inserted
    by passes/pixel_regions.py so ESRGAN's tail stays in the NHCW layout."""
    x = ctx.get(node.inputs[0])
    sh, sw = int(node.attr("sh", 2)), int(node.attr("sw", 2))
    b, h, c, w = x.shape
    y = x.reshape(b, h, 1, c, w, 1).expand(b, h, sh, c, w, sw)
    ctx.set(node.outputs[0], y.reshape(b, h * sh, c, w * sw))


@register("PixelConv")
def pixel_conv(ctx: Ctx, node: Node):
    """3x3/s1/p1 conv of (B, H, C_in, W) activations (passes/pixel_regions.py)
    in `kernels/pixel_conv.py::pixel_conv_rowdot`, with the fused
    LeakyRelu/Relu epilogue of the alpha attr."""
    from ..kernels.pixel_conv import pixel_conv_rowdot

    alpha = node.attrs.get("alpha")
    ctx.set(node.outputs[0], pixel_conv_rowdot(
        ctx.get(node.inputs[0]), ctx.get(node.inputs[1]), ctx.get(node.inputs[2]),
        alpha=None if alpha is None else float(alpha)))


@register("PixelConvQ")
def pixel_conv_q(ctx: Ctx, node: Node):
    """The int8 PixelConv of quant/pixel_quant.py: inputs x_q, w_q, scales
    (s_x * s_w[c_out]), bias; `kernels/pixel_conv.py::pixel_conv_rowdot_q`.
    requant=1 returns int8 on the 1/inv_sy grid, requant=0 the compute
    dtype."""
    from ..kernels.pixel_conv import pixel_conv_rowdot_q

    cfg = ctx.config
    alpha = node.attrs.get("alpha")
    ctx.set(node.outputs[0], pixel_conv_rowdot_q(
        ctx.get(node.inputs[0]), ctx.get(node.inputs[1]), ctx.get(node.inputs[2]),
        ctx.get(node.inputs[3]), alpha=None if alpha is None else float(alpha),
        inv_sy=float(node.attr("inv_sy", 1.0)), requant=bool(node.attr("requant", 1)),
        out_dtype=getattr(torch, cfg.compute_dtype if cfg is not None else "float32")))
