"""Neural-net op lowerings of the ResNet path: Conv, MaxPool,
GlobalAveragePool, BatchNormalization, Gemm, MatMul; Softmax (the
static-cache decode step's dense attention); and LayerNormalization (the
ViT graph), which takes `kernels/layer_norm.py::fused_layer_norm` where the
configuration routes it there, as the JAX lowering takes its Pallas kernel.

The port's counterparts of the lowerings in `smelter_tpu/ops/nn.py`, with
the same semantics. A node the layout pass rewrote (`data_layout=NHWC`)
holds its activations as (N, H, W, C) and, for Conv, an HWIO weight. PyTorch
convolves logically-NCHW tensors, so an NHWC activation is handed over as a
permuted view, which is NCHW with channels-last strides: no copy, and cuDNN
runs its channels-last kernels. `weights.params_from_numpy` stores HWIO
weights over an OHWI buffer so that their OIHW view is channels-last too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ir.errors import NotSupportedError
from ..ir.graph import Node
from . import padding as P
from .registry import Ctx, register

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
    bias = None
    if len(node.inputs) > 2 and node.inputs[2]:
        bias = ctx.get(node.inputs[2]).to(x.dtype)
    y = _CONV[rank](x, w.to(x.dtype), bias, strides, sym, dilations, group)
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


@register("MaxPool")
def max_pool(ctx: Ctx, node: Node):
    if len(node.outputs) > 1 and node.outputs[1]:
        raise NotSupportedError("MaxPool with an indices output")
    x = ctx.get(node.inputs[0])
    nhwc = _layout(node) == "NHWC"
    rank = x.ndim - 2
    kernel = tuple(node.attr("kernel_shape"))
    strides = tuple(node.attr("strides", [1] * rank))
    dilations = tuple(node.attr("dilations", [1] * rank))
    if nhwc:
        x = _to_nchw(x)
    in_spatial = tuple(x.shape[2:])
    pads = P.resolve_pads(node, in_spatial, kernel, strides, dilations)
    if node.attr("ceil_mode", 0):
        pads = [(lo, hi + P.pool_extra_ceil_pad(in_spatial[i], kernel[i], strides[i],
                                                 dilations[i], lo, hi))
                for i, (lo, hi) in enumerate(pads)]
    # PyTorch pads a pool by at most half the window: pad the rest here,
    # with the lowest value, so padding never wins the max.
    low = (torch.finfo(x.dtype).min if x.dtype.is_floating_point
           else torch.iinfo(x.dtype).min)
    if any(lo != hi or lo > k // 2 for (lo, hi), k in zip(pads, kernel)):
        x = F.pad(x, [p for lo, hi in reversed(pads) for p in (lo, hi)], value=low)
        sym = (0,) * rank
    else:
        sym = tuple(lo for lo, _ in pads)
    y = _MAX_POOL[rank](x, kernel, strides, sym, dilations)
    ctx.set(node.outputs[0], _to_nhwc(y) if nhwc else y)


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
