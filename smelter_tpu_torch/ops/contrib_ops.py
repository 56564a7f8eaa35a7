"""onnxruntime `com.microsoft` contrib op lowerings of the decode path:
SimplifiedLayerNormalization (RMSNorm), RotaryEmbedding,
SkipSimplifiedLayerNormalization and GroupQueryAttention (the prefill
graph, `models/llama_style.py::build_full`); and SkipLayerNormalization
(the residual add + LayerNorm that `passes/fuse_attention.py::
fuse_residual_ln` makes of the ViT graph).

Counterparts of `smelter_tpu/ops/contrib_ops.py` (`_rms_norm`,
`simplified_layer_norm`, `skip_layer_norm`, `_apply_rotary`, `rotary_embedding`,
`skip_simplified_layer_norm`, `group_query_attention`), with the same
dtype handling: the norms and rotary compute in f32 and return the input's
dtype; the rotary tables are read in whatever dtype the executor gives them
(the compute dtype) and widened to f32. Rotary positions past the end of the
tables are clamped, as JAX's gather does.

GroupQueryAttention takes the no-past causal form (what `build_full`
emits), with packed or separate projections, fused rotary, a sliding window
and per-batch key lengths; the ORT-genai past-buffer form raises
NotSupportedError. Its attention core is the JAX package's
(`jax.nn.dot_product_attention`'s XLA formulation) written out: f32 logits,
the additive -10000 bias in the promoted dtype, an f32 softmax, the
probabilities in K's dtype against V.
"""

from __future__ import annotations

import torch

from ..ir.errors import NotSupportedError
from ..ir.graph import Node
from .registry import Ctx, register


def _rms_norm(x, gamma, eps, axis):
    xf = x.float()
    axes = tuple(range(axis, x.ndim))
    ms = torch.mean(torch.square(xf), dim=axes, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * gamma.float()).to(x.dtype)


@register("SimplifiedLayerNormalization")
def simplified_layer_norm(ctx: Ctx, node: Node):
    """RMSNorm as fused by ORT (no mean subtraction, no beta)."""
    x = ctx.get(node.inputs[0])
    gamma = ctx.get(node.inputs[1])
    axis = int(node.attr("axis", -1))
    if axis < 0:
        axis += x.ndim
    ctx.set(node.outputs[0],
            _rms_norm(x, gamma, float(node.attr("epsilon", 1e-5)), axis))
    for extra in node.outputs[1:]:
        if extra:
            raise NotSupportedError("SimplifiedLayerNormalization inv_std_var output")


@register("SkipSimplifiedLayerNormalization")
def skip_simplified_layer_norm(ctx: Ctx, node: Node):
    """RMSNorm(input + skip [+ bias]); output 3 is the pre-norm sum."""
    x = ctx.get(node.inputs[0])
    skip = ctx.get(node.inputs[1]).to(x.dtype)
    gamma = ctx.get(node.inputs[2])
    h = x + skip
    if len(node.inputs) > 3 and node.inputs[3]:
        h = h + ctx.get(node.inputs[3]).to(x.dtype)
    eps = float(node.attr("epsilon", 1e-6))
    ctx.set(node.outputs[0], _rms_norm(h, gamma, eps, h.ndim - 1))
    if len(node.outputs) > 3 and node.outputs[3]:
        ctx.set(node.outputs[3], h)
    for extra in node.outputs[1:3]:
        if extra:
            raise NotSupportedError("SkipSimplifiedLayerNormalization mean/inv_std outputs")


@register("SkipLayerNormalization")
def skip_layer_norm(ctx: Ctx, node: Node):
    """LayerNorm(input + skip [+ bias]) over the last axis; output 3 is the
    pre-norm sum. Under `fused_layernorm=True` or `use_pallas`, without a
    bias and with skip of x's shape, it takes
    `kernels/layer_norm.py::residual_layer_norm`, as the JAX lowering takes
    its Pallas kernel; otherwise the composite."""
    from ..kernels.layer_norm import layer_norm_plain, residual_layer_norm

    x = ctx.get(node.inputs[0])
    skip = ctx.get(node.inputs[1]).to(x.dtype)
    gamma = ctx.get(node.inputs[2])
    beta = ctx.get(node.inputs[3]) if len(node.inputs) > 3 and node.inputs[3] else None
    eps = float(node.attr("epsilon", 1e-12))
    for extra in node.outputs[1:3]:
        if extra:
            raise NotSupportedError("SkipLayerNormalization mean/inv_std outputs")
    has_bias = len(node.inputs) > 4 and bool(node.inputs[4])
    cfg = ctx.config
    fln = getattr(cfg, "fused_layernorm", "auto") if cfg is not None else "auto"
    use_pallas = bool(cfg is not None and getattr(cfg, "use_pallas", False))
    if ((fln is True or use_pallas) and not has_bias and x.dtype.is_floating_point
            and x.shape == skip.shape):
        b = beta if beta is not None else torch.zeros_like(gamma)
        if b.dtype != gamma.dtype:
            gamma, b = gamma.float(), b.float()
        h, y = residual_layer_norm(x, skip, gamma, b, eps=eps)
    else:
        h = x + skip
        if has_bias:
            h = h + ctx.get(node.inputs[4]).to(x.dtype)
        y = layer_norm_plain(h, gamma, beta, eps=eps)
    ctx.set(node.outputs[0], y)
    if len(node.outputs) > 3 and node.outputs[3]:
        ctx.set(node.outputs[3], h)


def _apply_rotary(x, pos, cos_cache, sin_cache, interleaved, rot_dim=0):
    """Rotate (B,S,H,hd) by position. cos/sin caches are (max_pos, r/2)."""
    hd = x.shape[-1]
    r = rot_dim or 2 * cos_cache.shape[-1]
    # positions past the table read its last row, as JAX's gather clamps
    # (a multi-step tick runs its last steps past the end of a sequence)
    pos = pos.clamp(max=cos_cache.shape[0] - 1)
    cos = cos_cache[pos].float()[:, :, None, :]  # (B,S,1,r/2)
    sin = sin_cache[pos].float()[:, :, None, :]
    xf = x.float()
    xr, tail = xf[..., :r], xf[..., r:]
    if interleaved:
        x1, x2 = xr[..., 0::2], xr[..., 1::2]
        o1 = x1 * cos - x2 * sin
        o2 = x1 * sin + x2 * cos
        rot = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    else:
        half = r // 2
        x1, x2 = xr[..., :half], xr[..., half:]
        rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    out = torch.cat([rot, tail], dim=-1) if hd > r else rot
    return out.to(x.dtype)


@register("RotaryEmbedding")
def rotary_embedding(ctx: Ctx, node: Node):
    """Standalone rotary position embedding over (B,S,D) or (B,H,S,hd)."""
    x = ctx.get(node.inputs[0])
    pos = ctx.get(node.inputs[1]).long()
    cos_cache = ctx.get(node.inputs[2])
    sin_cache = ctx.get(node.inputs[3])
    interleaved = int(node.attr("interleaved", 0))
    num_heads = int(node.attr("num_heads", 0))
    rot_dim = int(node.attr("rotary_embedding_dim", 0))
    if pos.ndim == 0 or (pos.ndim == 1 and pos.shape[0] == 1):
        # scalar offset: every token at position offset + index
        b = x.shape[0]
        s = x.shape[1] if x.ndim == 3 else x.shape[2]
        pos = pos.reshape(()) + torch.arange(s, device=x.device)[None, :] \
            + torch.zeros((b, 1), dtype=torch.long, device=x.device)
    if x.ndim == 4:  # (B,H,S,hd)
        xn = x.transpose(1, 2)  # -> (B,S,H,hd)
        y = _apply_rotary(xn, pos, cos_cache, sin_cache, interleaved, rot_dim)
        ctx.set(node.outputs[0], y.transpose(1, 2))
        return
    b, s, d = x.shape
    if num_heads > 0:
        h = num_heads
    elif rot_dim:
        raise NotSupportedError(
            "RotaryEmbedding rotary_embedding_dim on 3-D input requires "
            "num_heads (head size is not inferable)")
    else:
        h = max(1, d // (2 * cos_cache.shape[-1]))
    y = _apply_rotary(x.reshape(b, s, h, d // h), pos, cos_cache, sin_cache,
                      interleaved, rot_dim)
    ctx.set(node.outputs[0], y.reshape(b, s, d))


def _core_attention(q, k, v, bias, scale):
    """q/k/v (B, S, H, hd); bias additive (B|1, H|1, Sq, T) f32. Mixed q/k
    dtypes (K/V dequantized mid-graph) are promoted, as the JAX package
    does."""
    ct = torch.promote_types(q.dtype, k.dtype)
    q, k, v = q.to(ct), k.to(ct), v.to(ct)
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.to(ct).float()
    probs = torch.softmax(logits, dim=-1).to(k.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


@register("GroupQueryAttention")
def group_query_attention(ctx: Ctx, node: Node):
    """GQA: H query heads share H_kv key/value heads; always causal."""
    def opt(i):
        return ctx.get(node.inputs[i]) if len(node.inputs) > i and node.inputs[i] else None

    h = int(node.attr("num_heads"))
    h_kv = int(node.attr("kv_num_heads"))
    window = int(node.attr("local_window_size", -1))
    query, key, value = opt(0), opt(1), opt(2)
    if opt(3) is not None or opt(4) is not None:
        raise NotSupportedError("GroupQueryAttention past_key/past_value buffers")
    seqlens_k, cos_cache, sin_cache = opt(5), opt(7), opt(8)
    b, s = query.shape[0], query.shape[1]
    if key is None:  # packed: (B, S, (H + 2 H_kv) hd)
        hd = query.shape[-1] // (h + 2 * h_kv)
        q = query[..., :h * hd].reshape(b, s, h, hd)
        k = query[..., h * hd:(h + h_kv) * hd].reshape(b, s, h_kv, hd)
        v = query[..., (h + h_kv) * hd:].reshape(b, s, h_kv, hd)
    else:
        hd = query.shape[-1] // h
        q = query.reshape(b, s, h, hd)
        k = key.reshape(b, s, h_kv, hd)
        v = value.reshape(b, s, h_kv, hd)
    if int(node.attr("do_rotary", 0)):
        if cos_cache is None or sin_cache is None:
            raise NotSupportedError("GroupQueryAttention do_rotary without caches")
        pos = torch.arange(s, device=query.device)[None] + torch.zeros(
            (b, 1), dtype=torch.long, device=query.device)
        inter = int(node.attr("rotary_interleaved", 0))
        q = _apply_rotary(q, pos, cos_cache, sin_cache, inter)
        k = _apply_rotary(k, pos, cos_cache, sin_cache, inter)
    scale = node.attr("scale")
    scale = float(scale) if scale is not None else hd ** -0.5
    rep = h // h_kv
    kq = k.repeat_interleave(rep, dim=2)
    vq = v.repeat_interleave(rep, dim=2)
    t = k.shape[1]
    dev = query.device
    keep = torch.ones((s, t), dtype=torch.bool, device=dev).tril(t - s)
    bias = torch.where(keep, 0.0, -10000.0)[None, None]
    if window > 0:
        # key j is visible to query i only when i - window < j <= i
        band = torch.ones((s, t), dtype=torch.bool, device=dev).tril(t - s - window)
        bias = bias + torch.where(band, -10000.0, 0.0)[None, None]
    if seqlens_k is not None:
        # per ORT: seqlens_k = total key length - 1
        if tuple(seqlens_k.shape) != (b,):
            raise NotSupportedError(f"GroupQueryAttention seqlens_k shape {tuple(seqlens_k.shape)}")
        lens = seqlens_k.reshape(b, 1).long() + 1
        valid = torch.arange(t, device=dev)[None] < lens  # (B, T)
        bias = bias + torch.where(valid, 0.0, -10000.0)[:, None, None, :]
    out = _core_attention(q, kq, vq, bias, scale)
    ctx.set(node.outputs[0], out.reshape(b, s, h * hd))
    if len(node.outputs) > 1 and node.outputs[1]:
        ctx.set(node.outputs[1], k.transpose(1, 2))
    if len(node.outputs) > 2 and node.outputs[2]:
        ctx.set(node.outputs[2], v.transpose(1, 2))
