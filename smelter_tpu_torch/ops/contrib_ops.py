"""onnxruntime `com.microsoft` contrib op lowerings of the decode path:
SimplifiedLayerNormalization (RMSNorm) and RotaryEmbedding.

Counterparts of `smelter_tpu/ops/contrib_ops.py` (`_rms_norm`,
`simplified_layer_norm`, `_apply_rotary`, `rotary_embedding`), with the same
dtype handling: both compute in f32 and return the input's dtype; the rotary
tables are read in whatever dtype the executor gives them (the compute
dtype) and widened to f32. Rotary positions past the end of the tables are
clamped, as JAX's gather does.
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
