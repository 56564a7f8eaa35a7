"""Fused op lowerings: FusedDequantMatMul, FusedDequantMatMulI4,
RaggedDecodeAttention, PagedDecodeAttention, PagedCacheUpdate,
FusedAttention, FusedQKVAttention, VitAttnBlock, MlpBlock, CrossAttnBlock
and ConvNeXtBlock.

`passes/fuse_dequant.py` rewrites DequantizeLinear(int8 W, scales) ->
MatMul/Gemm into FusedDequantMatMul(x, W (K, N) int8, scales (N,)), and the
grouped 4-bit form into FusedDequantMatMulI4(x, packed (K/2, N), scales
(K/g, N)). FusedDequantMatMul routes as the JAX lowering does: under
`Config.use_pallas` to the port's `dequant_matmul` kernel (or `int8_matmul`
after `quantize_rows` when `Config.int8_activations` is set), otherwise to
the composites the JAX package leaves to XLA (`dequant_matmul_reference`:
W * s rounded to x's dtype, then the matmul; `dequant_matmul_int8_reference`:
`quantize_rows`, an int32 matmul and the scaled epilogue).
FusedDequantMatMulI4 always goes to `int4_matmul`. The paged decode step
(`models/llama_style.py::build_decode_step_paged`) reads its KV pools
through `paged_decode_attention` and writes them with `paged_cache_update`,
in place. The static-cache step (`build_decode_step` after
`passes/ragged_attention.py`, which `Config.ragged_attention` applies)
reads its caches through `ragged_decode_attention`. Each kernel wrapper
launches its Hopper kernel for CUDA tensors and takes its plain version on
the CPU and on `meta`: there is no envelope gate that takes the dense chain
on the card, as the JAX package's TPU gate (`_ragged_kernel_ok`) does.
`Config.int4_block_n` is kept so configurations carry across from the JAX
package; the port does not read it.

`passes/fuse_attention.py` turns the exported matmul -> softmax -> matmul
pattern into FusedAttention, and packs a ViT block's attention into
FusedQKVAttention; `passes/vit_block.py::fuse_vit_block` turns LN -> QKV
projection -> FusedQKVAttention -> projection into one VitAttnBlock, and
`fuse_mlp_block` (off by default) an MLP into MlpBlock. FusedAttention
routes as the JAX lowering does: (B, H, N, hd) operands without a bias take
`flash_attention` from N 2048 with a head dim of at least 64, and under
`use_pallas` from N 512; under `use_pallas`, equal shapes below N 512 take
`short_attention`; every other form (native-layout operands, a bias, rank
3) is computed outside any kernel of the port, as the JAX lowering computes
it with `jax.nn.dot_product_attention`: `F.scaled_dot_product_attention` on
the card, the einsum composite elsewhere. FusedQKVAttention is computed the
same way; it remains only where `fuse_vit_block`'s gate turns a block down.
`fuse_vit_block` also turns SD-UNet's constant-context cross-attention
into CrossAttnBlock when its module flag `_CROSS_ENABLED` is set, and
`fuse_convnext_block` (off by default) a ConvNeXt block into ConvNeXtBlock.
VitAttnBlock, MlpBlock, CrossAttnBlock and ConvNeXtBlock always go to their
kernels (`vit_attention_block`, `mlp_block`, `cross_attn_block`,
`convnext_block`), as the JAX lowerings always go to their Pallas kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ir.errors import NotSupportedError
from ..ir.graph import Node
from ..kernels.attention_short import short_attention
from ..kernels.convnext_block import convnext_block
from ..kernels.cross_attn_block import cross_attn_block
from ..kernels.dequant_matmul import dequant_matmul, dequant_matmul_reference
from ..kernels.flash_attention import flash_attention
from ..kernels.int4_matmul import int4_matmul
from ..kernels.int8_matmul import dequant_matmul_int8, dequant_matmul_int8_reference
from ..kernels.mlp_block import mlp_block
from ..kernels.paged_decode_attention import paged_cache_update, paged_decode_attention
from ..kernels.ragged_decode_attention import ragged_decode_attention
from ..kernels.vit_block import vit_attention_block
from .contrib_ops import _core_attention
from .registry import Ctx, register


@register("FusedDequantMatMul")
def fused_dequant_matmul(ctx: Ctx, node: Node):
    x = ctx.get(node.inputs[0])
    q = ctx.get(node.inputs[1])
    s = ctx.get(node.inputs[2])
    cfg = ctx.config
    use_pallas = bool(cfg is not None and getattr(cfg, "use_pallas", False))
    int8_acts = bool(cfg is not None and getattr(cfg, "int8_activations", False))
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if int8_acts:
        fn = dequant_matmul_int8 if use_pallas else dequant_matmul_int8_reference
    else:
        fn = dequant_matmul if use_pallas else dequant_matmul_reference
    y = fn(x2, q, s.reshape(-1))
    ctx.set(node.outputs[0], y.reshape(lead + (q.shape[-1],)))


@register("FusedDequantMatMulI4")
def fused_dequant_matmul_i4(ctx: Ctx, node: Node):
    """x @ dequant(half-split packed int4 weight, grouped scales): x (..., K),
    packed (K/2, N) int8, scales (K/g, N) f32."""
    x = ctx.get(node.inputs[0])
    pk = ctx.get(node.inputs[1])
    s = ctx.get(node.inputs[2])
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    y = int4_matmul(x2, pk, s, group=int(node.attr("group")), out_dtype=x.dtype)
    ctx.set(node.outputs[0], y.reshape(lead + (pk.shape[1],)))


@register("RaggedDecodeAttention")
def ragged_decode_attention_op(ctx: Ctx, node: Node):
    """Decode-step attention over one stream's static KV cache, reading only
    rows <= pos + chunk - 1. Inputs: (q (c, dim), k (L, kvd), v (L, kvd),
    pos (1,)) or the int8-KV form (q, kq int8, ks (L, 1), vq, vs, pos).
    Attributes num_heads, kv_heads, chunk, scale. The kernel takes a slot
    batch; one stream is a batch of 1 (and a vmapped step a batch of all
    slots, through the kernel's vmap rule)."""
    q = ctx.get(node.inputs[0])
    quant = len(node.inputs) == 6
    if quant:
        k, ks, v, vs, pos = (ctx.get(n) for n in node.inputs[1:])
    else:
        k, v, pos = (ctx.get(n) for n in node.inputs[1:])
        ks = vs = None
    heads = int(node.attr("num_heads"))
    kvh = int(node.attr("kv_heads"))
    c = int(node.attr("chunk", 1))
    scale = float(node.attr("scale"))
    dim = q.shape[-1]
    hd = dim // heads
    g = heads // kvh
    # (c, dim) -> (kvh, g*c, hd); row r = g_idx*c + c_idx (c minor)
    qh = q.reshape(c, kvh, g, hd).permute(1, 2, 0, 3).reshape(1, kvh, g * c, hd)
    one = (lambda t: None if t is None else t.unsqueeze(0))
    out = ragged_decode_attention(qh.contiguous(), one(k), one(v), pos.reshape(1).long(),
                                  one(ks), one(vs), c=c, kv_heads=kvh, scale=scale)
    out = out.reshape(kvh, g, c, hd).permute(2, 0, 1, 3)
    ctx.set(node.outputs[0], out.reshape(c, dim).to(q.dtype))


@register("PagedDecodeAttention")
def paged_decode_attention_op(ctx: Ctx, node: Node):
    """Decode-step attention over a block-paged KV pool. Inputs: (q, k_pool
    (P, ps, kvd), v_pool, table, pos) or the int8-pool form (q, kq, ks
    (P, ps, 1), vq, vs, table, pos); q (B, c, dim), table (B, npg), pos
    (B,) -> (B, c, dim). Attributes num_heads, kv_heads, chunk, scale."""
    q = ctx.get(node.inputs[0])
    quant = len(node.inputs) == 7
    if quant:
        k, ks, v, vs, table, pos = (ctx.get(n) for n in node.inputs[1:])
    else:
        k, v, table, pos = (ctx.get(n) for n in node.inputs[1:])
        ks = vs = None
    heads = int(node.attr("num_heads"))
    kvh = int(node.attr("kv_heads"))
    c = int(node.attr("chunk", 1))
    scale = float(node.attr("scale"))
    bsz, _, dim = q.shape
    hd = dim // heads
    g = heads // kvh
    npg = table.shape[-1]
    # (B, c, dim) -> (B, kvh, g*c, hd); row r = g_idx*c + c_idx (c minor)
    qh = q.reshape(bsz, c, kvh, g, hd).permute(0, 2, 3, 1, 4).reshape(bsz, kvh, g * c, hd)
    out = paged_decode_attention(qh.contiguous(), k, v, table.reshape(bsz, npg),
                                 pos.reshape(bsz), ks, vs, c=c, kv_heads=kvh, scale=scale)
    out = out.reshape(bsz, kvh, g, c, hd).permute(0, 3, 1, 2, 4)
    ctx.set(node.outputs[0], out.reshape(bsz, c, dim).to(q.dtype))


@register("PagedCacheUpdate")
def paged_cache_update_op(ctx: Ctx, node: Node):
    """Scatter this step's K or V rows into the paged pool, in place:
    (pool (P, ps, kvd), table (B, npg), pos (B,), rows (B, c, kvd)) -> the
    same pool tensor, updated. Dead slots rely on the scratch-page discipline
    (serving/kv_pool.py PagePool(scratch=True)): their table rows point at
    the reserved page, so their writes land there."""
    pool, table, pos, rows = (ctx.get(n) for n in node.inputs)
    bsz = rows.shape[0]
    ctx.set(node.outputs[0], paged_cache_update(
        pool, table.reshape(bsz, -1), pos.reshape(bsz), rows))


def _library_attention(q, k, v, bias, scale: float) -> torch.Tensor:
    """Attention over (B, N, H, hd) operands outside any kernel of the port,
    where the JAX lowering calls `jax.nn.dot_product_attention`:
    `F.scaled_dot_product_attention` on the card, the einsum composite
    (`_core_attention`: f32 logits times scale, an f32 softmax, the
    probabilities in K's dtype against V) elsewhere. bias is additive,
    (B|1, H|1, Nq, Nk). Returns (B, Nq, H, hd)."""
    if q.device.type != "cuda":
        return _core_attention(q, k, v, bias, scale)
    ct = torch.promote_types(q.dtype, k.dtype)
    q, k, v = (t.to(ct).transpose(1, 2) for t in (q, k, v))
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=None if bias is None
                                         else bias.to(ct), scale=scale)
    return out.transpose(1, 2)


@register("FusedAttention")
def fused_attention(ctx: Ctx, node: Node):
    """Scaled dot-product attention over (..., H, N, hd) Q/K/V, with an
    optional additive bias, routed as the JAX lowering routes it (see the
    module docstring). Native-layout operands ((B, N, H, hd), marked
    `q_native` / `k_native` / `v_native` by the fusion pass) go to the
    library attention as they are; batch-1 K/V against a batched query are
    broadcast; `out_shape` reshapes the (B, N, H, hd) result."""
    q, k, v = (ctx.get(node.inputs[i]) for i in range(3))
    scale = float(node.attr("scale", 1.0))
    bias = ctx.get(node.inputs[3]) if len(node.inputs) > 3 and node.inputs[3] else None
    native = [bool(node.attr(f"{n}_native", 0)) for n in "qkv"]
    if any(native):
        qt, kt, vt = (t if nat else t.transpose(1, 2) for t, nat in zip((q, k, v), native))
        b = qt.shape[0]
        kt, vt = (t.expand((b,) + tuple(t.shape[1:])) if t.shape[0] == 1 and b != 1 else t
                  for t in (kt, vt))
        out = _library_attention(qt, kt, vt, bias, scale)
        out_shape = node.attr("out_shape")
        out = (out.reshape([int(d) for d in out_shape]) if out_shape is not None
               else out.transpose(1, 2))
        ctx.set(node.outputs[0], out.to(q.dtype))
        return
    use_pallas = bool(ctx.config is not None and getattr(ctx.config, "use_pallas", False))
    four = q.dim() == 4 and bias is None
    if four and ((q.shape[2] >= 2048 and q.shape[-1] >= 64)
                 or (use_pallas and q.shape[2] >= 512)):
        out = flash_attention(q, k, v, scale=scale)
    elif four and use_pallas and q.shape == k.shape == v.shape:
        out = short_attention(q, k, v, scale=scale)
    elif q.dim() == 4:
        out = _library_attention(*(t.transpose(1, 2) for t in (q, k, v)), bias,
                                 scale).transpose(1, 2)
    elif q.dim() == 3:  # (B, N, hd): one head
        out = _library_attention(q[:, :, None], k[:, :, None], v[:, :, None], bias,
                                 scale)[:, :, 0]
    else:
        raise NotSupportedError(f"FusedAttention rank {q.dim()}")
    ctx.set(node.outputs[0], out.to(q.dtype))


@register("FusedQKVAttention")
def fused_qkv_attention(ctx: Ctx, node: Node):
    """Attention over a packed (B, N, 3D) QKV tensor ([q | k | v] on the
    last axis, heads (H, hd) within each), by the library attention, as the
    JAX lowering calls `jax.nn.dot_product_attention`."""
    x = ctx.get(node.inputs[0])
    h = int(node.attr("num_heads"))
    scale = float(node.attr("scale", 1.0))
    b, n, three_d = x.shape
    d = three_d // 3
    q, k, v = (x[..., i * d:(i + 1) * d].reshape(b, n, h, d // h) for i in range(3))
    out = _library_attention(q, k, v, None, scale)
    ctx.set(node.outputs[0], out.reshape(b, n, d).to(x.dtype))


def _params(ctx: Ctx, node: Node, positions, x: torch.Tensor) -> list[torch.Tensor]:
    """The small f32 operands of a block kernel, flat: as stored when they
    share one dtype, f32 or x's (the kernel reads either in f32), else in
    f32."""
    params = [ctx.get(node.inputs[i]).reshape(-1).contiguous() for i in positions]
    if len({t.dtype for t in params}) > 1 or params[0].dtype not in (torch.float32, x.dtype):
        params = [t.float() for t in params]
    return params


@register("VitAttnBlock")
def vit_attn_block(ctx: Ctx, node: Node):
    """LN -> packed QKV projection -> per-head attention -> projection + bias,
    in the port's kernel (the residual stays outside: the next
    Add/SkipLayerNormalization takes it). Inputs: x, LN gamma and beta, the
    packed QKV weight and bias, w_proj, b_proj and an optional key mask;
    attributes num_heads, scale (0.0: 1/sqrt(hd)), epsilon, pre_ln,
    mask_filter."""
    x = ctx.get(node.inputs[0]).contiguous()
    g, b, bpk, bp = _params(ctx, node, (1, 2, 4, 6), x)
    wpk = ctx.get(node.inputs[3]).to(x.dtype).contiguous()
    wp = ctx.get(node.inputs[5]).to(x.dtype).contiguous()
    mask = ctx.get(node.inputs[7]) if len(node.inputs) > 7 and node.inputs[7] else None
    if mask is not None:
        mask = (mask.reshape(-1).to(torch.int32) if mask.dim() == 1
                else mask.float()).contiguous()
    out = vit_attention_block(
        x, g, b, wpk, bpk, wp, bp, mask, heads=int(node.attr("num_heads")),
        scale=float(node.attr("scale", 1.0)), eps=float(node.attr("epsilon", 1e-5)),
        residual=False, pre_ln=bool(node.attr("pre_ln", 1)),
        mask_filter=float(node.attr("mask_filter", -10000.0)))
    ctx.set(node.outputs[0], out)


@register("MlpBlock")
def mlp_block_op(ctx: Ctx, node: Node):
    """[LN ->] FC1 -> GELU -> FC2 [+ residual] in the port's kernel. Inputs:
    x, LN gamma and beta, W1 (D, F), b1, W2 (F, D), b2; attributes
    epsilon, approximate, residual, pre_ln."""
    x = ctx.get(node.inputs[0]).contiguous()
    g, b, b1, b2 = _params(ctx, node, (1, 2, 4, 6), x)
    w1 = ctx.get(node.inputs[3]).to(x.dtype).contiguous()
    w2 = ctx.get(node.inputs[5]).to(x.dtype).contiguous()
    out = mlp_block(x, g, b, w1, b1, w2, b2, eps=float(node.attr("epsilon", 1e-5)),
                    approximate=bool(node.attr("approximate", 0)),
                    residual=bool(node.attr("residual", 1)),
                    pre_ln=bool(node.attr("pre_ln", 1)))
    ctx.set(node.outputs[0], out)


@register("CrossAttnBlock")
def cross_attn_block_op(ctx: Ctx, node: Node):
    """q projection -> per-head attention against the folded constant k/v ->
    output projection + bias, in the port's kernel. Inputs: x (B, N, D), Wq,
    k and v (Bk, heads, S, hd), Wp, bp; attributes num_heads, scale (0.0:
    1/sqrt(hd))."""
    x = ctx.get(node.inputs[0]).contiguous()
    wq, k, v, wp = (ctx.get(node.inputs[i]).to(x.dtype).contiguous() for i in (1, 2, 3, 4))
    (bp,) = _params(ctx, node, (5,), x)
    out = cross_attn_block(x, wq, k, v, wp, bp, heads=int(node.attr("num_heads")),
                           scale=float(node.attr("scale", 0.0)) or None)
    ctx.set(node.outputs[0], out)


@register("ConvNeXtBlock")
def convnext_block_op(ctx: Ctx, node: Node):
    """dw7x7 -> LN -> FC1 -> GELU -> FC2 -> layer scale -> residual on NHWC x,
    in the port's kernel. Inputs: x, the (7, 7, 1, C) depthwise weight and
    its bias, LN gamma and beta, W1 (C, F), b1, W2 (F, C), b2, gamma;
    attribute epsilon."""
    x = ctx.get(node.inputs[0]).contiguous()
    dw, w1, w2 = (ctx.get(node.inputs[i]).to(x.dtype).contiguous() for i in (1, 5, 7))
    db, g, b, b1, b2, gm = _params(ctx, node, (2, 3, 4, 6, 8, 9), x)
    out = convnext_block(x, dw, db, g, b, w1, b1, w2, b2, gm,
                         eps=float(node.attr("epsilon", 1e-6)))
    ctx.set(node.outputs[0], out)
