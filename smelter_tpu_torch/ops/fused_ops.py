"""Fused op lowerings: FusedDequantMatMul, FusedDequantMatMulI4,
RaggedDecodeAttention, PagedDecodeAttention, PagedCacheUpdate.

`passes/fuse_dequant.py` rewrites DequantizeLinear(int8 W, scales) ->
MatMul/Gemm into FusedDequantMatMul(x, W (K, N) int8, scales (N,)), and the
grouped 4-bit form into FusedDequantMatMulI4(x, packed (K/2, N), scales
(K/g, N)). Their lowerings always go to the port's kernels:
`dequant_matmul` (or `int8_matmul` after `quantize_rows` when
`Config.int8_activations` is set) and `int4_matmul`. The paged decode step
(`models/llama_style.py::build_decode_step_paged`) reads its KV pools
through `paged_decode_attention` and writes them with `paged_cache_update`,
in place. The static-cache step (`build_decode_step` after
`passes/ragged_attention.py`, which `Config.ragged_attention` applies)
reads its caches through `ragged_decode_attention`. Each kernel wrapper
launches its Hopper kernel for CUDA tensors and takes its plain version on
the CPU and on `meta`: there is no envelope gate that takes the dense chain
on the card, as the JAX package's TPU gate (`_ragged_kernel_ok`) does. `Config.use_pallas`
and `Config.int4_block_n` are kept so configurations carry across from the
JAX package; the port reads neither.
"""

from __future__ import annotations

from ..ir.graph import Node
from ..kernels.dequant_matmul import dequant_matmul
from ..kernels.int4_matmul import int4_matmul
from ..kernels.int8_matmul import dequant_matmul_int8
from ..kernels.paged_decode_attention import paged_cache_update, paged_decode_attention
from ..kernels.ragged_decode_attention import ragged_decode_attention
from .registry import Ctx, register


@register("FusedDequantMatMul")
def fused_dequant_matmul(ctx: Ctx, node: Node):
    x = ctx.get(node.inputs[0])
    q = ctx.get(node.inputs[1])
    s = ctx.get(node.inputs[2])
    cfg = ctx.config
    int8_acts = bool(cfg is not None and getattr(cfg, "int8_activations", False))
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    fn = dequant_matmul_int8 if int8_acts else dequant_matmul
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
