"""LLaMA-family decoder (RMSNorm + rotary + grouped-query attention +
SwiGLU), built as ONNX graphs in primitive ops plus the port's fused ops.

The port's copy of `smelter_tpu/models/llama_style.py` (numpy only), node
for node the same graphs:

- ``make_weights``: seeded-random weights (no pretrained weights exist
  here);
- ``build_full``: full-sequence causal forward in the contrib-op
  vocabulary (SimplifiedLayerNormalization, SkipSimplifiedLayerNormalization,
  RotaryEmbedding, GroupQueryAttention); with ``cache_max_len`` it also
  emits the filled KV caches, which is ``build_prefill``, the prefill graph
  the generators and servers admit prompts with;
- ``build_decode_step``: batch-1 static-KV-cache step graph (ScatterND
  cache writes at a traced position, broadcast GQA head sharing), which
  ``runtime/generate.py`` and ``serving/decode_server.py`` run;
- ``build_decode_step_paged``: the batched paged-pool step graph that
  ``serving/paged_server.py`` runs (PagedCacheUpdate writes,
  PagedDecodeAttention reads).
"""

from __future__ import annotations

import numpy as np

from ..ir.build import GraphBuilder
from ..utils import dtypes as dt
from ._util import rand_weight as _w, rename_edges


def _rope_caches(max_len: int, hd: int, base: float = 10000.0):
    inv = 1.0 / base ** (np.arange(0, hd, 2, dtype=np.float64) / hd)
    ang = np.arange(max_len, dtype=np.float64)[:, None] * inv[None]
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def make_weights(vocab: int = 96, dim: int = 64, heads: int = 4,
                 kv_heads: int = 2, ffn: int = 128, layers: int = 2,
                 max_len: int = 32, seed: int = 0,
                 n_experts: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    hd = dim // heads
    kvd = kv_heads * hd
    w = {"wte": _w(rng, vocab, dim, scale=0.05),
         "w_head": _w(rng, dim, vocab),
         "norm_f": np.ones(dim, np.float32)}
    w["cos"], w["sin"] = _rope_caches(max_len, hd)
    for li in range(layers):
        w[f"norm1_{li}"] = np.ones(dim, np.float32)
        w[f"norm2_{li}"] = np.ones(dim, np.float32)
        w[f"wq_{li}"] = _w(rng, dim, dim)
        w[f"wk_{li}"] = _w(rng, dim, kvd)
        w[f"wv_{li}"] = _w(rng, dim, kvd)
        w[f"wo_{li}"] = _w(rng, dim, dim)
        if n_experts:
            w[f"wrouter_{li}"] = _w(rng, dim, n_experts)
            w[f"moe_w1_{li}"] = np.stack(
                [_w(rng, dim, ffn) for _ in range(n_experts)])
            w[f"moe_w2_{li}"] = np.stack(
                [_w(rng, ffn, dim) for _ in range(n_experts)])
            w[f"moe_w3_{li}"] = np.stack(
                [_w(rng, dim, ffn) for _ in range(n_experts)])
        else:
            w[f"wgate_{li}"] = _w(rng, dim, ffn)
            w[f"wup_{li}"] = _w(rng, dim, ffn)
            w[f"wdown_{li}"] = _w(rng, ffn, dim)
    return w


def _emit_row_quant(b, x, c: int):
    """Per-row symmetric int8 quantization of (c, kvd) rows: returns
    (q int8 (c, kvd), s f32-domain (c, 1)). The int8-KV-cache recipe —
    halves cache HBM (capacity AND long-context decode traffic)."""
    ab = b.node("Abs", [x])
    amax = b.node("ReduceMax", [ab], axes=[-1], keepdims=1)   # (c, 1)
    s = b.node("Div", [amax, b.init(np.float32(127.0))])
    s = b.node("Max", [s, b.init(np.float32(1e-8))])
    q = b.node("Div", [x, s])
    q = b.node("Round", [q])
    q = b.node("Clip", [q, b.init(np.float32(-127.0)),
                        b.init(np.float32(127.0))])
    q = b.node("Cast", [q], to=dt.INT8)
    return q, s


def _emit_mlp(b, weights, li, h2, top_k: int = 2):
    """SwiGLU MLP, or — when the weight dict holds expert stacks — a
    Mixtral-style MoE block via the contrib MoE op (softmax-top-k routing,
    gated swiglu experts; ops/contrib_ops.py::moe_contrib).

    Weight initializers are named by their weight-dict key so the decode
    step and the prefill graph built from one dict share initializer
    names — FusedGenerator reuses one device copy for both (critical at
    multi-GB quantized sizes)."""
    if f"moe_w1_{li}" in weights:
        router = b.node("MatMul", [h2, b.init(weights[f"wrouter_{li}"],
                                              f"wrouter_{li}")])
        return b.node("MoE",
                      [h2, router,
                       b.init(weights[f"moe_w1_{li}"], f"moe_w1_{li}"), "",
                       b.init(weights[f"moe_w2_{li}"], f"moe_w2_{li}"), "",
                       b.init(weights[f"moe_w3_{li}"], f"moe_w3_{li}")],
                      k=top_k, activation_type="swiglu",
                      normalize_routing_weights=1)
    gate = b.node("MatMul", [h2, b.init(weights[f"wgate_{li}"],
                                        f"wgate_{li}")])
    sg = b.node("Sigmoid", [gate])
    silu = b.node("Mul", [gate, sg])
    up = b.node("MatMul", [h2, b.init(weights[f"wup_{li}"], f"wup_{li}")])
    prod = b.node("Mul", [silu, up])
    return b.node("MatMul", [prod, b.init(weights[f"wdown_{li}"],
                                          f"wdown_{li}")])


def build_full(weights: dict, seq_len: int, vocab: int = 96, dim: int = 64,
               heads: int = 4, kv_heads: int = 2, ffn: int = 128,
               layers: int = 2, moe_top_k: int = 2,
               cache_max_len: int | None = None, kv_quant: bool = False):
    """tokens (T,) -> logits (T, vocab), causal, contrib-op vocabulary.

    With ``cache_max_len`` the graph additionally emits the filled KV
    caches (k_out_li/v_out_li, each (cache_max_len, kvd): rotary-applied
    K rows / raw V rows for positions < T, zeros beyond) — the PREFILL
    form FusedGenerator seeds its decode scan with. Same row layout as
    build_decode_step's ScatterND writes, so decode continues the
    sequence exactly."""
    hd = dim // heads
    kvd = kv_heads * hd
    b = GraphBuilder("llama_full", opset=17)
    tokens = b.input("tokens", (seq_len,), dt.INT64)
    cos, sin = (b.init(weights["cos"], "rope_cos"),
                b.init(weights["sin"], "rope_sin"))
    pos = b.init(np.arange(seq_len, dtype=np.int64)[None], "pos_ids")  # (1,T)
    x = b.node("Gather", [b.init(weights["wte"], "wte"), tokens], axis=0)
    x = b.node("Reshape", [x, b.init(np.array([1, seq_len, dim], np.int64))])
    residual = x
    cache_outs: list[str] = []
    for li in range(layers):
        h = b.node("SimplifiedLayerNormalization",
                   [residual, b.init(weights[f"norm1_{li}"], f"norm1_{li}")],
                   axis=-1, epsilon=1e-6)
        q = b.node("MatMul", [h, b.init(weights[f"wq_{li}"], f"wq_{li}")])
        k = b.node("MatMul", [h, b.init(weights[f"wk_{li}"], f"wk_{li}")])
        v = b.node("MatMul", [h, b.init(weights[f"wv_{li}"], f"wv_{li}")])
        q = b.node("RotaryEmbedding", [q, pos, cos, sin], num_heads=heads)
        k = b.node("RotaryEmbedding", [k, pos, cos, sin], num_heads=kv_heads)
        if kv_quant:
            # attend the SAME quantize-dequantize K/V the decode step will
            # read from the int8 cache — otherwise prefill-seeded and
            # scan-path generations diverge on near-tie logits (measured
            # ~3.5% first-token flips with fp-attention prefill)
            sh2d = b.init(np.array([seq_len, kvd], np.int64),
                          f"kv2d_shape_{li}")
            sh3d = b.init(np.array([1, seq_len, kvd], np.int64),
                          f"kv3d_shape_{li}")
            k2d = b.node("Reshape", [k, sh2d])
            v2d = b.node("Reshape", [v, sh2d])
            kq2, ks2 = _emit_row_quant(b, k2d, seq_len)
            vq2, vs2 = _emit_row_quant(b, v2d, seq_len)
            # CastLike (not Cast-to-FLOAT): the dequant must stay in the
            # runtime compute dtype, or f32 contaminates every layer
            # downstream and the step/prefill dtype flows diverge
            k = b.node("Reshape", [b.node("Mul", [
                b.node("CastLike", [kq2, k2d]), ks2]), sh3d])
            v = b.node("Reshape", [b.node("Mul", [
                b.node("CastLike", [vq2, v2d]), vs2]), sh3d])
        att = b.node("GroupQueryAttention", [q, k, v],
                     num_heads=heads, kv_num_heads=kv_heads)
        proj = b.node("MatMul", [att, b.init(weights[f"wo_{li}"], f"wo_{li}")])
        if cache_max_len is not None:
            pad = b.init(np.array([0, 0, cache_max_len - seq_len, 0],
                                  np.int64), f"cache_pad_{li}")
            if kv_quant:
                for nm, qv, sv in ((f"k_out_{li}", kq2, ks2),
                                   (f"v_out_{li}", vq2, vs2)):
                    b.node("Pad", [qv, pad], outputs=[nm])
                    b.node("Pad", [sv, pad],
                           outputs=[nm.replace("_out_", "_scale_out_")])
                    cache_outs += [nm, nm.replace("_out_", "_scale_out_")]
            else:
                for nm, t3 in ((f"k_out_{li}", k), (f"v_out_{li}", v)):
                    t2 = b.node("Reshape",
                                [t3, b.init(np.array([seq_len, kvd],
                                                     np.int64),
                                            f"kv2d_shape_{li}_{nm[0]}")])
                    b.node("Pad", [t2, pad], outputs=[nm])
                    cache_outs.append(nm)
        # SkipSimplifiedLayerNormalization: output 0 feeds the MLP, output 3
        # (input+skip sum) is the next residual — the ORT-genai pattern.
        outs = b.node("SkipSimplifiedLayerNormalization",
                      [proj, residual,
                       b.init(weights[f"norm2_{li}"], f"norm2_{li}")],
                      outputs=[f"mlp_in_{li}", "", "", f"res2_{li}"],
                      epsilon=1e-6)
        h2, res2 = outs[0], outs[3]
        down = _emit_mlp(b, weights, li, h2, top_k=moe_top_k)
        residual = b.node("Add", [down, res2])
    xf = b.node("SimplifiedLayerNormalization",
                [residual, b.init(weights["norm_f"], "norm_f")],
                axis=-1, epsilon=1e-6)
    logits = b.node("MatMul", [xf, b.init(weights["w_head"], "w_head")])
    logits = b.node("Reshape",
                    [logits, b.init(np.array([seq_len, vocab], np.int64))])
    return b.finish([logits] + cache_outs)


def build_prefill(weights: dict, prompt_len: int, max_len: int = 32,
                  **cfg):
    """Prefill graph: tokens (prompt_len,) -> (logits (prompt_len, vocab),
    k_out_i/v_out_i caches (max_len, kvd)) — one full-sequence forward
    fills the KV caches at MXU rates instead of prompt_len scan steps
    each re-reading every weight (the standard serving prefill/decode
    split; reference scope: none)."""
    return build_full(weights, seq_len=prompt_len, cache_max_len=max_len,
                      **cfg)


def build_decode_step(weights: dict | None = None, vocab: int = 96,
                      dim: int = 64, heads: int = 4, kv_heads: int = 2,
                      ffn: int = 128, layers: int = 2, max_len: int = 32,
                      seed: int = 0, moe_top_k: int = 2, chunk: int = 1,
                      kv_quant: bool = False):
    """(token (chunk,), pos (1,), k_cache_i/v_cache_i (max_len, kvd)) ->
    (logits (chunk, vocab), updated caches). FusedGenerator-compatible
    at chunk=1; chunk>1 is the VERIFY step of speculative decoding
    (runtime/speculative.py): `chunk` consecutive tokens starting at
    position `pos` are processed in one causal forward — the cache rows
    for all `chunk` positions are written before attention reads them,
    and row i attends positions <= pos+i, so stale rows from rejected
    speculation are never visible.

    kv_quant=True stores the caches as int8 with per-row scales
    (k_cache_scale_i/v_cache_scale_i inputs, *_scale_out outputs):
    halves cache HBM — long-context capacity AND decode traffic — at
    ~0.4%/element cache rounding."""
    if weights is None:
        weights = make_weights(vocab, dim, heads, kv_heads, ffn, layers,
                               max_len, seed)
    hd = dim // heads
    kvd = kv_heads * hd
    g = heads // kv_heads
    c = chunk
    b = GraphBuilder("llama_step" if c == 1 else f"llama_chunk{c}",
                     opset=17)
    token = b.input("token", (c,), dt.INT64)
    pos = b.input("pos", (1,), dt.INT64)
    cos, sin = (b.init(weights["cos"], "rope_cos"),
                b.init(weights["sin"], "rope_sin"))
    pos2 = b.node("Reshape", [pos, b.init(np.array([1, 1], np.int64))])
    if c > 1:  # rotary positions pos..pos+c-1, shape (1, c)
        pos2 = b.node("Add", [pos2, b.init(
            np.arange(c, dtype=np.int64)[None], "chunk_arange2")])
    x = b.node("Gather", [b.init(weights["wte"], "wte"), token], axis=0)  # (c,dim)
    cache_outs = []
    for li in range(layers):
        if kv_quant:
            k_cache = b.input(f"k_cache_{li}", (max_len, kvd), dt.INT8)
            k_cs = b.input(f"k_cache_scale_{li}", (max_len, 1))
            v_cache = b.input(f"v_cache_{li}", (max_len, kvd), dt.INT8)
            v_cs = b.input(f"v_cache_scale_{li}", (max_len, 1))
        else:
            k_cache = b.input(f"k_cache_{li}", (max_len, kvd))
            v_cache = b.input(f"v_cache_{li}", (max_len, kvd))
        h = b.node("SimplifiedLayerNormalization",
                   [x, b.init(weights[f"norm1_{li}"], f"norm1_{li}")],
                   axis=-1, epsilon=1e-6)
        q = b.node("MatMul", [h, b.init(weights[f"wq_{li}"], f"wq_{li}")])
        k = b.node("MatMul", [h, b.init(weights[f"wk_{li}"], f"wk_{li}")])
        v = b.node("MatMul", [h, b.init(weights[f"wv_{li}"], f"wv_{li}")])
        q3 = b.node("Reshape", [q, b.init(np.array([1, c, dim], np.int64))])
        k3 = b.node("Reshape", [k, b.init(np.array([1, c, kvd], np.int64))])
        q3 = b.node("RotaryEmbedding", [q3, pos2, cos, sin], num_heads=heads)
        k3 = b.node("RotaryEmbedding", [k3, pos2, cos, sin], num_heads=kv_heads)
        q = b.node("Reshape", [q3, b.init(np.array([c, dim], np.int64))])
        k = b.node("Reshape", [k3, b.init(np.array([c, kvd], np.int64))])
        idx = b.node("Reshape", [pos, b.init(np.array([1, 1], np.int64))])
        if c > 1:  # scatter rows pos..pos+c-1, indices (c, 1)
            idx = b.node("Add", [idx, b.init(
                np.arange(c, dtype=np.int64)[:, None], "chunk_arange_col")])
        if kv_quant:
            # int8 KV cache: quantize the new rows, scatter q + scale,
            # dequantize the WHOLE cache for attention (the convert+mul
            # fuses into the attention matmul's operand stream — traffic
            # stays int8 + one scale column)
            kq, ks = _emit_row_quant(b, k, c)
            vq, vs = _emit_row_quant(b, v, c)
            k_upd = b.node("ScatterND", [k_cache, idx, kq])
            ks_upd = b.node("ScatterND", [k_cs, idx, ks])
            v_upd = b.node("ScatterND", [v_cache, idx, vq])
            vs_upd = b.node("ScatterND", [v_cs, idx, vs])
            cache_outs += [(f"k_out_{li}", k_upd),
                           (f"k_scale_out_{li}", ks_upd),
                           (f"v_out_{li}", v_upd),
                           (f"v_scale_out_{li}", vs_upd)]
            # CastLike keeps the dequant in the compute dtype (see the
            # build_full twin) — Cast-to-FLOAT would poison the residual
            # stream to f32 from the first attention on
            k_upd = b.node("Mul", [b.node("CastLike", [k_upd, k]),
                                   ks_upd])
            v_upd = b.node("Mul", [b.node("CastLike", [v_upd, v]),
                                   vs_upd])
        else:
            k_upd = b.node("ScatterND", [k_cache, idx, k])
            v_upd = b.node("ScatterND", [v_cache, idx, v])
            cache_outs += [(f"k_out_{li}", k_upd), (f"v_out_{li}", v_upd)]
        # GQA: (kvh, g, c, hd) @ (kvh, 1, hd, max_len) broadcast batch matmul
        if c == 1:
            qh = b.node("Reshape", [q, b.init(
                np.array([kv_heads, g, 1, hd], np.int64))])
        else:
            qh = b.node("Reshape", [q, b.init(
                np.array([c, kv_heads, g, hd], np.int64))])
            qh = b.node("Transpose", [qh], perm=[1, 2, 0, 3])
        kh = b.node("Reshape", [k_upd, b.init(np.array([max_len, kv_heads, 1, hd], np.int64))])
        kh = b.node("Transpose", [kh], perm=[1, 2, 3, 0])   # (kvh,1,hd,max)
        vh = b.node("Reshape", [v_upd, b.init(np.array([max_len, kv_heads, 1, hd], np.int64))])
        vh = b.node("Transpose", [vh], perm=[1, 2, 0, 3])   # (kvh,1,max,hd)
        scores = b.node("MatMul", [qh, kh])                 # (kvh,g,c,max)
        scores = b.node("Mul", [scores, b.init(np.float32(hd ** -0.5))])
        arange = b.init(np.arange(max_len, dtype=np.int64), f"ar_{li}")
        if c == 1:
            valid = b.node("LessOrEqual", [arange, pos])    # (max,)
        else:  # row i attends positions <= pos+i: (c, max)
            rowpos = b.node("Add", [b.node("Reshape", [pos, b.init(
                np.array([1, 1], np.int64), "pos11")]),
                b.init(np.arange(c, dtype=np.int64)[:, None],
                       "chunk_arange_col2")])               # (c,1)
            valid = b.node("LessOrEqual", [arange, rowpos])
        mask = b.node("Where", [valid, b.init(np.float32(0.0)),
                                b.init(np.float32(-1e9))])
        scores = b.node("Add", [scores, mask])
        attn = b.node("Softmax", [scores], axis=-1)
        ctxv = b.node("MatMul", [attn, vh])                 # (kvh,g,c,hd)
        if c > 1:
            ctxv = b.node("Transpose", [ctxv], perm=[2, 0, 1, 3])
        ctxv = b.node("Reshape", [ctxv, b.init(np.array([c, dim], np.int64))])
        proj = b.node("MatMul", [ctxv, b.init(weights[f"wo_{li}"], f"wo_{li}")])
        x = b.node("Add", [x, proj])
        h2 = b.node("SimplifiedLayerNormalization",
                    [x, b.init(weights[f"norm2_{li}"], f"norm2_{li}")],
                    axis=-1, epsilon=1e-6)
        down = _emit_mlp(b, weights, li, h2, top_k=moe_top_k)
        x = b.node("Add", [x, down])
    xf = b.node("SimplifiedLayerNormalization",
                [x, b.init(weights["norm_f"], "norm_f")],
                axis=-1, epsilon=1e-6)
    logits = b.node("MatMul", [xf, b.init(weights["w_head"], "w_head")])
    rename_edges(b.graph, cache_outs)
    return b.finish([logits] + [n for n, _ in cache_outs]), weights


def build_decode_step_paged(weights: dict | None = None, vocab: int = 96,
                            dim: int = 64, heads: int = 4,
                            kv_heads: int = 2, ffn: int = 128,
                            layers: int = 2, seed: int = 0,
                            moe_top_k: int = 2, chunk: int = 1,
                            kv_quant: bool = False, *,
                            slots: int, page_size: int, n_pages: int,
                            npg: int):
    """BATCHED paged decode step: (token (B, c), pos (B,), page_table
    (B, npg), k_pool_i/v_pool_i (n_pages, page_size, kvd)) -> (logits
    (B, c, vocab), updated pools). The paged-pool twin of
    ``build_decode_step``: the KV pools are SHARED across slots (one
    device buffer, page-table indirection — kernels/
    paged_decode_attention.py), so the step graph is built batched
    instead of being vmapped by the server; cache rows are written by
    PagedCacheUpdate and attention reads only each slot's live pages
    via PagedDecodeAttention (ops/fused_ops.py). Rotary positions are
    per-slot (pos[:, None] + arange(c)). Dead slots rely on the
    PagePool scratch-page discipline (serving/kv_pool.py) — their table
    rows point at the reserved page 0, so their writes are harmless.

    kv_quant=True stores the pools as int8 with per-row f32 scale pools
    (k_scale_pool_i/v_scale_pool_i, (n_pages, page_size, 1)): this
    step's rows are row-quantized before the paged write and the
    attention op reads the int8 pools directly (the kernel dequantizes
    each row as it reads it): the int8-KV capacity recipe composed with
    paging.

    Per-slot logical length is bounded by npg*page_size (rope caches
    must cover it)."""
    max_len = n_pages * page_size
    if weights is None:
        weights = make_weights(vocab, dim, heads, kv_heads, ffn, layers,
                               max_len, seed)
    if weights["cos"].shape[0] < npg * page_size:
        raise ValueError("rope caches shorter than npg*page_size")
    hd = dim // heads
    kvd = kv_heads * hd
    c = chunk
    B = slots
    b = GraphBuilder(f"llama_paged_b{B}", opset=17)
    token = b.input("token", (B, c), dt.INT64)
    pos = b.input("pos", (B,), dt.INT64)
    table = b.input("page_table", (B, npg), dt.INT32)
    cos, sin = (b.init(weights["cos"], "rope_cos"),
                b.init(weights["sin"], "rope_sin"))
    # rotary position ids (B, c) = pos[:, None] + arange(c)
    posc = b.node("Reshape", [pos, b.init(np.array([B, 1], np.int64))])
    posc = b.node("Add", [posc, b.init(
        np.arange(c, dtype=np.int64)[None], "paged_arange_row")])
    x = b.node("Gather", [b.init(weights["wte"], "wte"), token],
               axis=0)                                      # (B, c, dim)
    pool_outs = []
    for li in range(layers):
        if kv_quant:
            k_pool = b.input(f"k_pool_{li}", (n_pages, page_size, kvd),
                             dt.INT8)
            ks_pool = b.input(f"k_scale_pool_{li}",
                              (n_pages, page_size, 1))
            v_pool = b.input(f"v_pool_{li}", (n_pages, page_size, kvd),
                             dt.INT8)
            vs_pool = b.input(f"v_scale_pool_{li}",
                              (n_pages, page_size, 1))
        else:
            k_pool = b.input(f"k_pool_{li}", (n_pages, page_size, kvd))
            v_pool = b.input(f"v_pool_{li}", (n_pages, page_size, kvd))
        h = b.node("SimplifiedLayerNormalization",
                   [x, b.init(weights[f"norm1_{li}"], f"norm1_{li}")],
                   axis=-1, epsilon=1e-6)
        q = b.node("MatMul", [h, b.init(weights[f"wq_{li}"], f"wq_{li}")])
        k = b.node("MatMul", [h, b.init(weights[f"wk_{li}"], f"wk_{li}")])
        v = b.node("MatMul", [h, b.init(weights[f"wv_{li}"], f"wv_{li}")])
        q = b.node("RotaryEmbedding", [q, posc, cos, sin],
                   num_heads=heads)                         # (B, c, dim)
        k = b.node("RotaryEmbedding", [k, posc, cos, sin],
                   num_heads=kv_heads)                      # (B, c, kvd)
        if kv_quant:
            kq, ksr = _emit_row_quant(b, k, c)
            vq, vsr = _emit_row_quant(b, v, c)
            k_upd = b.node("PagedCacheUpdate", [k_pool, table, pos, kq])
            ks_upd = b.node("PagedCacheUpdate",
                            [ks_pool, table, pos, ksr])
            v_upd = b.node("PagedCacheUpdate", [v_pool, table, pos, vq])
            vs_upd = b.node("PagedCacheUpdate",
                            [vs_pool, table, pos, vsr])
            pool_outs += [(f"k_pool_out_{li}", k_upd),
                          (f"k_scale_pool_out_{li}", ks_upd),
                          (f"v_pool_out_{li}", v_upd),
                          (f"v_scale_pool_out_{li}", vs_upd)]
            attn_in = [q, k_upd, ks_upd, v_upd, vs_upd, table, pos]
        else:
            k_upd = b.node("PagedCacheUpdate", [k_pool, table, pos, k])
            v_upd = b.node("PagedCacheUpdate", [v_pool, table, pos, v])
            pool_outs += [(f"k_pool_out_{li}", k_upd),
                          (f"v_pool_out_{li}", v_upd)]
            attn_in = [q, k_upd, v_upd, table, pos]
        ctxv = b.node("PagedDecodeAttention", attn_in,
                      num_heads=heads, kv_heads=kv_heads, chunk=c,
                      scale=hd ** -0.5)                     # (B, c, dim)
        proj = b.node("MatMul", [ctxv, b.init(weights[f"wo_{li}"],
                                              f"wo_{li}")])
        x = b.node("Add", [x, proj])
        h2 = b.node("SimplifiedLayerNormalization",
                    [x, b.init(weights[f"norm2_{li}"], f"norm2_{li}")],
                    axis=-1, epsilon=1e-6)
        down = _emit_mlp(b, weights, li, h2, top_k=moe_top_k)
        x = b.node("Add", [x, down])
    xf = b.node("SimplifiedLayerNormalization",
                [x, b.init(weights["norm_f"], "norm_f")],
                axis=-1, epsilon=1e-6)
    logits = b.node("MatMul", [xf, b.init(weights["w_head"], "w_head")])
    rename_edges(b.graph, pool_outs)
    return b.finish([logits] + [n for n, _ in pool_outs]), weights
