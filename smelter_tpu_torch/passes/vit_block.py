"""Whole-block transformer fusion passes (round 3).

Round 2 found every PARTIAL transformer kernel losing to XLA fusion
barriers; the resolution is one VMEM-resident pallas_call per block
(kernels/vit_block.py). `fuse_vit_block` matches four attention shapes:

  1. pre-LN packed-QKV (ViT/speech):  LayerNormalization -> MatMul(Wqkv
     (D,3D)) -> Add -> FusedQKVAttention -> MatMul(Wproj) -> Add
  2. post-LN ORT-contrib (BERT): Attention(x, Wqkv, bqkv [, mask]) ->
     MatMul(Wproj); masks: (B,S) keep and (B,) valid-length forms
  3. separate-projection self-attention (SD spatial transformers):
     LN -> 3x [MatMul -> Reshape] off one edge -> native FusedAttention
  4. constant-context cross-attention (folded k/v initializers) ->
     CrossAttnBlock  [OFF by default: probe63, loses 17% at S_kv=16]

QKV weights re-pack into 128-lane head GROUPS (2x hd64, 4x hd32) so
every projection is a full-width MXU matmul. Residual stays OUTSIDE
(the downstream Add/SkipLayerNormalization owns it).

All gates are MEASURED, not guessed (interleaved on-chip A/B):
tokens*dim >= 50k (`_MIN_TOKENS_X_DIM`) — ViT-B +37% (3,832 img/s),
speech encoder 5.1x, SD self-attn 1.81x; BERT-enc (N*D=33k) keeps XLA's
batched path (fused ran 75k vs 121k seq/s). `fuse_mlp_block` and
`fuse_convnext_block` live here too as measured NEGATIVE results
(win isolated, lose e2e; registered, off by default) — see
docs/BENCHMARKS.md "Whole-block transformer kernels".

Reference scope: none — no attention in the reference (SURVEY.md §5.7).
"""

from __future__ import annotations

import numpy as np

from ..ir.graph import Graph, Node
from ..kernels.vit_block import head_group
from .decoder_fusion import _ensure_types
from .pass_manager import register_pass

# Measured e2e gate (probes 52/55/56, interleaved A/B on chip): the
# per-image grid wins when each step's GEMMs are tall enough to fill the
# MXU pipeline — ViT-B (N*D = 151k) +37%, speech encoder (64k) +5x — and
# LOSES when they are tiny: BERT-encoder (N*D = 33k) ran 75k/s fused vs
# 121k/s on XLA's batched GEMMs. Gate on tokens*dim of the block input.
_MIN_TOKENS_X_DIM = 50_000
# Constant-context cross-attention variant: OFF by default — probe63
# interleaved A/B on SD-UNet b8/256px measured 1.32 ms (XLA dpa over the
# folded k/v) vs 1.55 ms fused (-17%): with S_kv=16 the per-image grid's
# tiny per-head dots cannot beat XLA's batched formulation. The kernel
# and this variant stay available for probing larger-context models.
_CROSS_ENABLED = False


def _aux_outputs_unused(graph: Graph, consumers, node, keep=()) -> bool:
    """True iff every secondary output of `node` (outputs[1:], minus
    `keep`) is unconsumed and not a graph output. Fusion deletes the
    node wholesale, so a consumed mean/inv-std edge (LayerNormalization
    outputs 1-2, SkipLayerNormalization outputs 1-3) must block the
    match or it would dangle."""
    graph_outs = {v.name for v in graph.outputs}
    for o in node.outputs[1:]:
        if o and o not in keep and (consumers.get(o) or o in graph_outs):
            return False
    return True


def _tokens_dim(graph: Graph, edge: str):
    t = graph.value_types.get(edge)
    if t is None or t.shape is None or len(t.shape) != 3:
        return None
    n, d = t.shape[1], t.shape[2]
    if not (isinstance(n, int) and isinstance(d, int)):
        return None
    return n * d


def pack_qkv_weights(w_qkv, b_qkv, heads: int):
    """(D, 3D) packed [q|k|v] + (3D,) bias -> per-head-GROUP blocks:
    weights (3*n_groups, D, group*hd) ordered [q_g0, k_g0, v_g0, q_g1, ...],
    bias (1, 3*n_groups, group*hd)."""
    D = w_qkv.shape[0]
    hd = D // heads
    group = head_group(heads, hd)
    wq, wk, wv = (w_qkv[:, i * D:(i + 1) * D] for i in range(3))
    bq, bk, bv = (b_qkv[i * D:(i + 1) * D] for i in range(3))
    ws, bs = [], []
    for p in range(heads // group):
        sl = slice(group * p * hd, group * (p + 1) * hd)
        ws += [wq[:, sl], wk[:, sl], wv[:, sl]]
        bs += [bq[sl], bk[sl], bv[sl]]
    return np.stack(ws, 0), np.stack(bs, 0)[None]


@register_pass("fuse_vit_block")
def fuse_vit_block(graph: Graph) -> int:

    if not _ensure_types(graph):
        return 0
    producers = graph.producers()
    consumers = graph.consumers()
    changed = 0
    dead: set[int] = set()

    def sole(edge: str) -> bool:
        return len(consumers.get(edge, [])) == 1

    for att in list(graph.find_nodes("FusedQKVAttention")):
        if id(att) in dead:
            continue
        heads = int(att.attr("num_heads", 0))
        # -- upstream: Add(bias) <- MatMul(Wqkv) <- LayerNormalization ----
        badd = producers.get(att.inputs[0])
        if (badd is None or badd.op_type != "Add"
                or not sole(att.inputs[0])):
            continue
        bq_name = badd.inputs[1] if badd.inputs[1] in graph.initializers \
            else badd.inputs[0]
        x_mm = badd.inputs[0] if bq_name == badd.inputs[1] else badd.inputs[1]
        if bq_name not in graph.initializers:
            continue
        mm = producers.get(x_mm)
        if (mm is None or mm.op_type != "MatMul" or not sole(x_mm)
                or mm.inputs[1] not in graph.initializers):
            continue
        wq_name = mm.inputs[1]
        wqkv = graph.initializers[wq_name]
        if wqkv.ndim != 2 or wqkv.shape[1] != 3 * wqkv.shape[0]:
            continue
        d = int(wqkv.shape[0])
        hd = d // heads if heads else 0
        if (heads <= 0 or d % heads or hd == 0 or 128 % hd
                or (heads * hd) % 128):
            continue  # kernel layout wants whole 128-lane head groups
        ln = producers.get(mm.inputs[0])
        if (ln is None or ln.op_type != "LayerNormalization"
                or not sole(mm.inputs[0])
                or ln.inputs[1] not in graph.initializers
                or ln.inputs[2] not in graph.initializers
                or ln.attr("axis", -1) not in (-1, 2)
                or not _aux_outputs_unused(graph, consumers, ln)):
            continue
        nd = _tokens_dim(graph, ln.inputs[0])
        if nd is None or nd < _MIN_TOKENS_X_DIM:
            continue  # per-image GEMMs too small to beat XLA's batching
        # -- downstream: MatMul(Wproj) -> Add(bproj) ----------------------
        outs = consumers.get(att.outputs[0], [])
        if len(outs) != 1 or outs[0].op_type != "MatMul":
            continue
        pm = outs[0]
        if (pm.inputs[0] != att.outputs[0]
                or pm.inputs[1] not in graph.initializers):
            continue
        wp = graph.initializers[pm.inputs[1]]
        if wp.ndim != 2 or wp.shape != (d, d):
            continue
        outs2 = consumers.get(pm.outputs[0], [])
        if (len(outs2) != 1 or outs2[0].op_type != "Add"
                or not sole(pm.outputs[0])):
            continue
        padd = outs2[0]
        bp_name = padd.inputs[1] if padd.inputs[1] in graph.initializers \
            else padd.inputs[0]
        if (bp_name not in graph.initializers
                or graph.initializers[bp_name].reshape(-1).shape != (d,)):
            continue
        bq = graph.initializers[bq_name].reshape(-1)
        if bq.shape != (3 * d,):
            continue

        wpk, bpk = pack_qkv_weights(np.asarray(wqkv), np.asarray(bq), heads)
        wpk_name = graph.fresh_name(wq_name + "_pairpack")
        bpk_name = graph.fresh_name(bq_name + "_pairpack")
        graph.initializers[wpk_name] = np.ascontiguousarray(wpk)
        graph.initializers[bpk_name] = np.ascontiguousarray(bpk)

        fused = Node(
            "VitAttnBlock",
            inputs=[ln.inputs[0], ln.inputs[1], ln.inputs[2],
                    wpk_name, bpk_name, pm.inputs[1], bp_name],
            outputs=list(padd.outputs),
            attrs={"num_heads": heads,
                   # verbatim from FusedQKVAttention: its lowering feeds
                   # this straight to dot_product_attention(scale=...)
                   "scale": float(att.attr("scale", 1.0)),
                   "epsilon": float(ln.attr("epsilon", 1e-5))},
            name=(att.name or "attn") + "_block",
        )
        idx = graph.nodes.index(padd)
        graph.nodes[idx] = fused
        for n in (ln, mm, badd, att, pm):
            dead.add(id(n))
        changed += 1

    # -- separate-projection SELF-attention variant (SD-UNet spatial
    # transformers): LN -> 3x [MatMul(W, no bias) -> Reshape(B,N,H,hd)]
    # off the SAME ln edge -> FusedAttention(native) -> MatMul(Wp) ->
    # Add(bp). Cross-attention never matches (k/v read the context edge).
    for fa in list(graph.find_nodes("FusedAttention")):
        if id(fa) in dead or len(fa.inputs) != 3:
            continue
        if not all(int(fa.attr(f"{n}_native", 0)) for n in "qkv"):
            continue
        chains = []
        for e in fa.inputs:
            rs = producers.get(e)
            if (rs is None or rs.op_type != "Reshape" or not sole(e)
                    or rs.inputs[1] not in graph.initializers):
                break
            mm = producers.get(rs.inputs[0])
            if (mm is None or mm.op_type != "MatMul"
                    or not sole(rs.inputs[0]) or len(mm.inputs) != 2
                    or mm.inputs[1] not in graph.initializers):
                break
            tgt = [int(v) for v in
                   np.asarray(graph.initializers[rs.inputs[1]]).reshape(-1)]
            chains.append((rs, mm, tgt))
        if len(chains) != 3:
            continue
        ln_edge = chains[0][1].inputs[0]
        if any(c[1].inputs[0] != ln_edge for c in chains[1:]):
            continue  # not self-attention off one normalized edge
        if any(c[2] != chains[0][2] or len(c[2]) != 4 for c in chains):
            continue
        heads, hd = chains[0][2][2], chains[0][2][3]
        w_q, w_k, w_v = (graph.initializers[c[1].inputs[1]] for c in chains)
        if not (w_q.ndim == 2 and w_q.shape == w_k.shape == w_v.shape
                and w_q.shape[0] == w_q.shape[1] == heads * hd):
            continue
        d = int(w_q.shape[0])
        if heads <= 0 or hd <= 0 or 128 % hd or (heads * hd) % 128:
            continue
        nd_gate = _tokens_dim(graph, ln_edge)
        if nd_gate is None or nd_gate < _MIN_TOKENS_X_DIM:
            continue
        ln = producers.get(ln_edge)
        if (ln is None or ln.op_type != "LayerNormalization"
                or ln.inputs[1] not in graph.initializers
                or ln.inputs[2] not in graph.initializers
                or ln.attr("axis", -1) not in (-1, 2)
                or len(consumers.get(ln_edge, [])) != 3
                or not _aux_outputs_unused(graph, consumers, ln)):
            continue
        outs = consumers.get(fa.outputs[0], [])
        if (len(outs) != 1 or outs[0].op_type != "MatMul"
                or outs[0].inputs[0] != fa.outputs[0]
                or outs[0].inputs[1] not in graph.initializers
                or graph.initializers[outs[0].inputs[1]].shape != (d, d)):
            continue
        pm = outs[0]
        outs2 = consumers.get(pm.outputs[0], [])
        if (len(outs2) != 1 or outs2[0].op_type != "Add"
                or not sole(pm.outputs[0])):
            continue
        padd = outs2[0]
        bp_name = padd.inputs[1] if padd.inputs[1] in graph.initializers \
            else padd.inputs[0]
        if (bp_name not in graph.initializers
                or graph.initializers[bp_name].reshape(-1).shape != (d,)):
            continue

        wqkv = np.concatenate([np.asarray(w_q), np.asarray(w_k),
                               np.asarray(w_v)], axis=1)
        wpk, bpk = pack_qkv_weights(wqkv, np.zeros(3 * d, np.float32), heads)
        wpk_name = graph.fresh_name(chains[0][1].inputs[1] + "_pairpack")
        bpk_name = graph.fresh_name(chains[0][1].inputs[1] + "_pairpack_b")
        graph.initializers[wpk_name] = np.ascontiguousarray(wpk)
        graph.initializers[bpk_name] = np.ascontiguousarray(bpk)
        fused = Node(
            "VitAttnBlock",
            inputs=[ln.inputs[0], ln.inputs[1], ln.inputs[2],
                    wpk_name, bpk_name, pm.inputs[1], bp_name],
            outputs=list(padd.outputs),
            attrs={"num_heads": int(heads),
                   "scale": float(fa.attr("scale", 0.0)),
                   "epsilon": float(ln.attr("epsilon", 1e-5))},
            name=(fa.name or "sattn") + "_block",
        )
        graph.nodes[graph.nodes.index(padd)] = fused
        for c in chains:
            dead.add(id(c[0])), dead.add(id(c[1]))
        for n in (ln, fa, pm):
            dead.add(id(n))
        changed += 1

    # -- constant-context CROSS-attention (SD zoo: fixed context folds
    # the k/v projections to initializers): [ln edge] -> MatMul(Wq, no
    # bias) -> Reshape(B,N,H,hd) -> FusedAttention(q, K_const, V_const)
    # -> MatMul(Wp) -> Add(bp). The kernel consumes the already-normalized
    # edge (pre-LN owned by the upstream SkipLayerNormalization).
    for fa in list(graph.find_nodes("FusedAttention")):
        if not _CROSS_ENABLED:
            break
        if id(fa) in dead or len(fa.inputs) != 3:
            continue
        if not int(fa.attr("q_native", 0)):
            continue
        kc = graph.initializers.get(fa.inputs[1])
        vc = graph.initializers.get(fa.inputs[2])
        # batch dim may be 1 (shared context) or B (batch-baked contexts)
        if (kc is None or vc is None or kc.ndim != 4
                or vc.shape != kc.shape):
            continue
        rs = producers.get(fa.inputs[0])
        if (rs is None or rs.op_type != "Reshape" or not sole(fa.inputs[0])
                or rs.inputs[1] not in graph.initializers):
            continue
        mm = producers.get(rs.inputs[0])
        if (mm is None or mm.op_type != "MatMul" or not sole(rs.inputs[0])
                or len(mm.inputs) != 2
                or mm.inputs[1] not in graph.initializers):
            continue
        wq = graph.initializers[mm.inputs[1]]
        if wq.ndim != 2 or wq.shape[0] != wq.shape[1]:
            continue
        d = int(wq.shape[0])
        heads, hd = int(kc.shape[2]), int(kc.shape[3])
        if heads * hd != d:
            continue
        nd_gate = _tokens_dim(graph, mm.inputs[0])
        if nd_gate is None or nd_gate < _MIN_TOKENS_X_DIM:
            continue
        outs = consumers.get(fa.outputs[0], [])
        if (len(outs) != 1 or outs[0].op_type != "MatMul"
                or outs[0].inputs[0] != fa.outputs[0]
                or outs[0].inputs[1] not in graph.initializers
                or graph.initializers[outs[0].inputs[1]].shape != (d, d)):
            continue
        pm = outs[0]
        outs2 = consumers.get(pm.outputs[0], [])
        if (len(outs2) != 1 or outs2[0].op_type != "Add"
                or not sole(pm.outputs[0])):
            continue
        padd = outs2[0]
        bp_name = padd.inputs[1] if padd.inputs[1] in graph.initializers \
            else padd.inputs[0]
        if (bp_name not in graph.initializers
                or graph.initializers[bp_name].reshape(-1).shape != (d,)):
            continue

        # (Bk, S, H, hd) -> (Bk, H, S, hd)
        k_name = graph.fresh_name(fa.inputs[1] + "_hshd")
        v_name = graph.fresh_name(fa.inputs[2] + "_hshd")
        graph.initializers[k_name] = np.ascontiguousarray(
            np.asarray(kc).transpose(0, 2, 1, 3))
        graph.initializers[v_name] = np.ascontiguousarray(
            np.asarray(vc).transpose(0, 2, 1, 3))
        fused = Node(
            "CrossAttnBlock",
            inputs=[mm.inputs[0], mm.inputs[1], k_name, v_name,
                    pm.inputs[1], bp_name],
            outputs=list(padd.outputs),
            attrs={"num_heads": heads,
                   "scale": float(fa.attr("scale", 0.0))},
            name=(fa.name or "xattn") + "_block",
        )
        graph.nodes[graph.nodes.index(padd)] = fused
        for n in (rs, mm, fa, pm):
            dead.add(id(n))
        changed += 1

    # -- post-LN variant: ORT-contrib BERT pattern ------------------------
    #   Attention(x, Wqkv, bqkv) -> MatMul(Wproj) -> SkipLayerNormalization
    # Attention + proj collapse into VitAttnBlock(pre_ln=0); the
    # SkipLayerNormalization keeps residual + LN (+ proj bias) downstream.
    input_ranks = {v.name: (len(v.type.shape) if v.type is not None else None)
                   for v in graph.inputs}
    for att in list(graph.find_nodes("Attention")):
        if id(att) in dead:
            continue
        mask = att.inputs[3] if len(att.inputs) > 3 else ""
        if mask and input_ranks.get(mask) != 2:
            # rank unknown from graph inputs: the (B,) valid-length form
            # produced by EmbedLayerNormalization output 1 is also
            # kernelized; every other mask form keeps the general lowering
            pr = producers.get(mask)
            if not (pr is not None
                    and pr.op_type == "EmbedLayerNormalization"
                    and len(pr.outputs) > 1 and pr.outputs[1] == mask):
                continue
        if (len(att.inputs) > 4 and any(e for e in att.inputs[4:])):
            continue  # past / attention_bias: keep the general lowering
        if (int(att.attr("unidirectional", 0))
                or int(att.attr("do_rotary", 0))
                or att.attr("qkv_hidden_sizes") is not None
                or len([o for o in att.outputs if o]) != 1):  # no `present`
            continue
        heads = int(att.attr("num_heads", 0))
        if (len(att.inputs) < 3 or att.inputs[1] not in graph.initializers
                or att.inputs[2] not in graph.initializers):
            continue
        wqkv = graph.initializers[att.inputs[1]]
        if wqkv.ndim != 2 or wqkv.shape[1] != 3 * wqkv.shape[0]:
            continue
        d = int(wqkv.shape[0])
        hd = d // heads if heads else 0
        if (heads <= 0 or d % heads or hd == 0 or 128 % hd
                or (heads * hd) % 128):
            continue
        nd = _tokens_dim(graph, att.inputs[0])
        if nd is None or nd < _MIN_TOKENS_X_DIM:
            continue  # measured loss at small geometry (BERT-enc, probe56)
        outs = consumers.get(att.outputs[0], [])
        if (len(outs) != 1 or outs[0].op_type != "MatMul"
                or not sole(att.outputs[0])):
            continue
        pm = outs[0]
        if (pm.inputs[0] != att.outputs[0]
                or pm.inputs[1] not in graph.initializers
                or graph.initializers[pm.inputs[1]].shape != (d, d)):
            continue
        bq = graph.initializers[att.inputs[2]].reshape(-1)
        if bq.shape != (3 * d,):
            continue

        wpk, bpk = pack_qkv_weights(np.asarray(wqkv), np.asarray(bq), heads)
        wpk_name = graph.fresh_name(att.inputs[1] + "_pairpack")
        bpk_name = graph.fresh_name(att.inputs[2] + "_pairpack")
        graph.initializers[wpk_name] = np.ascontiguousarray(wpk)
        graph.initializers[bpk_name] = np.ascontiguousarray(bpk)
        ones = graph.fresh_name("vab_ones")
        zeros = graph.fresh_name("vab_zeros")
        graph.initializers[ones] = np.ones(d, np.float32)   # unused (pre_ln=0)
        graph.initializers[zeros] = np.zeros(d, np.float32)

        fused = Node(
            "VitAttnBlock",
            inputs=[att.inputs[0], ones, zeros, wpk_name, bpk_name,
                    pm.inputs[1], zeros] + ([mask] if mask else []),
            outputs=list(pm.outputs),
            attrs={"num_heads": heads,
                   "scale": float(att.attr("scale", 0.0)),  # 0 -> 1/sqrt(hd)
                   "mask_filter": float(att.attr("mask_filter_value",
                                                 -10000.0)),
                   "pre_ln": 0},
            name=(att.name or "attn") + "_block",
        )
        idx = graph.nodes.index(pm)
        graph.nodes[idx] = fused
        dead.add(id(att))
        changed += 1

    if changed:
        graph.nodes = [n for n in graph.nodes if id(n) not in dead]
        graph.toposort()
        graph.dead_code_eliminate()
        graph.value_types = {}
    return changed


@register_pass("fuse_mlp_block")
def fuse_mlp_block(graph: Graph) -> int:
    """Fuse the transformer MLP into one MlpBlock op (kernel: 164 TF vs
    XLA 109 at ViT-B geometry, probe54). Two shapes:

    ViT (pre-LN, run AFTER fuse_residual_ln):
        SkipLayerNormalization(x, y)[ln, .., sum]
          -> MatMul(W1) -> Add(b1) -> Gelu -> MatMul(W2) -> Add(b2)
          -> Add(sum, .)                  # residual
      becomes Add(x, y) -> MlpBlock(sum, g, b, W1, b1, W2, b2,
      residual=1) producing the residual Add's output.

    BERT (ORT contrib, post-LN):
        sln_out -> MatMul(W1) -> FastGelu(bias) -> MatMul(W2)
          -> SkipLayerNormalization(.., sln_out, ...)
      becomes MlpBlock(sln_out, pre_ln=0, approximate=1, residual=0);
      the trailing SkipLayerNormalization keeps residual + LN."""
    # type availability decided up front, on the unmutated graph: the
    # BERT-contrib shape must verify the MatMul input is rank-3 (the
    # kernel unpacks B, N, D) — a 2-D chain must keep the general path.
    types_ok = _ensure_types(graph)
    producers = graph.producers()
    consumers = graph.consumers()
    changed = 0
    dead: set[int] = set()

    def sole(edge: str) -> bool:
        return len(consumers.get(edge, [])) == 1

    def sole_consumer(edge: str, op: str):
        cs = consumers.get(edge, [])
        if len(cs) == 1 and cs[0].op_type == op:
            return cs[0]
        return None

    def init(name: str):
        return graph.initializers.get(name)

    # --- ViT shape ------------------------------------------------------
    for sln in list(graph.find_nodes("SkipLayerNormalization")):
        if id(sln) in dead or len(sln.outputs) < 4 or not sln.outputs[3]:
            continue
        if len(sln.inputs) > 4 and sln.inputs[4]:
            continue  # fused bias form: not this pattern
        ln_out, sum_out = sln.outputs[0], sln.outputs[3]
        mm1 = sole_consumer(ln_out, "MatMul")
        if mm1 is None or init(mm1.inputs[1]) is None:
            continue
        w1 = init(mm1.inputs[1])
        if w1.ndim != 2 or w1.shape[0] % 128 or w1.shape[1] % 128:
            continue
        d, f = int(w1.shape[0]), int(w1.shape[1])
        a1 = sole_consumer(mm1.outputs[0], "Add")
        if a1 is None:
            continue
        b1n = a1.inputs[1] if init(a1.inputs[1]) is not None else a1.inputs[0]
        if init(b1n) is None or init(b1n).reshape(-1).shape != (f,):
            continue
        gel = sole_consumer(a1.outputs[0], "Gelu")
        if gel is None:
            continue
        approx = str(gel.attr("approximate", "none")) == "tanh"
        mm2 = sole_consumer(gel.outputs[0], "MatMul")
        if (mm2 is None or init(mm2.inputs[1]) is None
                or init(mm2.inputs[1]).shape != (f, d)):
            continue
        a2 = sole_consumer(mm2.outputs[0], "Add")
        if a2 is None:
            continue
        b2n = a2.inputs[1] if init(a2.inputs[1]) is not None else a2.inputs[0]
        if init(b2n) is None or init(b2n).reshape(-1).shape != (d,):
            continue
        # the residual is either a plain Add, or (for the LAST block) it
        # was already folded into the next SkipLayerNormalization by
        # fuse_residual_ln
        res = sole_consumer(a2.outputs[0], "Add")
        res_sln = (None if res is not None
                   else sole_consumer(a2.outputs[0], "SkipLayerNormalization"))
        if res is not None:
            if sum_out not in res.inputs:
                continue
        elif res_sln is not None:
            if (sum_out not in res_sln.inputs[:2]
                    or (len(res_sln.inputs) > 4 and res_sln.inputs[4])):
                continue  # fused-bias SkipLayerNorm: demotion would drop it
        else:
            continue
        # sum_out must feed ONLY the residual consumer (the kernel re-adds)
        if len(consumers.get(sum_out, [])) != 1:
            continue
        if (init(sln.inputs[2]) is None or init(sln.inputs[3]) is None):
            continue
        # sln is replaced by a plain Add producing only sum_out; its
        # mean/inv-std outputs (1-2) must be unconsumed. Same for the
        # demoted trailing SkipLayerNormalization, whose sum output (3)
        # is redirected explicitly below.
        if not _aux_outputs_unused(graph, consumers, sln, keep=(sum_out,)):
            continue
        if res_sln is not None and not _aux_outputs_unused(
                graph, consumers, res_sln,
                keep=(res_sln.outputs[3] if len(res_sln.outputs) > 3
                      else "",)):
            continue

        sum_add = Node("Add", [sln.inputs[0], sln.inputs[1]], [sum_out],
                       name=(sln.name or "sln") + "_sum")
        out_edge = (res.outputs[0] if res is not None
                    else graph.fresh_name(a2.outputs[0] + "_blk"))
        fused = Node(
            "MlpBlock",
            inputs=[sum_out, sln.inputs[2], sln.inputs[3],
                    mm1.inputs[1], b1n, mm2.inputs[1], b2n],
            outputs=[out_edge],
            attrs={"epsilon": float(sln.attr("epsilon", 1e-5)),
                   "approximate": int(approx), "residual": 1},
            name=(sln.name or "mlp") + "_block",
        )
        graph.nodes[graph.nodes.index(sln)] = sum_add
        if res is not None:
            graph.nodes[graph.nodes.index(res)] = fused
        else:
            # demote the trailing SkipLayerNormalization to a plain LN of
            # the kernel's (already-summed) output; redirect users of its
            # sum output to the kernel output
            graph.nodes.insert(graph.nodes.index(res_sln), fused)
            ln2 = Node("LayerNormalization",
                       [out_edge, res_sln.inputs[2], res_sln.inputs[3]],
                       [res_sln.outputs[0]],
                       attrs={"epsilon": float(res_sln.attr("epsilon",
                                                            1e-5)),
                              "axis": -1},
                       name=(res_sln.name or "sln2") + "_ln")
            graph.nodes[graph.nodes.index(res_sln)] = ln2
            old_sum = res_sln.outputs[3] if len(res_sln.outputs) > 3 else ""
            if old_sum:
                for n in graph.nodes:
                    n.inputs = [out_edge if e == old_sum else e
                                for e in n.inputs]
                graph.outputs = [
                    type(v)(out_edge, v.type) if v.name == old_sum else v
                    for v in graph.outputs]
        for n in (mm1, a1, gel, mm2, a2):
            dead.add(id(n))
        changed += 1

    # --- BERT contrib shape ----------------------------------------------
    for mm1 in list(graph.find_nodes("MatMul")):
        if id(mm1) in dead:
            continue
        w1 = init(mm1.inputs[1])
        if (w1 is None or w1.ndim != 2 or w1.shape[0] % 128
                or w1.shape[1] % 128):
            continue
        d, f = int(w1.shape[0]), int(w1.shape[1])
        if f <= d:  # up-projection only
            continue
        fg = sole_consumer(mm1.outputs[0], "FastGelu")
        if fg is None or len(fg.inputs) < 2 or init(fg.inputs[1]) is None:
            continue
        b1 = init(fg.inputs[1]).reshape(-1)
        if b1.shape != (f,):
            continue
        mm2 = sole_consumer(fg.outputs[0], "MatMul")
        if (mm2 is None or init(mm2.inputs[1]) is None
                or init(mm2.inputs[1]).shape != (f, d)):
            continue
        sln = sole_consumer(mm2.outputs[0], "SkipLayerNormalization")
        if sln is None:
            continue
        t3 = graph.value_types.get(mm1.inputs[0]) if types_ok else None
        if t3 is None or t3.shape is None or len(t3.shape) != 3:
            continue  # mlp_block unpacks B, N, D — 2-D chains stay general
        zeros = graph.fresh_name("mlpb_zeros")
        ones = graph.fresh_name("mlpb_ones")
        graph.initializers[zeros] = np.zeros(d, np.float32)
        graph.initializers[ones] = np.ones(d, np.float32)
        fused = Node(
            "MlpBlock",
            inputs=[mm1.inputs[0], ones, zeros,
                    mm1.inputs[1], fg.inputs[1], mm2.inputs[1], zeros],
            outputs=list(mm2.outputs),
            attrs={"approximate": 1, "residual": 0, "pre_ln": 0},
            name=(mm1.name or "mlp") + "_block",
        )
        graph.nodes[graph.nodes.index(mm2)] = fused
        for n in (mm1, fg):
            dead.add(id(n))
        changed += 1

    if changed:
        graph.nodes = [n for n in graph.nodes if id(n) not in dead]
        graph.toposort()
        graph.dead_code_eliminate()
        graph.value_types = {}
    return changed


@register_pass("fuse_convnext_block")
def fuse_convnext_block(graph: Graph) -> int:
    """Fuse the ConvNeXt block — depthwise 7x7 -> LN -> FC1 -> gelu ->
    FC2 -> layer scale -> residual — into one ConvNeXtBlock op
    (kernels/convnext_block.py; isolated A/B: 2.77 -> 1.97 ms at the
    b64 stage-1 geometry, probe64). Runs INSIDE the NHWC pipeline (needs
    the dwconv already converted); handles the residual in either layout
    (the torch export keeps the canonical chain NCHW, so the fused
    output gets one Transpose back that fuse_transpose_pairs then
    cancels against the next block's entry twin). Gated by the measured
    tokens*dim rule — stage-4 (49 tokens) keeps the XLA path."""
    if not _ensure_types(graph):
        return 0
    producers = graph.producers()
    consumers = graph.consumers()
    changed = 0
    dead: set[int] = set()

    def sole_consumer(edge, op):
        cs = consumers.get(edge, [])
        if len(cs) == 1 and cs[0].op_type == op:
            return cs[0]
        return None

    def init(name):
        return graph.initializers.get(name)

    def take_weight(edge):
        """Resolve a weight edge to an f32 array, folding int8
        weight-only DequantizeLinear wrappers (quant runs before the
        NHWC pipeline; the kernel holds weights VMEM-resident so the
        int8 HBM saving is moot for fused blocks). Returns
        (array, extra_dead_node_or_None)."""
        a = init(edge)
        if a is not None:
            return (a.astype(np.float32) if a.dtype != np.float32 else a,
                    None)
        dq = producers.get(edge)
        if (dq is None or dq.op_type != "DequantizeLinear"
                or len(consumers.get(edge, [])) != 1):
            return None, None
        wq = init(dq.inputs[0])
        sc = init(dq.inputs[1])
        if wq is None or sc is None:
            return None, None
        w = wq.astype(np.float32)
        scv = np.asarray(sc, np.float32)
        if scv.ndim == 0 or scv.size == 1:
            w = w * float(scv.reshape(-1)[0])
        else:
            ax = int(dq.attr("axis", 1)) % w.ndim
            shape = [1] * w.ndim
            shape[ax] = scv.size
            w = w * scv.reshape(shape)
        return w, dq

    def mlp_matmul(edge):
        """Accept MatMul(x, W_init-or-dequant) or
        FusedDequantMatMul(x, wq, scales). Returns
        (node, w_f32, extra_dead) or (None, None, None)."""
        mm = sole_consumer(edge, "MatMul")
        if mm is not None:
            w, extra = take_weight(mm.inputs[1])
            return (mm, w, extra) if w is not None else (None, None, None)
        fd = sole_consumer(edge, "FusedDequantMatMul")
        if fd is None:
            return None, None, None
        wq, sc = init(fd.inputs[1]), init(fd.inputs[2])
        if wq is None or sc is None or wq.ndim != 2:
            return None, None, None
        w = wq.astype(np.float32) * np.asarray(sc, np.float32).reshape(-1)
        return fd, w, None

    for conv in list(graph.find_nodes("Conv")):
        if id(conv) in dead:
            continue
        w, w_dead = (take_weight(conv.inputs[1])
                     if len(conv.inputs) > 1 else (None, None))
        ap = conv.attr("auto_pad", b"NOTSET")
        ap = ap.decode() if isinstance(ap, bytes) else str(ap)
        pads_a = conv.attr("pads")
        dil_a = conv.attr("dilations")
        if (w is None or conv.attr("data_layout", "NCHW") != "NHWC"
                or w.ndim != 4 or w.shape[:3] != (7, 7, 1)
                or int(conv.attr("group", 1)) != w.shape[3]
                or len(conv.inputs) < 3 or init(conv.inputs[2]) is None
                or conv.attr("strides", [1, 1]) not in ([1, 1], None)
                # the kernel hard-codes centered (3,3) same-padding at
                # dilation 1 — any other still-size-preserving geometry
                # (asymmetric pads, dilated 7x7) must keep the XLA path
                or ap not in ("NOTSET", "")
                or (pads_a is not None
                    and [int(p) for p in pads_a] != [3, 3, 3, 3])
                or (dil_a is not None
                    and [int(v) for v in dil_a] != [1, 1])):
            continue
        c = int(w.shape[3])
        t = graph.value_types.get(conv.inputs[0])
        if t is None or t.shape is None or len(t.shape) != 4:
            continue
        hh, ww = int(t.shape[1]), int(t.shape[2])
        if hh * ww * c < _MIN_TOKENS_X_DIM:
            continue  # tiny per-image GEMMs lose (probe55/56 precedent)
        # dwconv_ln_barrier (default-on at the NHWC tail) may sit
        # between the conv and the LN: transparent here — the fused
        # kernel replaces the whole chain, so the barrier is moot
        conv_out = conv.outputs[0]
        bar = sole_consumer(conv_out, "OptimizationBarrier")
        if bar is not None:
            conv_out = bar.outputs[0]
        ln = sole_consumer(conv_out, "LayerNormalization")
        if (ln is None or ln.attr("axis", -1) not in (-1, 3)
                or init(ln.inputs[1]) is None or init(ln.inputs[2]) is None
                or not _aux_outputs_unused(graph, consumers, ln)):
            continue
        mm1, w1, w1_dead = mlp_matmul(ln.outputs[0])
        if mm1 is None or w1.ndim != 2 or w1.shape[0] != c:
            continue
        f = int(w1.shape[1])
        a1 = sole_consumer(mm1.outputs[0], "Add")
        if a1 is None:
            continue
        b1n = a1.inputs[1] if init(a1.inputs[1]) is not None else a1.inputs[0]
        if init(b1n) is None or init(b1n).reshape(-1).shape != (f,):
            continue
        gel = sole_consumer(a1.outputs[0], "Gelu")
        if gel is None or str(gel.attr("approximate", "none")) != "none":
            continue
        mm2, w2, w2_dead = mlp_matmul(gel.outputs[0])
        if mm2 is None or w2.shape != (f, c):
            continue
        a2 = sole_consumer(mm2.outputs[0], "Add")
        if a2 is None:
            continue
        b2n = a2.inputs[1] if init(a2.inputs[1]) is not None else a2.inputs[0]
        if init(b2n) is None or init(b2n).reshape(-1).shape != (c,):
            continue
        mul = sole_consumer(a2.outputs[0], "Mul")
        if mul is None:
            continue
        gm = mul.inputs[0] if init(mul.inputs[0]) is not None \
            else mul.inputs[1]
        if init(gm) is None or init(gm).reshape(-1).shape != (c,):
            continue
        x_nhwc = conv.inputs[0]
        # residual: either Add(x_nhwc, mul) directly, or (torch export)
        # Transpose back to NCHW then Add with x_nhwc's NCHW twin
        res = sole_consumer(mul.outputs[0], "Add")
        tr = None
        if res is not None and x_nhwc in res.inputs:
            pass  # NHWC residual
        else:
            tr = sole_consumer(mul.outputs[0], "Transpose")
            if tr is None or list(tr.attr("perm", [])) != [0, 3, 1, 2]:
                continue
            res = sole_consumer(tr.outputs[0], "Add")
            if res is None:
                continue
            other = res.inputs[0] if res.inputs[1] == tr.outputs[0] \
                else res.inputs[1]
            twin = producers.get(x_nhwc)
            if (twin is None or twin.op_type != "Transpose"
                    or list(twin.attr("perm", [])) != [0, 2, 3, 1]
                    or twin.inputs[0] != other):
                continue  # not the same tensor's NCHW form

        # materialize folded f32 weights as fresh initializers (the
        # kernel holds them VMEM-resident; int8 wire savings are moot)
        wdn = graph.fresh_name(conv.inputs[1] + "_f32")
        w1n = graph.fresh_name("cnx_w1_f32")
        w2n = graph.fresh_name("cnx_w2_f32")
        graph.initializers[wdn] = np.ascontiguousarray(w)
        graph.initializers[w1n] = np.ascontiguousarray(w1)
        graph.initializers[w2n] = np.ascontiguousarray(w2)
        fused = Node(
            "ConvNeXtBlock",
            inputs=[x_nhwc, wdn, conv.inputs[2],
                    ln.inputs[1], ln.inputs[2], w1n, b1n,
                    w2n, b2n, gm],
            outputs=[graph.fresh_name(res.outputs[0] + "_nhwc")
                     if tr is not None else res.outputs[0]],
            attrs={"epsilon": float(ln.attr("epsilon", 1e-6))},
            name=(conv.name or "cnx") + "_block",
        )
        if tr is None:
            graph.nodes[graph.nodes.index(res)] = fused
        else:
            graph.nodes.insert(graph.nodes.index(res), fused)
            # keep the NCHW output edge alive for downstream consumers
            back = Node("Transpose", [fused.outputs[0]],
                        [res.outputs[0]], attrs={"perm": [0, 3, 1, 2]},
                        name=(res.name or "res") + "_nchw")
            graph.nodes[graph.nodes.index(res)] = back
            dead.add(id(tr))
        for n in (conv, bar, ln, mm1, a1, gel, mm2, a2, mul,
                  w_dead, w1_dead, w2_dead):
            if n is not None:
                dead.add(id(n))
        changed += 1

    if changed:
        graph.nodes = [n for n in graph.nodes if id(n) not in dead]
        graph.toposort()
        graph.dead_code_eliminate()
        graph.value_types = {}
    return changed
