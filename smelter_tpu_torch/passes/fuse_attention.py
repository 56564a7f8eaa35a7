"""Fuse the exported attention pattern into one FusedAttention op.

ONNX exports of transformer attention (including our fx exporter's ViT,
models/vit.py) emit:  MatMul(Q, K^T) -> Mul(scale) (or Div) -> [Add mask]
-> Softmax -> MatMul(., V).  This pass pattern-matches that chain and
replaces it with FusedAttention(Q, K, V) carrying the scale — one op that
the lowering maps to jax.nn.dot_product_attention (XLA emits a fused,
numerically-stable attention on TPU) and that a Pallas flash-attention
kernel can later claim under Config.use_pallas.

The reference has no attention at all (SURVEY.md §5.7: CNN-shaped engine);
this is new capability required by the ViT-B/16 config (BASELINE.json:11).
"""

from __future__ import annotations

import numpy as np

from ..ir.graph import Graph, Node
from .pass_manager import register_pass


def _as_scalar(graph: Graph, name: str):
    a = graph.initializers.get(name)
    if a is not None and a.size == 1:
        return float(np.asarray(a).reshape(-1)[0])
    return None


def _static_ints(graph: Graph, name: str):
    a = graph.initializers.get(name)
    if a is None:
        return None
    return [int(v) for v in np.asarray(a).reshape(-1)]


@register_pass("fuse_qkv_attention")
def fuse_qkv_attention(graph: Graph) -> int:
    """Collapse the packed-QKV glue around FusedAttention (run after
    fuse_attention):

        qkv(B,N,3D) -> Reshape(B,N,3,H,hd) -> Transpose(2,0,3,1,4)
          -> 3x [Slice(axis0,i) -> Squeeze] -> FusedAttention
          -> Transpose(0,2,1,3) -> Reshape(B,N,D)

    becomes one FusedQKVAttention(qkv) in native (B,N,H,hd) layout. The
    5-D transpose and the three slice copies each materialize the full
    activation in HBM (probe15: ~the whole unexplained model-minus-layers
    gap on ViT-B); the fused lowering reads the packed tensor directly."""
    producers = graph.producers()
    consumers = graph.consumers()
    changed = 0
    dead: set[int] = set()

    def sole(out: str) -> bool:
        return len(consumers.get(out, [])) == 1

    for fa in list(graph.find_nodes("FusedAttention")):
        if id(fa) in dead or len(fa.inputs) != 3:
            continue
        picks = []
        ok = True
        for name in fa.inputs:
            sq = producers.get(name)
            if (sq is None or sq.op_type != "Squeeze" or not sole(name)):
                ok = False
                break
            axes = (sq.attr("axes")
                    or (_static_ints(graph, sq.inputs[1])
                        if len(sq.inputs) > 1 else None))
            if axes is None or [int(a) for a in axes] != [0]:
                ok = False
                break
            sl = producers.get(sq.inputs[0])
            if (sl is None or sl.op_type != "Slice"
                    or not sole(sq.inputs[0]) or len(sl.inputs) < 4):
                ok = False
                break
            starts = _static_ints(graph, sl.inputs[1])
            ends = _static_ints(graph, sl.inputs[2])
            sl_axes = _static_ints(graph, sl.inputs[3])
            steps = (_static_ints(graph, sl.inputs[4])
                     if len(sl.inputs) > 4 and sl.inputs[4] else [1])
            if (starts is None or ends is None or sl_axes != [0]
                    or steps != [1] or len(starts) != 1
                    or ends[0] != starts[0] + 1):
                ok = False
                break
            picks.append((sl, sq, starts[0]))
        # q/k/v must come from packed slots 0/1/2 in that order (the
        # lowering reads them positionally from the packed tensor)
        if not ok or [p[2] for p in picks] != [0, 1, 2]:
            continue
        tr_names = {p[0].inputs[0] for p in picks}
        if len(tr_names) != 1:
            continue
        tr = producers.get(next(iter(tr_names)))
        if (tr is None or tr.op_type != "Transpose"
                or tr.attr("perm") != [2, 0, 3, 1, 4]
                or len(consumers.get(tr.outputs[0], [])) != 3):
            continue
        rs = producers.get(tr.inputs[0])
        if rs is None or rs.op_type != "Reshape" or not sole(tr.inputs[0]):
            continue
        shape5 = _static_ints(graph, rs.inputs[1])
        if shape5 is None or len(shape5) != 5 or shape5[2] != 3:
            continue
        num_heads = shape5[3]
        qkv_name = rs.inputs[0]
        # output side: Transpose(0,2,1,3) -> Reshape(B,N,D)
        outs = consumers.get(fa.outputs[0], [])
        if len(outs) != 1 or outs[0].op_type != "Transpose" \
                or outs[0].attr("perm") != [0, 2, 1, 3]:
            continue
        out_tr = outs[0]
        outs2 = consumers.get(out_tr.outputs[0], [])
        if len(outs2) != 1 or outs2[0].op_type != "Reshape":
            continue
        out_rs = outs2[0]
        shape3 = _static_ints(graph, out_rs.inputs[1])
        if shape3 is None or len(shape3) != 3:
            continue

        # reorder: q/k/v pick order must match slice indices 0/1/2
        fused = Node(
            "FusedQKVAttention",
            inputs=[qkv_name],
            outputs=list(out_rs.outputs),
            attrs={"scale": fa.attr("scale", 1.0), "num_heads": num_heads},
            name=(fa.name or "attn") + "_qkv",
        )
        for n in [rs, tr, fa, out_tr, out_rs] + [p[0] for p in picks] \
                + [p[1] for p in picks]:
            dead.add(id(n))
        idx = graph.nodes.index(out_rs)
        graph.nodes[idx] = fused
        changed += 1

    if changed:
        graph.remove_nodes(dead)
        graph.toposort()
    return changed


@register_pass("fuse_attention")
def fuse_attention(graph: Graph) -> int:
    producers = graph.producers()
    consumers = graph.consumers()
    changed = 0
    dead: set[int] = set()

    def sole(node_out: str) -> bool:
        return len(consumers.get(node_out, [])) == 1

    for mm2 in list(graph.find_nodes("MatMul")):
        # mm2 = MatMul(softmax_out, V)
        sm = producers.get(mm2.inputs[0])
        if sm is None or sm.op_type != "Softmax" or not sole(sm.outputs[0]):
            continue
        axis = sm.attr("axis", -1)
        if axis not in (-1,):
            # normalize: last-axis softmax required
            t = graph.value_types.get(sm.inputs[0])
            if t is None or axis != len(t.shape) - 1:
                continue
        scale_node = producers.get(sm.inputs[0])
        scale = 1.0
        qk = scale_node
        mask_name = ""
        # optional Add(mask) between scale and softmax
        if scale_node is not None and scale_node.op_type == "Add":
            # one side is the qk chain, the other the mask
            lhs_p = producers.get(scale_node.inputs[0])
            mask_name = scale_node.inputs[1]
            qk = lhs_p
            if qk is None or qk.op_type not in ("Mul", "Div", "MatMul"):
                qk = producers.get(scale_node.inputs[1])
                mask_name = scale_node.inputs[0]
            if qk is None or not sole(scale_node.outputs[0]):
                continue
            scale_node = qk
        if scale_node is None:
            continue
        if scale_node.op_type in ("Mul", "Div"):
            s = _as_scalar(graph, scale_node.inputs[1])
            if s is None:
                s = _as_scalar(graph, scale_node.inputs[0])
            if s is None or not sole(scale_node.outputs[0]):
                continue
            scale = (1.0 / s) if scale_node.op_type == "Div" else s
            mm1 = producers.get(scale_node.inputs[0])
            if mm1 is None or mm1.op_type != "MatMul":
                mm1 = producers.get(scale_node.inputs[1])
        else:
            mm1 = scale_node
        if mm1 is None or mm1.op_type != "MatMul" or not sole(mm1.outputs[0]):
            continue
        # mm1 = MatMul(Q, K^T): K^T via Transpose(-2,-1), or — the torch
        # "native layout" export — a single Transpose([0,2,3,1]) straight
        # from the (B,N,H,hd) projection.
        q_name = mm1.inputs[0]
        k_native = False
        kt = producers.get(mm1.inputs[1])
        k_init = graph.initializers.get(mm1.inputs[1])
        if kt is not None and kt.op_type == "Transpose" and sole(kt.outputs[0]):
            perm = kt.attr("perm")
            rank = len(perm) if perm else None
            if perm and perm == list(range(rank - 2)) + [rank - 1, rank - 2]:
                k_name = kt.inputs[0]
                dead.add(id(kt))
            elif perm == [0, 2, 3, 1]:
                # K read directly from (B,N,H,hd) — mark native so the
                # lowering feeds dot_product_attention with NO transpose
                k_name = kt.inputs[0]
                k_native = True
                dead.add(id(kt))
            else:
                continue
        elif k_init is not None and k_init.ndim == 4:
            # K^T is a folded constant ((B,H,hd,T), e.g. projections of a
            # baked text context) — relayout host-side to native (B,T,H,hd)
            k_name = mm1.inputs[1] + "__native"
            graph.initializers[k_name] = np.ascontiguousarray(
                np.transpose(k_init, (0, 3, 1, 2)))
            k_native = True
        else:
            continue
        v_name = mm2.inputs[1]

        # Fold the matching q/v layout transposes ((B,N,H,hd)->(B,H,N,hd))
        # so the whole attention runs in native layout, zero copies
        # (probe16: the 4/5-D transpose glue was the ViT gap; same shape
        # here for torch-exported cross-attention, e.g. models/sd_unet.py).
        q_native = v_native = False
        qp = producers.get(q_name)
        if (k_native and qp is not None and qp.op_type == "Transpose"
                and sole(qp.outputs[0]) and qp.attr("perm") == [0, 2, 1, 3]):
            q_name = qp.inputs[0]
            q_native = True
            dead.add(id(qp))
        vp = producers.get(v_name)
        v_init = graph.initializers.get(v_name)
        if (k_native and vp is not None and vp.op_type == "Transpose"
                and sole(vp.outputs[0]) and vp.attr("perm") == [0, 2, 1, 3]):
            v_name = vp.inputs[0]
            v_native = True
            dead.add(id(vp))
        elif k_native and vp is None and v_init is not None \
                and v_init.ndim == 4:
            v_name = v_name + "__native"
            graph.initializers[v_name] = np.ascontiguousarray(
                np.transpose(v_init, (0, 2, 1, 3)))
            v_native = True

        # Output side: absorb Transpose([0,2,1,3]) -> Reshape(B,N,D) so the
        # fused op emits (B,N,D) directly.
        out_shape3 = None
        out_node = mm2
        outs1 = consumers.get(mm2.outputs[0], [])
        if (q_native and v_native and len(outs1) == 1
                and outs1[0].op_type == "Transpose"
                and outs1[0].attr("perm") == [0, 2, 1, 3]):
            outs2 = consumers.get(outs1[0].outputs[0], [])
            if len(outs2) == 1 and outs2[0].op_type == "Reshape":
                shape3 = _static_ints(graph, outs2[0].inputs[1])
                if shape3 is not None and len(shape3) == 3:
                    out_shape3 = shape3
                    out_node = outs2[0]
                    dead.add(id(outs1[0]))
                    dead.add(id(outs2[0]))

        attrs = {"scale": scale}
        if q_native:
            attrs["q_native"] = 1
        if k_native:
            attrs["k_native"] = 1
        if v_native:
            attrs["v_native"] = 1
        if out_shape3 is not None:
            attrs["out_shape"] = out_shape3
        fused = Node(
            "FusedAttention",
            inputs=[q_name, k_name, v_name] + ([mask_name] if mask_name else []),
            outputs=list(out_node.outputs),
            attrs=attrs,
            name=(mm2.name or "attn") + "_fused",
        )
        # Mark the chain dead and splice in the fused node.
        for n in (mm1, sm, mm2):
            dead.add(id(n))
        if scale_node.op_type in ("Mul", "Div"):
            dead.add(id(scale_node))
        maybe_add = producers.get(sm.inputs[0])
        if maybe_add is not None and maybe_add.op_type == "Add" and mask_name:
            dead.add(id(maybe_add))
        idx = graph.nodes.index(out_node)
        graph.nodes[idx] = fused
        changed += 1

    if changed:
        graph.remove_nodes(dead)
        graph.toposort()
    return changed


@register_pass("fuse_residual_ln")
def fuse_residual_ln(graph: Graph) -> int:
    """Fuse the transformer residual+LN block: Add(x, y) feeding
    LayerNormalization (last axis) becomes ONE SkipLayerNormalization node
    emitting both the normalized output and the pre-norm sum (output 3) —
    the same contrib form ORT's optimizer produces, so the Pallas
    residual+LN kernel (kernels/layer_norm.py::residual_layer_norm) has a
    single integration point. The default composite lowering computes the
    identical x+y-then-LN, so the pass is numerics-preserving.

    Conditions: both Add operands are same-shape activations (broadcasts
    excluded — the sum output must be the full-rank residual carry), the
    LN normalizes the trailing axis only, and has no stat outputs."""
    from .layout import _ensure_types

    if not _ensure_types(graph):
        return 0
    vt = graph.value_types
    producers = graph.producers()
    changed = 0
    new_nodes: list[Node] = []
    dead: set[int] = set()
    for ln in graph.nodes:
        if ln.op_type != "LayerNormalization" or id(ln) in dead:
            continue
        if any(ln.outputs[1:]):
            continue
        t_in = vt.get(ln.inputs[0])
        if t_in is None:
            continue
        axis = ln.attr("axis", -1)
        if axis not in (-1, len(t_in.shape) - 1):
            continue
        add = producers.get(ln.inputs[0])
        if add is None or add.op_type != "Add" or id(add) in dead:
            continue
        a, b = add.inputs[0], add.inputs[1]
        if a in graph.initializers or b in graph.initializers:
            continue
        ta, tb = vt.get(a), vt.get(b)
        if ta is None or tb is None or ta.shape != tb.shape:
            continue
        beta = ln.inputs[2] if len(ln.inputs) > 2 and ln.inputs[2] else ""
        fused = Node(
            "SkipLayerNormalization",
            [a, b, ln.inputs[1], beta],
            [ln.outputs[0], "", "", add.outputs[0]],
            attrs={"epsilon": float(ln.attr("epsilon", 1e-5))},
            name=f"fsl_{ln.outputs[0]}", domain="com.microsoft")
        new_nodes.append(fused)
        dead.update((id(add), id(ln)))
        changed += 1
    if changed:
        graph.nodes = [n for n in graph.nodes if id(n) not in dead] + new_nodes
        graph.toposort()
        graph.value_types = {}
    return changed
