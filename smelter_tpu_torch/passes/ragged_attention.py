"""Fuse the decode-step attention chain into RaggedDecodeAttention.

Matches the static-cache masked attention every decode/verify graph
carries (models/llama_style.py::build_decode_step and its torch-export
equivalents): per layer,

    qh = Reshape(q)                          [+ Transpose for chunk>1]
    kh = Transpose(Reshape(k_cache_updated)) # (kvh, 1, hd, max_len)
    vh = Transpose(Reshape(v_cache_updated)) # (kvh, 1, max_len, hd)
    s  = MatMul(qh, kh) * scale
    s += Where(LessOrEqual(arange(max_len), pos-or-pos+rows), 0, -1e9)
    p  = Softmax(s, axis=-1)
    o  = Reshape([Transpose](MatMul(p, vh)))  # (c, dim)

and replaces it with one RaggedDecodeAttention(q, k, v, pos) node
(ops/fused_ops.py) whose lowering streams only the cache prefix at or
below `pos` (kernels/ragged_decode_attention.py) instead of reading all
max_len rows every step. The int8-KV form (k = Mul(CastLike(kq, .), ks))
fuses to the 6-input variant so the kernel reads the int8 cache directly.

Numerics-preserving by the pass contract: the plain lowering is the same
dense masked softmax; the kernel reorders the softmax reduction
(streaming) within float tolerance.

The port's copy of `smelter_tpu/passes/ragged_attention.py`, unchanged but
for this docstring.
"""

from __future__ import annotations

import numpy as np

from ..ir.graph import Graph, Node
from .decoder_fusion import _ensure_types
from .pass_manager import register_pass


def _scalar(a) -> float | None:
    if a is None:
        return None
    a = np.asarray(a)
    if a.size != 1:
        return None
    return float(a.reshape(-1)[0])


@register_pass("fuse_ragged_attention")
def fuse_ragged_attention(graph: Graph) -> int:
    if not _ensure_types(graph):
        return 0
    producers = graph.producers()
    consumers = graph.consumers()
    changed = 0
    dead: set[int] = set()

    def init(name):
        return graph.initializers.get(name)

    def prod(edge, op):
        n = producers.get(edge)
        if n is None or n.op_type != op or id(n) in dead:
            return None
        return n

    def sole(edge):
        return len(consumers.get(edge, [])) == 1

    def sole_consumer(edge, op):
        cs = consumers.get(edge, [])
        if len(cs) == 1 and cs[0].op_type == op and id(cs[0]) not in dead:
            return cs[0]
        return None

    def reshape_target(n):
        t = init(n.inputs[1]) if len(n.inputs) > 1 else None
        return None if t is None else [int(d) for d in t.reshape(-1)]

    for sm in list(graph.find_nodes("Softmax")):
        if id(sm) in dead or int(sm.attr("axis", -1)) not in (-1, 3):
            continue
        add = prod(sm.inputs[0], "Add")
        if add is None or not sole(sm.inputs[0]):
            continue
        # one side Mul(scores, scale), the other Where(valid, 0, -big)
        mul = prod(add.inputs[0], "Mul") or prod(add.inputs[1], "Mul")
        whr = prod(add.inputs[0], "Where") or prod(add.inputs[1], "Where")
        if (mul is None or whr is None or not sole(mul.outputs[0])
                or not sole(whr.outputs[0])):
            continue
        scale = (_scalar(init(mul.inputs[1]))
                 if init(mul.inputs[1]) is not None
                 else _scalar(init(mul.inputs[0])))
        zval = _scalar(init(whr.inputs[1]))
        nval = _scalar(init(whr.inputs[2]))
        if scale is None or zval != 0.0 or nval is None or nval > -1e8:
            continue
        le = prod(whr.inputs[0], "LessOrEqual")
        if le is None or not sole(whr.inputs[0]):
            continue
        ar = init(le.inputs[0])
        if ar is None or ar.ndim != 1:
            continue
        max_len = int(ar.shape[0])
        if not np.array_equal(ar, np.arange(max_len)):
            continue
        # right side: pos edge (c=1) or Add(Reshape(pos,[1,1]), arange(c))
        pos_edge = None
        c = 1
        rp = producers.get(le.inputs[1])
        if rp is not None and rp.op_type == "Add" and id(rp) not in dead:
            rsh = prod(rp.inputs[0], "Reshape")
            col = init(rp.inputs[1])
            if (rsh is not None and col is not None and col.ndim == 2
                    and col.shape[1] == 1 and sole(rp.inputs[0])
                    and np.array_equal(col.reshape(-1),
                                       np.arange(col.shape[0]))
                    and reshape_target(rsh) == [1, 1]):
                pos_edge = rsh.inputs[0]
                c = int(col.shape[0])
                le_extra = (rp, rsh)
            else:
                continue
        else:
            t = graph.value_types.get(le.inputs[1])
            if t is None or t.shape is None or tuple(t.shape) != (1,):
                continue
            pos_edge = le.inputs[1]
            le_extra = ()

        # scores = MatMul(qh, kh)
        mm_in = (mul.inputs[0] if init(mul.inputs[1]) is not None
                 else mul.inputs[1])
        mm = prod(mm_in, "MatMul")
        if mm is None or not sole(mm_in):
            continue
        qh_e, kh_e = mm.inputs[0], mm.inputs[1]
        # qh: c=1 Reshape(q, [kvh,g,1,hd]); c>1 Transpose(Reshape(q,
        # [c,kvh,g,hd]), (1,2,0,3))
        kvh = g = hd = None
        if c == 1:
            qrs = prod(qh_e, "Reshape")
            if qrs is None or not sole(qh_e):
                continue
            tgt = reshape_target(qrs)
            if tgt is None or len(tgt) != 4 or tgt[2] != 1:
                continue
            kvh, g, _, hd = tgt
            q_edge = qrs.inputs[0]
            q_dead = (qrs,)
        else:
            qtr = prod(qh_e, "Transpose")
            if (qtr is None or not sole(qh_e)
                    or [int(p) for p in qtr.attr("perm", [])] != [1, 2, 0, 3]):
                continue
            qrs = prod(qtr.inputs[0], "Reshape")
            if qrs is None or not sole(qtr.inputs[0]):
                continue
            tgt = reshape_target(qrs)
            if tgt is None or len(tgt) != 4 or tgt[0] != c:
                continue
            _, kvh, g, hd = tgt
            q_edge = qrs.inputs[0]
            q_dead = (qrs, qtr)

        def cache_operand(edge, perm):
            """Transpose(Reshape(x, [L,kvh,1,hd]), perm) -> x, dead."""
            tr = prod(edge, "Transpose")
            if (tr is None or not sole(edge)
                    or [int(p) for p in tr.attr("perm", [])] != perm):
                return None, ()
            rs = prod(tr.inputs[0], "Reshape")
            if rs is None or not sole(tr.inputs[0]):
                return None, ()
            tgt = reshape_target(rs)
            if tgt != [max_len, kvh, 1, hd]:
                return None, ()
            return rs.inputs[0], (rs, tr)

        k_edge, k_dead = cache_operand(kh_e, [1, 2, 3, 0])
        if k_edge is None:
            continue
        # ctx = MatMul(p, vh) [-> Transpose (2,0,1,3)] -> Reshape (c, dim)
        mm2 = sole_consumer(sm.outputs[0], "MatMul")
        if mm2 is None or mm2.inputs[0] != sm.outputs[0]:
            continue
        v_edge, v_dead = cache_operand(mm2.inputs[1], [1, 2, 0, 3])
        if v_edge is None:
            continue
        tail = mm2
        tail_dead: tuple = ()
        if c > 1:
            tr2 = sole_consumer(mm2.outputs[0], "Transpose")
            if (tr2 is None
                    or [int(p) for p in tr2.attr("perm", [])] != [2, 0, 1, 3]):
                continue
            tail = tr2
            tail_dead = (tr2,)
        out_rs = sole_consumer(tail.outputs[0], "Reshape")
        if out_rs is None:
            continue
        tgt = reshape_target(out_rs)
        if tgt is None or len(tgt) != 2 or tgt != [c, kvh * g * hd]:
            continue

        # int8-KV caches: k/v edges produced by Mul(CastLike(kq, .), ks)
        def quant_operand(edge):
            mq = producers.get(edge)
            if (mq is None or mq.op_type != "Mul" or id(mq) in dead
                    or not sole(edge)):
                return None
            cl = prod(mq.inputs[0], "CastLike")
            if cl is None or not sole(mq.inputs[0]):
                return None
            tq = graph.value_types.get(cl.inputs[0])
            ts = graph.value_types.get(mq.inputs[1])
            if (tq is None or ts is None or tq.np_dtype != np.int8
                    or ts.shape is None or tuple(ts.shape) != (max_len, 1)):
                return None
            return cl.inputs[0], mq.inputs[1], (mq, cl)

        kq = quant_operand(k_edge)
        vq = quant_operand(v_edge)
        quant_dead: tuple = ()
        if kq is not None and vq is not None:
            inputs = [q_edge, kq[0], kq[1], vq[0], vq[1], pos_edge]
            quant_dead = kq[2] + vq[2]
        else:
            inputs = [q_edge, k_edge, v_edge, pos_edge]

        fused = Node(
            "RaggedDecodeAttention", inputs=inputs,
            outputs=list(out_rs.outputs),
            attrs={"num_heads": int(kvh * g), "kv_heads": int(kvh),
                   "chunk": int(c), "scale": float(scale)},
            name=(sm.name or "attn") + "_ragged")
        graph.nodes[graph.nodes.index(out_rs)] = fused
        for n in (sm, add, mul, whr, le, mm, mm2, *le_extra, *q_dead,
                  *k_dead, *v_dead, *tail_dead, *quant_dead):
            dead.add(id(n))
        changed += 1

    if changed:
        graph.nodes = [n for n in graph.nodes if id(n) not in dead]
        graph.toposort()
        graph.dead_code_eliminate()
        graph.value_types = {}
    return changed
