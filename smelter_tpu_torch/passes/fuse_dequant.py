"""Fuse DequantizeLinear into matmul-family consumers.

Rewrites DequantizeLinear(w_q, s) -> MatMul/Gemm chains into the internal
FusedDequantMatMul op, whose lowering (ops/fused_ops.py) runs the port's
dequant_matmul or int8_matmul kernel on the card, and grouped 4-bit chains
into FusedDequantMatMulI4 (the int4_matmul kernel). This removes the
materialized fp32 weight tensor: the int8 weight is the only resident copy.

Gemm(transB=1) weights are pre-transposed to (K, N) on the host at pass
time (a one-time cost) so both forms share one kernel layout.

The port's copy of `smelter_tpu/passes/fuse_dequant.py`; `pack_int4_half`
moved here from the JAX package's int4 kernel module.
"""

from __future__ import annotations

import numpy as np

from ..ir.graph import Graph, Node
from ..quant.weight_quant import is_int4_graph
from .pass_manager import register_pass


def pack_int4_half(w4: np.ndarray) -> np.ndarray:
    """Pack an int8 array of 4-bit values (K, N), K even, into (K/2, N)
    int8: row r carries w4[r] (lo nibble) and w4[r + K/2] (hi nibble)."""
    k = w4.shape[0]
    assert k % 2 == 0, k
    lo = w4[: k // 2] & 0xF
    hi = (w4[k // 2:] & 0xF) << 4
    return (lo | hi).astype(np.int8)


@register_pass("fuse_dequant_matmul")
def fuse_dequant_matmul(graph: Graph) -> int:
    changed = 0
    producers = graph.producers()
    consumers = graph.consumers()
    new_nodes: list[Node] = []
    dead: set[int] = set()
    for node in graph.nodes:
        fused = None
        if node.op_type in ("MatMul", "Gemm") and len(node.inputs) >= 2:
            dq = producers.get(node.inputs[1])
            if (
                dq is not None
                and dq.op_type == "DequantizeLinear"
                and len(dq.inputs) == 2  # no zero-point (symmetric)
                and not dq.attr("block_size")  # grouped scales: XLA path
                and dq.inputs[0] in graph.initializers
                and dq.inputs[1] in graph.initializers
            ):
                q = graph.initializers[dq.inputs[0]]
                s = graph.initializers[dq.inputs[1]]
                axis = dq.attr("axis", 1)
                if axis < 0:
                    axis += q.ndim
                if q.ndim == 2 and q.dtype == np.int8:
                    fused = _build_fused(graph, node, dq, q, s, axis)
        if fused is None and node.op_type in ("MatMul", "Gemm") \
                and len(node.inputs) >= 2:
            dq = producers.get(node.inputs[1])
            if (
                dq is not None
                and dq.op_type == "DequantizeLinear"
                and len(dq.inputs) == 2
                and dq.attr("block_size")
                and dq.inputs[0] in graph.initializers
                and dq.inputs[1] in graph.initializers
            ):
                fused = _build_fused_i4(graph, node, dq)
        if fused is not None:
            new_nodes.extend(fused)
            # Drop the DequantizeLinear if this was its only consumer.
            dq_out = node.inputs[1]
            if len(consumers.get(dq_out, [])) == 1:
                dead.add(id(producers[dq_out]))
            changed += 1
        else:
            new_nodes.append(node)
    if changed:
        graph.nodes = [n for n in new_nodes if id(n) not in dead]
        graph.toposort()
    return changed


def _build_fused_i4(graph: Graph, node: Node, dq: Node) -> list[Node] | None:
    """Blocked (grouped) int4 DequantizeLinear + MatMul/Gemm -> the
    FusedDequantMatMulI4 internal op: the 4-bit weight packs host-side
    into half-split int8 nibbles (kernels/int4_matmul.py layout) so the
    kernel unpacks them on their way to the tensor cores. The port holds
    4-bit values as int8, marked 4-bit by the graph's quant mode
    (quant/weight_quant.py::is_int4_graph)."""
    q = graph.initializers[dq.inputs[0]]
    s = graph.initializers[dq.inputs[1]]
    if q.ndim != 2 or q.dtype != np.int8 or not is_int4_graph(graph):
        return None
    group = int(dq.attr("block_size"))
    axis = int(dq.attr("axis", 1)) % 2
    trans_b = 0
    if node.op_type == "Gemm":
        if node.attr("transA", 0) or node.attr("alpha", 1.0) != 1.0:
            return None
        if node.attr("beta", 1.0) != 1.0 and len(node.inputs) > 2:
            return None
        trans_b = node.attr("transB", 0)
    if trans_b:
        if axis != 1:
            return None  # (N, K): groups must run along K
        q, s = q.T, np.asarray(s).T
    elif axis != 0:
        return None  # (K, N): groups along K (axis 0) only
    k, n = q.shape
    if s.shape != (-(-k // group), n):
        return None
    if k % (2 * group) or n % 128 or group % 32:
        return None  # kernel layout gates; the XLA path keeps the rest
    pk = pack_int4_half(np.ascontiguousarray(q).astype(np.int8))
    pk_name = graph.fresh_name(dq.inputs[0] + "_pk4")
    s_name = graph.fresh_name(dq.inputs[1] + "_g")
    graph.initializers[pk_name] = pk
    graph.initializers[s_name] = np.ascontiguousarray(s, np.float32)
    mm_out = graph.fresh_name(node.outputs[0] + "_mm")
    bias = node.inputs[2] if (node.op_type == "Gemm"
                              and len(node.inputs) > 2
                              and node.inputs[2]) else None
    nodes = [Node(
        "FusedDequantMatMulI4",
        inputs=[node.inputs[0], pk_name, s_name],
        outputs=[mm_out if bias else node.outputs[0]],
        attrs={"group": group},
        name=node.name + "_fdq4",
    )]
    if bias:
        nodes.append(Node("Add", inputs=[mm_out, bias],
                          outputs=list(node.outputs),
                          name=node.name + "_bias"))
    return nodes


def _build_fused(graph: Graph, node: Node, dq: Node, q: np.ndarray, s: np.ndarray,
              axis: int) -> list[Node] | None:
    """Build replacement nodes for one matmul/gemm, or None if ineligible."""
    s = np.asarray(s, np.float32).reshape(-1)
    if node.op_type == "MatMul":
        if axis != q.ndim - 1:
            return None  # scales must be per output column
        kq, n_out = q.shape
        q_name, s_name = dq.inputs[0], dq.inputs[1]
        return [Node(
            "FusedDequantMatMul",
            inputs=[node.inputs[0], q_name, s_name],
            outputs=list(node.outputs),
            name=node.name + "_fdq",
        )]
    # Gemm: only the common inference form (transA=0, alpha=beta=1).
    if node.attr("transA", 0) or node.attr("alpha", 1.0) != 1.0:
        return None
    if node.attr("beta", 1.0) != 1.0 and len(node.inputs) > 2:
        return None
    trans_b = node.attr("transB", 0)
    if trans_b:
        if axis != 0:
            return None  # (N, K) with per-N scales on axis 0
        q_t = np.ascontiguousarray(q.T)  # -> (K, N)
    else:
        if axis != 1:
            return None
        q_t = q
    qt_name = graph.fresh_name(dq.inputs[0] + "_t")
    graph.initializers[qt_name] = q_t
    s_name = dq.inputs[1]
    mm_out = graph.fresh_name(node.outputs[0] + "_mm")
    nodes = [Node(
        "FusedDequantMatMul",
        inputs=[node.inputs[0], qt_name, s_name],
        outputs=[mm_out if len(node.inputs) > 2 and node.inputs[2] else node.outputs[0]],
        name=node.name + "_fdq",
    )]
    if len(node.inputs) > 2 and node.inputs[2]:
        nodes.append(Node(
            "Add", inputs=[mm_out, node.inputs[2]], outputs=list(node.outputs),
            name=node.name + "_bias",
        ))
    return nodes


@register_pass("fuse_dequant_conv1x1")
def fuse_dequant_conv1x1(graph: Graph) -> int:
    """In NHWC graphs, a 1x1 stride-1 ungrouped Conv is a GEMM over the
    flattened (N*H*W, Cin) activations: rewrite
    DequantizeLinear(w_q HWIO 1x1) -> Conv  into
    Reshape -> FusedDequantMatMul -> Reshape (+ bias Add), so the int8
    weight feeds the fused matmul kernel directly. Requires the layout
    pass to have run (metadata layout=nhwc) and value_types populated."""
    if graph.metadata.get("layout") != "nhwc":
        return 0
    if not graph.value_types:
        from ..ir.errors import SmelterError
        from ..runtime.executor import Executor

        try:
            Executor(graph).infer_value_types()
        except SmelterError:
            return 0
    changed = 0
    producers = graph.producers()
    consumers = graph.consumers()
    new_nodes: list[Node] = []
    dead: set[int] = set()
    for node in graph.nodes:
        if (
            node.op_type == "Conv"
            and node.attr("data_layout") == "NHWC"
            and int(node.attr("group", 1)) == 1
            and list(node.attr("strides", [1, 1])) == [1, 1]
            and list(node.attr("dilations", [1, 1])) == [1, 1]
            and all(p == 0 for p in node.attr("pads", [0, 0, 0, 0]))
        ):
            dq = producers.get(node.inputs[1])
            x_t = graph.value_types.get(node.inputs[0])
            if (
                dq is not None and dq.op_type == "DequantizeLinear"
                and len(dq.inputs) == 2
                and dq.inputs[0] in graph.initializers
                and dq.inputs[1] in graph.initializers
                and int(dq.attr("axis", 1)) == 3
                and x_t is not None and len(x_t.shape) == 4
            ):
                q = graph.initializers[dq.inputs[0]]  # HWIO, 1x1
                if q.ndim == 4 and q.shape[0] == 1 and q.shape[1] == 1:
                    n_, h_, w_, cin = x_t.shape
                    cout = q.shape[3]
                    q2_name = graph.fresh_name(dq.inputs[0] + "_2d")
                    graph.initializers[q2_name] = np.ascontiguousarray(
                        q.reshape(cin, cout))
                    flat_spec = graph.fresh_name("c1x1_in_shape")
                    graph.initializers[flat_spec] = np.asarray(
                        [n_ * h_ * w_, cin], np.int64)
                    out_spec = graph.fresh_name("c1x1_out_shape")
                    graph.initializers[out_spec] = np.asarray(
                        [n_, h_, w_, cout], np.int64)
                    flat = graph.fresh_name(node.outputs[0] + "_flat")
                    mm = graph.fresh_name(node.outputs[0] + "_mm")
                    has_bias = len(node.inputs) > 2 and node.inputs[2]
                    mm_out = graph.fresh_name(node.outputs[0] + "_r") if has_bias \
                        else node.outputs[0]
                    new_nodes.append(Node("Reshape", [node.inputs[0], flat_spec],
                                          [flat], name=node.name + "_fl"))
                    new_nodes.append(Node(
                        "FusedDequantMatMul", [flat, q2_name, dq.inputs[1]],
                        [mm], name=node.name + "_fdq"))
                    new_nodes.append(Node("Reshape", [mm, out_spec], [mm_out],
                                          name=node.name + "_rs"))
                    if has_bias:
                        new_nodes.append(Node("Add", [mm_out, node.inputs[2]],
                                              [node.outputs[0]],
                                              name=node.name + "_b"))
                    if len(consumers.get(node.inputs[1], [])) == 1:
                        dead.add(id(dq))
                    changed += 1
                    continue
        new_nodes.append(node)
    if changed:
        graph.nodes = [n for n in new_nodes if id(n) not in dead]
        graph.toposort()
    return changed
