"""Calibration and the full static int8 rewrite: `calibrate`, the per-edge
abs-max of a graph's float activations over sample inputs, and
`quantize_static`, which rewrites the graph to QLinear ops on those ranges.

The port's counterpart of `smelter_tpu/quant/static_quant.py`.

    amax = calibrate(graph, sample_batches)       # per-edge abs-max
    quantize_static(graph, amax)                  # rewrite to QLinearConv/...

`calibrate` runs the same lowerings the compiled model runs, through the
executor's return-all-edges walk, on the configuration's device, so
observed ranges are exactly what the runtime computes. Each edge's abs-max
is taken on the device and the maxima of one sample come back to the host
together; a percentile needs the values on the host, subsampled there as
the JAX package does.

`quantize_static` is a copy of the JAX package's rewrite (numpy only), so
that the same amax gives the same graph, node for node and initializer for
initializer. The scheme: symmetric, zero points 0, per-tensor activation
scales, per-channel weight scales.

- Conv/Gemm/MatMul nodes with weight initializers become QLinearConv /
  QLinearMatMul. Activations entering a quantized node get a
  QuantizeLinear; an int8 edge consumed by a float op gets a
  DequantizeLinear. Consecutive quantized ops chain in int8.
- Relu and MaxPool are quant-transparent (monotonic, zero-preserving under
  zero point 0): they run directly on int8, no requant.
- Everything else (residual Adds, averaging pools, norms, softmax) stays
  float: int8 edges are dequantized at the boundary.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ir.graph import Graph, Node
from .weight_quant import quantize_array

_SUBSAMPLE = 1 << 20  # values a percentile reads at most from one edge

QUANT_TARGETS = ("Conv", "Gemm", "MatMul")
TRANSPARENT = ("Relu", "MaxPool")


def calibrate(graph: Graph, sample_inputs: list[tuple[np.ndarray, ...]],
              config=None, percentile: float | None = None) -> dict[str, float]:
    """Run `sample_inputs` (a list of graph-input tuples) through the graph
    and record each float edge's |value| range (the max over samples).
    percentile (e.g. 99.9) clips outliers: it trades saturation of rare
    extremes for resolution of the bulk. Initializers are not edges."""
    from ..runtime.executor import Executor

    ex = Executor(graph, config)
    fn = ex.build_fn(return_all_edges=True)
    params = ex.cast_params(ex.init_params())
    amax: dict[str, float] = {}
    for inputs in sample_inputs:
        env = fn(params, *inputs)
        names, maxima = [], []
        for name, val in env.items():
            if name in graph.initializers or not isinstance(val, torch.Tensor) \
                    or not val.dtype.is_floating_point:
                continue
            if val.numel() == 0:
                m = torch.zeros((), device=val.device)
            elif percentile is not None:
                flat = val.detach().abs().reshape(-1)
                if flat.numel() > _SUBSAMPLE:
                    flat = flat[:: flat.numel() // _SUBSAMPLE + 1]
                m = torch.tensor(float(np.percentile(flat.float().cpu().numpy(), percentile)))
            else:
                m = val.detach().abs().amax().float()
            names.append(name)
            maxima.append(m.to(val.device))
        del env
        if not names:
            continue
        host = torch.stack(maxima).cpu().tolist()
        for name, m in zip(names, host):
            amax[name] = max(amax.get(name, 0.0), float(m))
    return amax


def _scale_for(amax: dict[str, float], name: str) -> float | None:
    m = amax.get(name)
    if m is None or m == 0.0:
        return None
    return m / 127.0


def quantize_static(
    graph: Graph,
    amax: dict[str, float],
    targets: tuple[str, ...] = QUANT_TARGETS,
    min_elements: int = 1024,
    int8_carry: bool = True,
) -> int:
    """Rewrite eligible nodes to QLinear ops using calibrated scales.
    Returns the number of nodes quantized. int8_carry additionally
    requantizes residual carries (see _requantize_carries)."""
    changed = 0
    # int8 view of an edge: name -> (q_edge_name, scale)
    int8_edges: dict[str, tuple[str, float]] = {}
    new_nodes: list[Node] = []

    def fresh(base: str) -> str:
        return graph.fresh_name(base)

    def add_init(name_hint: str, arr: np.ndarray) -> str:
        n = fresh(name_hint)
        graph.initializers[n] = arr
        return n

    def get_int8(x_name: str) -> tuple[str, str, str] | None:
        """Return (q_edge, scale_init, zp_init) for edge `x_name`."""
        if x_name not in int8_edges:
            s = _scale_for(amax, x_name)
            if s is None:
                return None
            q_edge = fresh(x_name + "_q")
            s_init = add_init(x_name + "_xs", np.float32(s))
            z_init = add_init(x_name + "_xz", np.int8(0))
            new_nodes.append(Node("QuantizeLinear", [x_name, s_init, z_init],
                                  [q_edge], name=q_edge))
            int8_edges[x_name] = (q_edge, s, s_init, z_init)
        q_edge, s, s_init, z_init = int8_edges[x_name]
        return q_edge, s_init, z_init

    for node in graph.nodes:
        handled = False
        if node.op_type in targets and len(node.inputs) >= 2:
            w = graph.initializers.get(node.inputs[1])
            y_scale = _scale_for(amax, node.outputs[0])
            x_scale = _scale_for(amax, node.inputs[0])
            eligible = (
                w is not None and w.dtype == np.float32
                and w.size >= min_elements
                and y_scale is not None and x_scale is not None
            )
            if node.op_type == "Gemm" and (
                node.attr("transA", 0) or node.attr("alpha", 1.0) != 1.0
                or (node.attr("beta", 1.0) != 1.0 and len(node.inputs) > 2)
            ):
                eligible = False
            if node.op_type == "MatMul" and (w is None or w.ndim != 2):
                eligible = False
            if eligible:
                xq = get_int8(node.inputs[0])
                if xq is not None:
                    q_x, xs_i, xz_i = xq
                    if node.op_type == "Conv":
                        axis = 0
                        wq, wscale = quantize_array(w, axis)
                        w_i = add_init(node.inputs[1] + "_wq", wq)
                        ws_i = add_init(node.inputs[1] + "_ws",
                                        wscale.reshape(-1).astype(np.float32))
                        wz_i = add_init(node.inputs[1] + "_wz",
                                        np.zeros(wq.shape[0], np.int8))
                    else:
                        if node.op_type == "Gemm" and node.attr("transB", 0):
                            w2 = np.ascontiguousarray(w.T)
                        else:
                            w2 = w
                        wq, wscale = quantize_array(w2, 1)
                        w_i = add_init(node.inputs[1] + "_wq", wq)
                        ws_i = add_init(node.inputs[1] + "_ws",
                                        wscale.reshape(-1).astype(np.float32))
                        wz_i = add_init(node.inputs[1] + "_wz",
                                        np.zeros(wq.shape[1], np.int8))
                    ys_i = add_init(node.outputs[0] + "_ys", np.float32(y_scale))
                    yz_i = add_init(node.outputs[0] + "_yz", np.int8(0))
                    q_out = fresh(node.outputs[0] + "_q")

                    if node.op_type == "Conv":
                        ins = [q_x, xs_i, xz_i, w_i, ws_i, wz_i, ys_i, yz_i]
                        if len(node.inputs) > 2 and node.inputs[2]:
                            bias = graph.initializers[node.inputs[2]]
                            x_s = float(np.float32(amax[node.inputs[0]] / 127.0))
                            bq = np.round(
                                bias / (x_s * wscale.reshape(-1))).astype(np.int32)
                            ins.append(add_init(node.inputs[2] + "_bq", bq))
                        qnode = Node("QLinearConv", ins, [q_out],
                                     attrs={k: v for k, v in node.attrs.items()},
                                     name=node.name + "_ql")
                        new_nodes.append(qnode)
                        out_edge = q_out
                    else:
                        ins = [q_x, xs_i, xz_i, w_i, ws_i, wz_i, ys_i, yz_i]
                        new_nodes.append(Node("QLinearMatMul", ins, [q_out],
                                              name=node.name + "_ql"))
                        out_edge = q_out
                        if node.op_type == "Gemm" and len(node.inputs) > 2 and node.inputs[2]:
                            # bias stays float: dequant, add, (consumers see float)
                            deq = fresh(node.outputs[0] + "_dq")
                            new_nodes.append(Node(
                                "DequantizeLinear", [q_out, ys_i, yz_i], [deq],
                                name=deq))
                            new_nodes.append(Node(
                                "Add", [deq, node.inputs[2]], [node.outputs[0]],
                                name=node.name + "_b"))
                            int8_edges.pop(node.outputs[0], None)
                            changed += 1
                            handled = True
                    if handled:
                        continue
                    int8_edges[node.outputs[0]] = (out_edge, y_scale, ys_i, yz_i)
                    # float consumers get a DequantizeLinear under the original name
                    new_nodes.append(Node(
                        "DequantizeLinear", [out_edge, ys_i, yz_i],
                        [node.outputs[0]], name=node.outputs[0] + "_dq"))
                    changed += 1
                    continue
        if node.op_type in TRANSPARENT and node.inputs[0] in int8_edges:
            # run transparently on the int8 edge as well
            q_in, s, s_i, z_i = int8_edges[node.inputs[0]]
            q_out = fresh(node.outputs[0] + "_q")
            new_nodes.append(Node(node.op_type, [q_in], [q_out],
                                  attrs=dict(node.attrs), name=node.name + "_q"))
            int8_edges[node.outputs[0]] = (q_out, s, s_i, z_i)
            # keep the float version too (computed from the float input edge)
            new_nodes.append(node)
            continue
        new_nodes.append(node)

    graph.nodes = new_nodes
    graph.toposort()
    graph.dead_code_eliminate()
    if changed:
        if int8_carry:
            _requantize_carries(
                graph,
                {e: (q, s_i, z_i) for e, (q, _s, s_i, z_i)
                 in int8_edges.items()})
        graph.metadata["quant"] = "int8-static"
    return changed


# Elementwise float producers whose forked output is a residual-style
# carry; anything else (norms, softmax, heads) keeps the float fork.
_CARRY_PRODUCERS = ("Add", "Relu", "Clip", "LeakyRelu", "Mul")


def _requantize_carries(graph: Graph,
                        int8_twins: dict[str, tuple[str, str, str]]) -> int:
    """Keep residual carries in int8: when a float edge with an int8 twin
    (via an explicit QuantizeLinear or a quant-transparent twin op) also
    feeds float consumers (the residual fork), rewire those consumers to
    read DequantizeLinear(q_edge) instead.

    Without this, every residual join reads a full-size float tensor that
    was written only for the fork. With it, the shortcut sees exactly the
    int8-grid values the conv path already consumes (the TensorRT / TFLite
    convention), so it adds no quantization error against the conv path.
    """
    producers = graph.producers()
    consumers = graph.consumers()
    out_names = {vi.name for vi in graph.outputs}
    changed = 0
    added: list[Node] = []
    for e, (q_edge, s_i, z_i) in int8_twins.items():
        if e in out_names or e in graph.initializers:
            continue
        prod = producers.get(e)
        if prod is None or prod.op_type not in _CARRY_PRODUCERS:
            continue
        forks = [c for c in consumers.get(e, [])
                 if not (c.op_type == "QuantizeLinear"
                         and c.outputs[0] == q_edge)]
        if not forks:
            continue
        dq_edge = graph.fresh_name(e + "_c8")
        added.append(Node("DequantizeLinear", [q_edge, s_i, z_i],
                          [dq_edge], name=dq_edge))
        for c in forks:
            c.inputs = [dq_edge if x == e else x for x in c.inputs]
        changed += 1
    if changed:
        graph.nodes.extend(added)
        graph.toposort()
        graph.dead_code_eliminate()
    return changed
