"""Calibrated int8 quantization of NHCW pixel-conv regions: the port's copy
of `smelter_tpu/quant/pixel_quant.py`, rewriting PixelConv trunks into int8
PixelConvQ chains from `calibrate()`'s per-edge abs-max.

Scheme:

- One shared symmetric activation scale per NHCW region (a connected
  component of PixelConv nodes linked through Concat/PixelNearestUp
  bridges), so that the dense blocks' Concats stay valid in int8:
  S_region = max over the region's int8 edges' amax / 127.
- Weights: per-output-channel symmetric int8 (quantize_array, axis 0); the
  kernel's `scales` input carries S_region * w_scale[c_out], so the int32
  sum dequantizes in one multiply.
- A conv whose output feeds another region conv (through Concat or
  PixelNearestUp or directly) requantizes in its epilogue (`requant=1`)
  and the int8 edge flows on; float consumers read a DequantizeLinear twin
  of it. A conv feeding only float ops returns floats (`requant=0`).
- Region entries (float edges produced outside) get one QuantizeLinear at
  S_region, memoized per (edge, scale), before any PixelNearestUp.

Engaged by `compile(..., quant="int8-pixel", calibration_data=...)` after
the default pipeline (pixel_conv_regions must have run). Regions with
uncalibrated edges are skipped, never guessed.
"""

from __future__ import annotations

import numpy as np

from ..ir.graph import Graph, Node
from .weight_quant import quantize_array

_BRIDGES = ("Concat", "PixelNearestUp")


class _UnionFind:
    def __init__(self):
        self.parent: dict[int, int] = {}

    def add(self, i: int) -> None:
        self.parent.setdefault(i, i)

    def find(self, i: int) -> int:
        while self.parent[i] != i:
            self.parent[i] = self.parent[self.parent[i]]
            i = self.parent[i]
        return i

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


def quantize_pixel_regions(graph: Graph, amax: dict[str, float]) -> int:
    """Rewrite PixelConv trunks to int8 PixelConvQ chains using calibrated
    per-edge amax (from quant.calibrate on the SAME optimized graph, so
    edge names match). Returns the number of convs quantized."""
    convs = [n for n in graph.nodes
             if n.op_type == "PixelConv"
             and n.inputs[1] in graph.initializers
             and graph.initializers[n.inputs[1]].dtype == np.float32]
    if not convs:
        return 0
    conv_ids = {id(n) for n in convs}

    # -- regions: union-find over convs + bridge ops, linked by edges ----
    uf = _UnionFind()
    src: dict[str, int] = {}        # edge -> producing conv/bridge node id
    node_of: dict[int, Node] = {}
    for node in graph.nodes:
        if id(node) in conv_ids:
            uf.add(id(node))
            node_of[id(node)] = node
            s = src.get(node.inputs[0])
            if s is not None:
                uf.union(id(node), s)
            src[node.outputs[0]] = id(node)
        elif node.op_type in _BRIDGES:
            uf.add(id(node))
            node_of[id(node)] = node
            for e in node.inputs:
                if e in src:
                    uf.union(id(node), src[e])
            src[node.outputs[0]] = id(node)

    region_convs: dict[int, list[Node]] = {}
    for i, node in node_of.items():
        if i in conv_ids:
            region_convs.setdefault(uf.find(i), []).append(node)
    has_convs = set(region_convs)

    # -- which edges must exist in int8 (reverse reachability) -----------
    # Structural (scale-independent): regions are disjoint connected
    # components and a conv/bridge's producers always union into the same
    # region, so neededness never leaks across regions.
    needed: set[str] = set()
    for node in reversed(graph.nodes):
        if id(node) in conv_ids and uf.find(id(node)) in has_convs:
            needed.add(node.inputs[0])
        elif (node.op_type in _BRIDGES and id(node) in node_of
              and uf.find(id(node)) in has_convs
              and node.outputs[0] in needed):
            needed.update(e for e in node.inputs if e)

    # -- per-region shared activation scale ------------------------------
    # Max over the edges that actually live on the int8 grid: conv inputs
    # plus inputs of bridges whose output is needed. A requant=0 conv
    # output never exists in int8, so its amax must neither coarsen the
    # region's grid nor (when uncalibrated) skip the region; a requant=1
    # output is some downstream conv/bridge's input and is already counted
    # there.
    scale_edges: dict[int, set[str]] = {}
    for i, node in node_of.items():
        r = uf.find(i)
        if r not in has_convs:
            continue
        es = scale_edges.setdefault(r, set())
        if i in conv_ids:
            es.add(node.inputs[0])
        elif node.outputs[0] in needed:
            es.update(e for e in node.inputs
                      if e and e not in graph.initializers)
    scale: dict[int, float] = {}
    for r, edges in scale_edges.items():
        ms = [amax.get(e) for e in edges]
        if any(m is None or m <= 0.0 for m in ms):
            continue  # uncalibrated region: skip, never guess
        scale[r] = max(ms) / 127.0

    q_convs = {id(n) for r, ns in region_convs.items() if r in scale
               for n in ns}
    if not q_convs:
        return 0

    # -- rewrite ----------------------------------------------------------
    # int8_map is keyed by (edge, scale), NOT edge alone: a float entry
    # edge shared by convs in two disjoint regions must get one
    # QuantizeLinear PER region scale — memoizing by name alone would
    # reuse region 1's int8 grid while region 2 dequantizes at its own
    # scale, silently scaling results by s2/s1.
    int8_map: dict[tuple[str, float], str] = {}
    new_nodes: list[Node] = []
    changed = 0

    def add_init(hint: str, arr: np.ndarray) -> str:
        name = graph.fresh_name(hint)
        graph.initializers[name] = arr
        return name

    def ensure_q(edge: str, s: float) -> str:
        if (edge, s) in int8_map:
            return int8_map[(edge, s)]
        q = graph.fresh_name(edge + "_q8")
        s_i = add_init(edge + "_xs", np.float32(s))
        z_i = add_init(edge + "_xz", np.int8(0))
        new_nodes.append(Node("QuantizeLinear", [edge, s_i, z_i], [q],
                              name=q))
        int8_map[(edge, s)] = q
        return q

    for node in graph.nodes:
        if id(node) in q_convs:
            s = scale[uf.find(id(node))]
            xq = ensure_q(node.inputs[0], s)
            w = graph.initializers[node.inputs[1]]
            wq, ws = quantize_array(w, 0)
            w_i = add_init(node.inputs[1] + "_wq", wq)
            sc_i = add_init(node.inputs[1] + "_sc",
                            (s * ws.reshape(-1)).astype(np.float32))
            attrs = {"data_layout": "NHCW", "inv_sy": 1.0 / s}
            if "alpha" in node.attrs:
                attrs["alpha"] = float(node.attrs["alpha"])
            out = node.outputs[0]
            if out in needed:
                attrs["requant"] = 1
                qo = graph.fresh_name(out + "_q8")
                new_nodes.append(Node("PixelConvQ",
                                      [xq, w_i, sc_i, node.inputs[2]],
                                      [qo], attrs,
                                      name=f"pq_{node.name or out}"))
                int8_map[(out, s)] = qo
                ys_i = add_init(out + "_ys", np.float32(s))
                yz_i = add_init(out + "_yz", np.int8(0))
                new_nodes.append(Node("DequantizeLinear",
                                      [qo, ys_i, yz_i], [out],
                                      name=out + "_dq"))
            else:
                attrs["requant"] = 0
                new_nodes.append(Node("PixelConvQ",
                                      [xq, w_i, sc_i, node.inputs[2]],
                                      [out], attrs,
                                      name=f"pq_{node.name or out}"))
            changed += 1
            continue
        if (node.op_type in _BRIDGES and id(node) in node_of
                and uf.find(id(node)) in scale
                and node.outputs[0] in needed):
            s = scale[uf.find(id(node))]
            qins = [ensure_q(e, s) for e in node.inputs if e]
            qo = graph.fresh_name(node.outputs[0] + "_q8")
            new_nodes.append(Node(node.op_type, qins, [qo],
                                  dict(node.attrs),
                                  name=f"q_{node.name or qo}"))
            int8_map[(node.outputs[0], s)] = qo
            new_nodes.append(node)  # float twin; DCE removes if unused
            continue
        new_nodes.append(node)

    graph.nodes = new_nodes
    graph.toposort()
    graph.dead_code_eliminate()
    graph.value_types = {}
    if changed:
        graph.metadata["quant"] = "int8-pixel"
    return changed
