"""NCHW -> NHWC layout pass for 4-D activation graphs.

SURVEY.md §7: "offline importer pass: transpose to TPU-friendly layout
(channels-last)". The TPU MXU/VPU want the channel dimension on the
128-lane minor axis; NHWC activations with HWIO weights avoid the
relayout copies XLA otherwise inserts around every conv. This is the
TPU analog of the reference's offline OHWI weight swizzle + runtime
relayout (reference: ONNX2MPS.py:70-79, Array+Extensions.swift:52-94) —
done once at graph level, never at runtime.

Mechanics (lazy materialization):
- every edge has a *preferred* layout, set by its producer;
- CONVERT ops (conv/pool/norm/resize) are rewritten with
  data_layout=NHWC; their weight initializers are permuted offline
  (OIHW->HWIO via the native library; int8 DequantizeLinear weights are
  permuted with their axis remapped);
- AGNOSTIC ops (activations, binary, concat, pad, softmax...) follow
  their inputs, with channel-axis attributes remapped via
  {0:0, 1:3, 2:1, 3:2} and broadcast initializers transposed;
- everything else is a BARRIER: inputs are materialized back to NCHW
  (a Transpose is inserted, memoized per edge);
- graph inputs stay NCHW (user contract), outputs are returned in NCHW.

Transposes only appear at genuine layout boundaries; chains of
NHWC-compatible ops carry no transposes at all.
"""

from __future__ import annotations

import numpy as np

from ..ir.graph import Graph, Node
from .pass_manager import register_pass

_AXIS_MAP = {0: 0, 1: 3, 2: 1, 3: 2}  # NCHW axis -> NHWC position
_TO_NHWC = [0, 2, 3, 1]
_TO_NCHW = [0, 3, 1, 2]

# Ops rewritten to native NHWC execution (4-D only).
_CONVERT = {
    "Conv", "ConvTranspose", "MaxPool", "AveragePool", "GlobalAveragePool",
    "GlobalMaxPool",
    "BatchNormalization", "InstanceNormalization", "GroupNormalization",
    "custom_group_norm", "Upsample", "Resize", "DepthToSpace", "SpaceToDepth",
    "GridSample",
}

# Ops that flow through whichever layout their (4-D) inputs are in.
_AGNOSTIC_UNARY = {
    "Relu", "LeakyRelu", "Elu", "Selu", "Sigmoid", "HardSigmoid", "HardSwish",
    "Tanh", "Softplus", "Softsign", "Exp", "Log", "Abs", "Neg", "Sqrt",
    "Reciprocal", "Floor", "Ceil", "Round", "Sign", "Erf", "Mish", "Gelu",
    "Clip", "Identity", "Dropout", "Sin", "Cos", "Not", "Cast",
}
_AGNOSTIC_BINARY = {"Add", "Sub", "Mul", "Div", "Pow", "Min", "Max", "Sum",
                    "Mean", "PRelu", "Where", "Equal", "Greater", "Less"}
_AXIS_ATTR = {"Concat", "Softmax", "LogSoftmax"}
# Reductions flow through NHWC with their axes remapped (attr or static
# axes input) as long as output stays 4-D (keepdims) — the SE-block shape.
_REDUCE_AXES = {"ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin"}


def _permute_init(arr: np.ndarray) -> np.ndarray:
    """Broadcast-constant NCHW -> NHWC: pad rank to 4 leading-1s, (0,2,3,1)."""
    a = arr
    while a.ndim < 4:
        a = a[None]
    return np.ascontiguousarray(np.transpose(a, _TO_NHWC))


class _Rewriter:
    def __init__(self, graph: Graph):
        self.graph = graph
        self.pref: dict[str, str] = {}  # edge -> "nchw" | "nhwc"
        self.alt: dict[tuple[str, str], str] = {}  # (edge, layout) -> edge name
        self.out_nodes: list[Node] = []
        self.vt = graph.value_types
        self._hwio_cache: dict[str, str] = {}  # original weight edge -> HWIO edge

    def rank(self, name: str) -> int | None:
        t = self.vt.get(name)
        return len(t.shape) if t is not None else None

    def get(self, name: str, layout: str) -> str:
        """Edge name carrying `name`'s value in `layout` (insert transpose)."""
        cur = self.pref.get(name, "nchw")
        if cur == layout:
            return name
        key = (name, layout)
        if key in self.alt:
            return self.alt[key]
        perm = _TO_NHWC if layout == "nhwc" else _TO_NCHW
        new = self.graph.fresh_name(f"{name}__{layout}")
        self.out_nodes.append(Node("Transpose", [name], [new],
                                   attrs={"perm": list(perm)},
                                   name=f"lt_{new}"))
        self.alt[key] = new
        # the transposed edge keeps target layout implicitly (not in pref —
        # pref tracks original names only)
        return new

    def _is4d(self, name: str) -> bool:
        return self.rank(name) == 4

    def _convt_weight_nhwc(self, node: Node) -> bool:
        """Offline ConvTranspose weight prep for NHWC: (C_in, C_out/g, *k)
        -> the flipped HWIO forward-conv kernel the lowering needs, done
        once host-side (no per-dispatch transform). Fresh initializer, same
        shared-weight safety as _conv_weight_nhwc. Dynamic weights return
        False -> the node stays a barrier."""
        g = self.graph
        w_name = node.inputs[1]
        cache_key = ("convt", w_name)
        if cache_key in self._hwio_cache:
            node.inputs[1] = self._hwio_cache[cache_key]
            return True
        if w_name not in g.initializers:
            return False
        w = g.initializers[w_name]
        if w.ndim != 4:
            return False
        group = int(node.attr("group", 1))
        cin, cout_g = w.shape[0], w.shape[1]
        kernel = w.shape[2:]
        wt = w.reshape((group, cin // group, cout_g) + kernel)
        wt = np.moveaxis(wt, 2, 1)
        wt = wt.reshape((group * cout_g, cin // group) + kernel)
        wt = wt[:, :, ::-1, ::-1]                      # spatial flip
        pw = np.ascontiguousarray(np.transpose(wt, (2, 3, 1, 0)))  # HWIO
        pname = g.fresh_name(w_name + "__hwio_t")
        g.initializers[pname] = pw
        node.inputs[1] = pname
        node.attrs["weight_prepped"] = 1
        self._hwio_cache[cache_key] = pname
        return True

    def _conv_weight_nhwc(self, node: Node) -> bool:
        """Rewrite the conv's weight input to an HWIO edge. Never mutates
        the original initializer in place (it may be shared by other convs
        — weight tying — or by non-conv consumers that need OIHW); instead
        a fresh permuted initializer / dequant chain is created and
        memoized, and dead originals are left for DCE."""
        g = self.graph
        w_name = node.inputs[1]
        if w_name in self._hwio_cache:
            node.inputs[1] = self._hwio_cache[w_name]
            return True
        if w_name in g.initializers:
            w = g.initializers[w_name]
            if w.ndim != 4:
                return False
            pw = np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))
            pname = g.fresh_name(w_name + "__hwio")
            g.initializers[pname] = pw
            node.inputs[1] = pname
            self._hwio_cache[w_name] = pname
            return True
        # DequantizeLinear(int8_init, scales) feeding the conv: duplicate the
        # dequant onto a permuted copy of the int8 initializer so any other
        # consumer of the original dequant output still sees OIHW.
        prod = self._producer_of(w_name)
        if (prod is not None and prod.op_type == "DequantizeLinear"
                and prod.inputs[0] in g.initializers
                and int(prod.attr("axis", 1)) == 0
                and g.initializers[prod.inputs[0]].ndim == 4):
            q_name = prod.inputs[0]
            pq_name = g.fresh_name(q_name + "__hwio")
            g.initializers[pq_name] = np.ascontiguousarray(
                np.transpose(g.initializers[q_name], (2, 3, 1, 0)))
            new_out = g.fresh_name(w_name + "__hwio")
            dq = Node("DequantizeLinear", [pq_name] + list(prod.inputs[1:]),
                      [new_out], attrs=dict(prod.attrs), name=f"lt_{new_out}")
            dq.attrs["axis"] = 3  # output channels now last
            self.out_nodes.append(dq)
            node.inputs[1] = new_out
            self._hwio_cache[w_name] = new_out
            return True
        return False

    def _producer_of(self, name: str) -> Node | None:
        # out_nodes grows as we emit; index lazily and incrementally.
        if not hasattr(self, "_prod_idx"):
            self._prod_idx: dict[str, Node] = {}
            self._prod_seen = 0
        for n in self.out_nodes[self._prod_seen:]:
            for o in n.outputs:
                if o:
                    self._prod_idx[o] = n
        self._prod_seen = len(self.out_nodes)
        return self._prod_idx.get(name)

    def run(self) -> int:
        g = self.graph
        changed = 0
        for node in g.nodes:
            kind = self._classify(node)
            if kind == "convert":
                ok = True
                if node.op_type == "Conv":
                    ok = self._conv_weight_nhwc(node)
                elif node.op_type == "ConvTranspose":
                    ok = self._convt_weight_nhwc(node)
                elif node.op_type == "GridSample" and len(node.inputs) > 1:
                    # the grid is (N,Ho,Wo,2) regardless of activation
                    # layout — pin it to its original (NCHW-world) form
                    node.inputs[1] = self.get(node.inputs[1], "nchw") \
                        if node.inputs[1] not in g.initializers \
                        else node.inputs[1]
                if ok:
                    node.inputs[0] = self.get(node.inputs[0], "nhwc")
                    node.attrs["data_layout"] = "NHWC"
                    for o in node.outputs:
                        self.pref[o] = "nhwc"
                    changed += 1
                    self.out_nodes.append(node)
                    continue
                kind = "barrier"  # dynamic conv weight: leave in NCHW
            if kind == "agnostic":
                new_inputs = []
                for i, name in enumerate(node.inputs):
                    if not name:
                        new_inputs.append(name)
                    elif name in g.initializers:
                        arr = g.initializers[name]
                        if arr.ndim > 0 and arr.size > 1:
                            pname = g.fresh_name(name + "__nhwc")
                            g.initializers[pname] = _permute_init(arr)
                            new_inputs.append(pname)
                        else:
                            new_inputs.append(name)
                    elif self._is4d(name):
                        new_inputs.append(self.get(name, "nhwc"))
                    else:
                        new_inputs.append(name)
                node.inputs = new_inputs
                if node.op_type in _AXIS_ATTR:
                    ax = node.attr("axis", 1 if node.op_type == "Concat" else -1)
                    if ax < 0:
                        ax += 4
                    node.attrs["axis"] = _AXIS_MAP[ax]
                for o in node.outputs:
                    self.pref[o] = "nhwc"
                changed += 1
                self.out_nodes.append(node)
                continue
            # barrier: all inputs in NCHW
            node.inputs = [
                self.get(n, "nchw") if n and n not in g.initializers else n
                for n in node.inputs
            ]
            for o in node.outputs:
                self.pref[o] = "nchw"
            self.out_nodes.append(node)

        # graph outputs must come back in NCHW
        for vi in g.outputs:
            if self.pref.get(vi.name) == "nhwc":
                vi.name = self.get(vi.name, "nchw")
        g.nodes = self.out_nodes
        g.toposort()
        return changed

    def _classify(self, node: Node) -> str:
        op = node.op_type
        in0 = node.inputs[0] if node.inputs else ""
        if node.attr("data_layout") == "NHCW":
            # claimed by the pixel-conv region pass (passes/pixel_regions
            # .py) — its edges are NHCW; leave them alone
            return "barrier"
        if op in _CONVERT:
            if op == "MaxPool" and len(node.outputs) > 1 and node.outputs[1]:
                return "barrier"  # indices are flat NCHW offsets
            if self._is4d(in0):
                return "convert"
            return "barrier"
        in_layouts_4d = [
            self.pref.get(n, "nchw")
            for n in node.inputs
            if n and n not in self.graph.initializers and self._is4d(n)
        ]
        if not in_layouts_4d or "nhwc" not in in_layouts_4d:
            return "barrier"
        if op in ("Softmax", "LogSoftmax") and self.graph.opset < 13:
            return "barrier"  # flatten semantics pre-13: axis remap invalid
        if op in _AGNOSTIC_UNARY or op in _AGNOSTIC_BINARY or op in _AXIS_ATTR:
            # binary ops: every non-initializer input must be 4-D (else the
            # implicit broadcast changes meaning under permutation)
            for n in node.inputs:
                if n and n not in self.graph.initializers and not self._is4d(n):
                    return "barrier"
            return "agnostic"
        if op in _REDUCE_AXES:
            if not node.attr("keepdims", 1):
                return "barrier"
            axes = node.attr("axes")
            if axes is None and len(node.inputs) > 1 and node.inputs[1]:
                arr = self.graph.initializers.get(node.inputs[1])
                if arr is None:
                    return "barrier"
                axes = [int(a) for a in arr.reshape(-1)]
                new = np.asarray([_AXIS_MAP[a + 4 if a < 0 else a]
                                  for a in axes], arr.dtype)
                pname = self.graph.fresh_name(node.inputs[1] + "__nhwc")
                self.graph.initializers[pname] = new
                node.inputs[1] = pname
                return "agnostic"
            if axes is None:
                return "barrier"
            node.attrs["axes"] = [_AXIS_MAP[a + 4 if a < 0 else a] for a in axes]
            return "agnostic"
        if op == "Slice":
            # opset>=10: remap the static axes input; attr form (opset<10)
            # would need per-axis pads reordering — barrier for simplicity.
            if len(node.inputs) > 3 and node.inputs[3]:
                arr = self.graph.initializers.get(node.inputs[3])
                if arr is not None:
                    axes = [int(a) for a in arr.reshape(-1)]
                    new = np.asarray([_AXIS_MAP[a + 4 if a < 0 else a]
                                      for a in axes], arr.dtype)
                    pname = self.graph.fresh_name(node.inputs[3] + "__nhwc")
                    self.graph.initializers[pname] = new
                    node.inputs[3] = pname
                    return "agnostic"
            return "barrier"
        if op == "Pad":
            pads_name = node.inputs[1] if len(node.inputs) > 1 else ""
            if pads_name in self.graph.initializers:
                pads = self.graph.initializers[pads_name].reshape(-1)
                if pads.size == 8:
                    new = np.empty_like(pads)
                    for old_ax, new_ax in _AXIS_MAP.items():
                        new[new_ax] = pads[old_ax]
                        new[new_ax + 4] = pads[old_ax + 4]
                    pname = self.graph.fresh_name(pads_name + "__nhwc")
                    self.graph.initializers[pname] = new
                    node.inputs[1] = pname
                    return "agnostic"
            return "barrier"
        return "barrier"


# The layout stage as callers should run it: the NHWC rewrite plus its
# transpose-sandwich cleanup. api._prepare and bench.py both use this so
# the bench can never measure a different graph than the product compiles.
# fuse_convnext_block is registered but OFF by default: the whole-block
# kernel wins ISOLATED (2.77 -> 1.97 ms stage-1, probe64) yet loses the
# e2e interleaved A/B by 35% (probe65: 9.76 vs 15.03 ms b64 int8w) —
# the third microbench-win/e2e-loss inversion (MLP probe55, cross-attn
# probe63): per-image grids forfeit XLA's cross-batch overlap.
# dwconv_ln_barrier runs AFTER the transpose collapse (a barrier in
# the middle of a permute sandwich would block the collapse; probe86b
# measured the barrier's e2e win with collapsed layouts)
NHWC_PIPELINE = ["layout_nhwc", "fuse_transpose_pairs",
                 "collapse_layout_transposes", "dwconv_ln_barrier"]


@register_pass("fuse_transpose_pairs")
def fuse_transpose_pairs(graph: Graph) -> int:
    """Compose consecutive Transpose nodes (sole-consumer chains) into one,
    and drop the pair entirely when the composition is the identity.

    torch-exported channels-last models (ConvNeXt: permute -> LN/MLP ->
    permute per block) interleave their own permutes with the ones
    layout_nhwc inserts at barriers; the adjacent pairs are exact
    inverses but survived to runtime — probe62 measured ~0.7 ms/block of
    pure HBM transpose glue on ConvNeXt b64 (88 Transposes post-layout).
    Purely structural: no type inference needed, numerics-preserving by
    permutation algebra; runs to a fixpoint."""
    changed = 0
    while True:
        producers = {}
        for n in graph.nodes:
            for o in n.outputs:
                if o:
                    producers[o] = n
        consumers = graph.consumers()
        out_names = set(graph.output_names)
        did = 0
        dead: set[int] = set()
        for node in graph.nodes:
            if node.op_type != "Transpose" or id(node) in dead:
                continue
            up = producers.get(node.inputs[0])
            if (up is None or up.op_type != "Transpose" or id(up) in dead
                    or len(consumers.get(up.outputs[0], [])) != 1
                    or up.outputs[0] in out_names):
                continue
            p1 = list(up.attr("perm", []))
            p2 = list(node.attr("perm", []))
            if not p1 or not p2 or len(p1) != len(p2):
                continue
            comp = [p1[a] for a in p2]  # node(up(x)): x-axis for out axis
            if comp == list(range(len(comp))):
                # identity: rewire node's consumers to up's input
                src = up.inputs[0]
                for c in consumers.get(node.outputs[0], []):
                    c.inputs = [src if e == node.outputs[0] else e
                                for e in c.inputs]
                if node.outputs[0] in out_names:
                    # keep the output edge name: turn node into Identity
                    node.attrs = {}
                    node.op_type = "Identity"
                    node.inputs = [src]
                else:
                    dead.add(id(node))
                dead.add(id(up))
            else:
                node.inputs = [up.inputs[0]]
                node.attrs["perm"] = comp
                dead.add(id(up))
            did += 1
        if not did:
            break
        graph.nodes = [n for n in graph.nodes if id(n) not in dead]
        changed += did
    if changed:
        graph.dead_code_eliminate()
        graph.value_types = {}
    return changed


def _ensure_types(graph: Graph) -> bool:
    if graph.value_types:
        return True
    from ..ir.errors import SmelterError
    from ..runtime.executor import Executor

    try:
        Executor(graph).infer_value_types()
    except SmelterError:
        return False
    return True


@register_pass("collapse_layout_transposes")
def collapse_layout_transposes(graph: Graph) -> int:
    """Cancel the Transpose/Reshape/Transpose sandwiches layout_nhwc leaves
    around spatial-attention blocks (SD-style `x.reshape(B,C,HW).permute
    (0,2,1)` and its inverse, models/sd_unet.py SpatialTransformer).

    Under NHWC the token flattening is FREE — (B,H,W,C) reshapes straight
    to (B,HW,C) — but the original graph expresses it via NCHW, so the
    layout pass materializes a barrier transpose on both sides:

        entry:  Transpose(0,3,1,2) -> Reshape(B,C,HW) -> Transpose(0,2,1)
        exit:   Transpose(0,2,1) -> Reshape(B,C,H,W) -> Transpose(0,2,3,1)

    Both compose to a pure reshape of the NHWC operand (index map:
    (b,h,w,c) <-> (b, h*W+w, c)), so each sandwich is replaced by ONE
    Reshape. Element order is proven by the index algebra above and
    asserted by the pass parity tests; shapes are read from inferred
    value_types, not the Reshape's shape operand, so Shape->Concat chains
    don't matter. Runs right after layout_nhwc (api._prepare)."""
    # Cheap pre-scan: most CNN graphs have no candidate sandwich at all —
    # skip the whole-graph type inference _ensure_types would trigger.
    reshape_in = {n.inputs[0] for n in graph.nodes
                  if n.op_type == "Reshape" and n.inputs}
    if not any(n.op_type == "Transpose" and n.outputs[0] in reshape_in
               and list(n.attr("perm", [])) in ([0, 3, 1, 2], [0, 2, 1])
               for n in graph.nodes):
        return 0
    if not _ensure_types(graph):
        return 0
    vt = graph.value_types
    cons = graph.consumers()
    out_names = set(graph.output_names)

    def shape(name: str):
        t = vt.get(name)
        return tuple(t.shape) if t is not None and t.is_static else None

    def sole_consumer(edge: str, op: str) -> Node | None:
        if edge in out_names:
            return None
        cs = cons.get(edge, [])
        if len(cs) == 1 and cs[0].op_type == op:
            return cs[0]
        return None

    changed = 0
    dead: set[int] = set()
    new_nodes: list[Node] = []
    for t1 in list(graph.find_nodes("Transpose")):
        if id(t1) in dead or not t1.inputs[0]:
            continue
        perm1 = list(t1.attr("perm", []))
        s_in = shape(t1.inputs[0])
        if s_in is None:
            continue
        r = sole_consumer(t1.outputs[0], "Reshape")
        if r is None:
            continue
        t2 = sole_consumer(r.outputs[0], "Transpose")
        if t2 is None:
            continue
        perm2 = list(t2.attr("perm", []))
        s_mid = shape(r.outputs[0])
        target = None
        if (perm1 == [0, 3, 1, 2] and perm2 == [0, 2, 1] and len(s_in) == 4
                and s_mid == (s_in[0], s_in[3], s_in[1] * s_in[2])):
            # (B,H,W,C) -nchw-> reshape (B,C,HW) -> (B,HW,C)
            target = [s_in[0], s_in[1] * s_in[2], s_in[3]]
        elif (perm1 == [0, 2, 1] and perm2 == [0, 2, 3, 1] and len(s_in) == 3
              and s_mid is not None and len(s_mid) == 4
              and s_mid[:2] == (s_in[0], s_in[2])
              and s_mid[2] * s_mid[3] == s_in[1]):
            # (B,N,C) -> (B,C,N) -> reshape (B,C,H,W) -nhwc-> (B,H,W,C)
            target = [s_mid[0], s_mid[2], s_mid[3], s_mid[1]]
        if target is None:
            continue
        sname = graph.fresh_name(t2.outputs[0] + "__shape")
        graph.initializers[sname] = np.asarray(target, np.int64)
        new_nodes.append(Node("Reshape", [t1.inputs[0], sname],
                              [t2.outputs[0]], name=f"clt_{t2.outputs[0]}"))
        dead.update((id(t1), id(r), id(t2)))
        changed += 1
    if changed:
        graph.nodes = [n for n in graph.nodes if id(n) not in dead] + new_nodes
        graph.toposort()
        graph.value_types = {}
    return changed


@register_pass("layout_nhwc")
def layout_nhwc(graph: Graph) -> int:
    """Rewrite 4-D activation flow to NHWC. Requires value_types populated
    (Executor.infer_value_types) for rank information."""
    if not _ensure_types(graph):
        return 0  # unresolved dims etc: leave the graph in NCHW
    if graph.metadata.get("layout") == "nhwc":
        return 0
    r = _Rewriter(graph)
    changed = r.run()
    if changed:
        graph.metadata["layout"] = "nhwc"
        graph.value_types = {}  # stale after rewrite
    return changed
