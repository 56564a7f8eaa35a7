"""NHCW pixel-conv regions: route small-C_out 3x3 convs to the Pallas
pixel-major kernel (kernels/pixel_conv.py) and keep whole decoder trunks
in its [B, H, C, W] layout.

Why: XLA pads conv channel dims to the 128-lane MXU tile, so ESRGAN-class
dense blocks (C_out 32/64, huge spatial maps) top out at 12-29 TF of the
219 peak no matter how they are formulated at graph level (probes 21-26,
38). The pixel-major kernel puts W on the lanes (zero padding for any
C_out) and wins 2.5x on a chained RRDB trunk and 2.1x on the 512^2 tail
(experiments/tpu_probe43.py) — but only if activations STAY in NHCW
between convs. This pass is the NHCW analog of the layout_nhwc pass
(passes/layout.py): eligible convs become PixelConv nodes consuming
NHCW, layout-agnostic ops (activations, binary, concat) follow their
inputs into NHCW with axis attrs remapped, everything else is a barrier
that materializes NCHW via memoized Transposes. The NCHW<->NHCW perm
(0, 2, 1, 3) is self-inverse, so regions meet with zero residual
transposes.

Runs in DEFAULT_PIPELINE before pack_conv_output (which then packs only
the convs this pass cannot take). Reference scope: none — the reference
hands conv shapes to MPS as-is (Sources/Smelter/Converters.swift); this
pass exists because of TPU MXU/HBM geometry.
"""

from __future__ import annotations

import numpy as np

from ..ir.graph import Graph, Node
from .decoder_fusion import _as_str, _ensure_types, _plain_conv
from .layout import _AGNOSTIC_BINARY, _AGNOSTIC_UNARY
from .pass_manager import register_pass

_PERM = [0, 2, 1, 3]  # NCHW <-> NHCW, self-inverse
_AXIS_MAP = {0: 0, 1: 2, 2: 1, 3: 3}
_AXIS_ATTR = {"Concat", "Softmax", "LogSoftmax"}

# VMEM gate: double-buffered (rows+2, C_in, W) bf16 blocks at rows=8.
_MAX_CIN_X_W = 96 * 1024
_MAX_COUT = 64
# Region amortization gate: probe44 measured a 5-conv U-Net decoder
# region LOSING (1,245 vs 1,421 img/s) — the skip-connection boundary
# transposes ate the ~1.3x per-conv win — while the ~62-conv ESRGAN
# trunk wins 2.2x. W>=384 singletons always win (XLA collapses there).
_MIN_REGION = 8


def _eligible(graph: Graph, node: Node) -> bool:
    w = _plain_conv(graph, node, (3, 3))
    if w is None:
        return False
    cout, cin = w.shape[:2]
    if cout > _MAX_COUT or cout % 8 or cin % 16:
        return False
    if list(node.attr("strides", [1, 1])) != [1, 1]:
        return False
    if list(node.attr("dilations", [1, 1])) != [1, 1]:
        return False
    if _as_str(node.attr("auto_pad", "NOTSET")) not in ("NOTSET", ""):
        return False
    if list(node.attr("pads", [0, 0, 0, 0])) != [1, 1, 1, 1]:
        return False
    t = graph.value_types.get(node.inputs[0])
    if (t is None or t.shape is None or len(t.shape) != 4
            or not all(isinstance(d, int) for d in t.shape)):
        return False
    _, c, h, wdt = t.shape
    if np.dtype(t.np_dtype) != np.dtype(np.float32):
        return False
    return (h % 8 == 0 and wdt % 128 == 0 and wdt >= 128
            and cin * wdt <= _MAX_CIN_X_W)


def _nearest2x(graph: Graph, node: Node) -> tuple[int, int] | None:
    """(sh, sw) if node is an integer-scale nearest upsample whose mapping
    equals broadcast-repeat (true for floor/round_prefer_floor under
    asymmetric/half_pixel at integer scales), else None."""
    if node.op_type not in ("Resize", "Upsample"):
        return None
    if _as_str(node.attr("mode", "nearest")) != "nearest":
        return None
    if node.op_type == "Resize":
        coord = _as_str(node.attr("coordinate_transformation_mode",
                                  "half_pixel"))
        nm = _as_str(node.attr("nearest_mode", "round_prefer_floor"))
        if coord not in ("asymmetric", "half_pixel", "pytorch_half_pixel"):
            return None
        if nm not in ("floor", "round_prefer_floor"):
            return None
        sizes = (graph.constant(node.inputs[3])
                 if len(node.inputs) > 3 and node.inputs[3] else None)
        if sizes is not None and sizes.size:
            t = graph.value_types.get(node.inputs[0])
            if t is None or t.shape is None or len(t.shape) != 4 \
                    or not all(isinstance(d, int) for d in t.shape):
                return None
            sizes = sizes.reshape(-1).astype(np.int64)
            if sizes.shape != (4,) or any(
                    int(sizes[i]) != t.shape[i] for i in (0, 1)):
                return None
            if sizes[2] % t.shape[2] or sizes[3] % t.shape[3]:
                return None
            return (int(sizes[2]) // t.shape[2],
                    int(sizes[3]) // t.shape[3])
        scales_edge = (node.inputs[2] if len(node.inputs) > 2
                       and node.inputs[2] else
                       node.inputs[1] if len(node.inputs) > 1 else "")
        sc = graph.constant(scales_edge) if scales_edge else None
    elif node.attr("scales") is not None:
        sc = np.asarray(node.attr("scales"), np.float64)
    else:
        sc = (graph.constant(node.inputs[1])
              if len(node.inputs) > 1 and node.inputs[1] else None)
    if sc is None:
        return None
    sc = np.asarray(sc, np.float64).reshape(-1)
    if (sc.shape != (4,) or sc[0] != 1 or sc[1] != 1
            or sc[2] != int(sc[2]) or sc[3] != int(sc[3])
            or sc[2] < 1 or sc[3] < 1):
        return None
    return int(sc[2]), int(sc[3])


def _resize_rideable(graph: Graph, node: Node) -> bool:
    """Non-integer / linear / cubic Resize or Upsample that the NHCW-aware
    lowering can run in-region (ops/nn.py::_spatial_axes): 4-D, no
    tf_crop_and_resize, no opset-18 axes/antialias attrs."""
    if node.op_type not in ("Resize", "Upsample"):
        return False
    t = graph.value_types.get(node.inputs[0])
    if t is None or t.shape is None or len(t.shape) != 4:
        return False
    if _as_str(node.attr("coordinate_transformation_mode",
                         "half_pixel")) == "tf_crop_and_resize":
        return False
    if node.attr("axes") is not None or node.attr("antialias"):
        return False
    return True


def _permute_init(arr: np.ndarray) -> np.ndarray:
    """Broadcast-constant NCHW -> NHCW: pad rank to 4, swap C and H."""
    a = arr
    while a.ndim < 4:
        a = a[None]
    return np.ascontiguousarray(np.transpose(a, _PERM))


class _Rewriter:
    def __init__(self, graph: Graph, pixel: set[int],
                 fused: dict[int, tuple[float, Node]]):
        self.graph = graph
        self.pixel = pixel
        self.fused = fused          # conv node id -> (alpha, activation node)
        self.consumed = {id(a) for _, a in fused.values()}
        self.pref: dict[str, str] = {}       # edge -> "nchw" | "nhcw"
        self.alt: dict[str, str] = {}        # edge -> transposed alias
        self.out_nodes: list[Node] = []
        self.vt = graph.value_types

    def _rank(self, name: str) -> int | None:
        t = self.vt.get(name)
        return None if t is None or t.shape is None else len(t.shape)

    def get(self, name: str, layout: str) -> str:
        cur = self.pref.get(name, "nchw")
        if cur == layout:
            return name
        if name in self.alt:
            return self.alt[name]
        new = self.graph.fresh_name(f"{name}__{layout}")
        self.out_nodes.append(Node("Transpose", [name], [new],
                                   attrs={"perm": list(_PERM)},
                                   name=f"px_{new}"))
        self.alt[name] = new
        return new

    def run(self) -> int:
        g = self.graph
        changed = 0
        for node in g.nodes:
            if id(node) in self.consumed:
                continue
            if id(node) in self.pixel:
                changed += 1
                x = self.get(node.inputs[0], "nhcw")
                bias = node.inputs[2] if len(node.inputs) > 2 else ""
                if not bias:
                    cout = g.initializers[node.inputs[1]].shape[0]
                    bias = g.fresh_name(f"{node.outputs[0]}_zb")
                    g.initializers[bias] = np.zeros((cout,), np.float32)
                attrs = {"data_layout": "NHCW"}
                out_edge = node.outputs[0]
                if id(node) in self.fused:
                    alpha, act = self.fused[id(node)]
                    attrs["alpha"] = float(alpha)
                    out_edge = act.outputs[0]
                self.out_nodes.append(
                    Node("PixelConv", [x, node.inputs[1], bias], [out_edge],
                         attrs, name=f"px_{node.name or out_edge}"))
                self.pref[out_edge] = "nhcw"
                continue
            if self.pref.get(node.inputs[0] if node.inputs else "") == "nhcw":
                up = _nearest2x(g, node)
                if up is not None:
                    # integer-nearest upsample rides the NHCW trunk as a
                    # broadcast-reshape (the fastest nearest form, probe20)
                    self.out_nodes.append(
                        Node("PixelNearestUp", [node.inputs[0]],
                             [node.outputs[0]], {"sh": up[0], "sw": up[1]},
                             name=f"px_{node.name or node.outputs[0]}"))
                    self.pref[node.outputs[0]] = "nhcw"
                    changed += 1
                    continue
                if _resize_rideable(g, node):
                    # linear/cubic/fractional resize: the lowering handles
                    # NHCW via explicit spatial axes (1, 3)
                    node.attrs["data_layout"] = "NHCW"
                    for o in node.outputs:
                        self.pref[o] = "nhcw"
                    self.out_nodes.append(node)
                    changed += 1
                    continue
            kind = self._classify(node)
            if kind == "agnostic" and any(
                    self.pref.get(n) == "nhcw" for n in node.inputs if n):
                new_inputs = []
                for name in node.inputs:
                    if not name:
                        new_inputs.append(name)
                    elif name in g.initializers:
                        arr = g.initializers[name]
                        if arr.ndim > 0 and arr.size > 1:
                            pname = g.fresh_name(name + "__nhcw")
                            g.initializers[pname] = _permute_init(arr)
                            new_inputs.append(pname)
                        else:
                            new_inputs.append(name)
                    elif self._rank(name) == 4:
                        new_inputs.append(self.get(name, "nhcw"))
                    else:
                        new_inputs.append(name)
                node.inputs = new_inputs
                if node.op_type in _AXIS_ATTR:
                    ax = node.attr("axis",
                                   1 if node.op_type == "Concat" else -1)
                    if ax < 0:
                        ax += 4
                    node.attrs["axis"] = _AXIS_MAP[ax]
                for o in node.outputs:
                    self.pref[o] = "nhcw"
                self.out_nodes.append(node)
                continue
            # barrier (or agnostic with no NHCW inputs): NCHW in
            node.inputs = [
                self.get(n, "nchw") if n and n not in g.initializers else n
                for n in node.inputs
            ]
            for o in node.outputs:
                self.pref[o] = "nchw"
            self.out_nodes.append(node)

        for vi in g.outputs:
            if self.pref.get(vi.name) == "nhcw":
                vi.name = self.get(vi.name, "nchw")
        g.nodes = self.out_nodes
        g.toposort()
        return changed

    def _classify(self, node: Node) -> str:
        op = node.op_type
        g = self.graph
        if op in _AGNOSTIC_UNARY or op in _AGNOSTIC_BINARY:
            # Traced inputs must be rank 0/1/4: rank-1 (W,) broadcasts the
            # same against NCHW and NHCW trailing dims; rank 2/3 would
            # change meaning under the C<->H swap (initializers are
            # explicitly permuted instead).
            if all(n in g.initializers or self._rank(n) in (0, 1, 4)
                   for n in node.inputs if n):
                return "agnostic"
        if op == "Concat":
            ax = node.attr("axis", 1)
            if ax in (1, -3) and all(self._rank(n) == 4
                                     for n in node.inputs if n):
                return "agnostic"
        return "barrier"


def _trunk_filter(graph: Graph, eligible: list[Node]) -> set[int]:
    """Keep only convs whose NHCW region amortizes its boundary
    transposes: regions of >= _MIN_REGION connected eligible convs
    (connected through agnostic ops / rideable resizes — the ESRGAN trunk
    case), or any conv on W >= 384 maps where XLA's direct conv collapses
    (probe40: 17.6 TF @512 vs the kernel's 47, a 2.1x win even with both
    transposes included, probe43). Small regions at W <= 256 lose
    end-to-end: boundary transposes cost more than the ~1.3-1.4x per-conv
    win (probe44: ungated, U-Net 1,194 and SegNet 1,212; at threshold 4
    U-Net's 5-conv decoder region still lost, 1,245 vs 1,421)."""
    vt = graph.value_types
    ids = {id(n): n for n in eligible}
    parent = {i: i for i in ids}

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    cons = graph.consumers()
    agn = _AGNOSTIC_UNARY | _AGNOSTIC_BINARY | {"Concat"}
    for conv in eligible:
        seen: set[str] = set()
        frontier = list(conv.outputs)
        hops = 0
        while frontier and hops < 64:
            edge = frontier.pop()
            if edge in seen:
                continue
            seen.add(edge)
            for user in cons.get(edge, ()):
                hops += 1
                if id(user) in ids:
                    union(id(conv), id(user))
                elif (user.op_type in agn
                      or _nearest2x(graph, user) is not None
                      or _resize_rideable(graph, user)):
                    frontier.extend(user.outputs)
    sizes: dict[int, int] = {}
    for i in ids:
        sizes[find(i)] = sizes.get(find(i), 0) + 1
    keep: set[int] = set()
    for i, node in ids.items():
        t = vt.get(node.inputs[0])
        wdt = t.shape[3]
        if sizes[find(i)] >= _MIN_REGION or wdt >= 384:
            keep.add(i)
    return keep


@register_pass("pixel_conv_regions")
def pixel_conv_regions(graph: Graph) -> int:
    """Route eligible convs to the pixel-major Pallas kernel, keeping
    connected trunks in NHCW (see module docstring)."""
    if not _ensure_types(graph):
        return 0
    eligible = [conv for conv in graph.find_nodes("Conv")
                if _eligible(graph, conv)]
    pixel = _trunk_filter(graph, eligible)
    if not pixel:
        return 0
    # fuse a sole-consumer LeakyRelu/Relu into the kernel epilogue
    cons = graph.consumers()
    out_names = set(graph.output_names)
    fused: dict[int, tuple[float, Node]] = {}
    for conv in graph.find_nodes("Conv"):
        if id(conv) not in pixel:
            continue
        y = conv.outputs[0]
        users = cons.get(y, [])
        if y in out_names or len(users) != 1:
            continue
        act = users[0]
        if act.op_type == "LeakyRelu":
            fused[id(conv)] = (float(act.attr("alpha", 0.01)), act)
        elif act.op_type == "Relu":
            fused[id(conv)] = (0.0, act)
    n = _Rewriter(graph, pixel, fused).run()
    graph.value_types = {}  # stale after relayout; recomputed on demand
    return n
