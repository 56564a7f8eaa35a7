"""MXU shape packing: rewrite small-output-channel convs so their GEMM
tiles fill the 128-lane MXU.

Reference scope: none — the reference (Sources/Smelter/Converters.swift)
hands conv shapes to MPS as-is; this pass exists because of TPU MXU
geometry. XLA pads conv channel dims to the 128-lane tile, so a
3x3 stride-1 conv with C_out=32 wastes 4x of the systolic array
(measured: ESRGAN b8 128^2 runs at ~25 TFLOP/s = 198/8, exactly the
pad128(C_in=64->2x) * pad128(C_out=32->4x) waste, experiments/
tpu_probe21.py).

pack_conv_output: Conv(3x3, stride 1, pads 1) with C_out <= 64 becomes a
Conv(4x4, stride 2, pads 1) producing 4*C_out channels — one output
channel block per output-pixel parity (di, dj) — followed by
DepthToSpace(DCR, 2). Derivation: the packed output

    Y[n, (2di+dj)*O + o, i, j] = y[n, o, 2i+di, 2j+dj]
      = sum_{p,q} w[o, c, p, q] * x[n, c, 2i-1 + (di+p), 2j-1 + (dj+q)]

is a stride-2 convolution over the 4x4 input patch anchored at
(2i-1, 2j-1) with kernel W4[(2di+dj)*O+o, c, a, b] = w[o, c, a-di, b-dj]
(zero where a-di or b-dj falls outside [0, 3)). Exact in exact
arithmetic; FLOP overhead 16/9 vs the 4x padding waste it removes.

Measured on v5e (experiments/tpu_probe23.py): isolated convs win at
C_out=32 (64->32 1.28x, 192->32 1.21x) and lose at C_out=64 (0.69-0.92x
— the 16/9 overhead exceeds the 2x padding saving there), so the gate is
C_out <= 32. End-to-end with the old C_out<=64 gate the pass LOST
(ESRGAN 192 vs 211 img/s, U-Net 700 vs 1024); with the 32 gate it wins
ESRGAN +8-9% (216 vs 198 img/s bf16, tpu_probe24) and fires on nothing
in the other zoo models, so it is in DEFAULT_PIPELINE.
"""

from __future__ import annotations

import numpy as np

from ..ir.graph import Graph, Node
from .pass_manager import register_pass
from .decoder_fusion import _as_str, _ensure_types, _plain_conv

# probe23 [A]: C_out=32 packs 1.2-1.3x; C_out=64 regresses (0.69-0.92x)
_PACK_MAX_COUT = 32


def _packed_weights(w: np.ndarray) -> np.ndarray:
    """(O, I, 3, 3) -> (4O, I, 4, 4) parity-packed stride-2 kernel."""
    o, i = w.shape[:2]
    w4 = np.zeros((4 * o, i, 4, 4), w.dtype)
    for di in (0, 1):
        for dj in (0, 1):
            blk = (2 * di + dj) * o
            w4[blk:blk + o, :, di:di + 3, dj:dj + 3] = w
    return w4


@register_pass("pack_conv_output")
def pack_conv_output(graph: Graph) -> int:
    """Rewrite low-C_out 3x3/s1/p1 convs on even spatial maps into
    4x4/s2 convs with 2x2 output-pixel parity packed into channels."""
    if not _ensure_types(graph):
        return 0
    changed = 0
    dead: set[int] = set()
    new_nodes: list[Node] = []
    for conv in list(graph.find_nodes("Conv")):
        w = _plain_conv(graph, conv, (3, 3))
        if w is None or w.shape[0] > _PACK_MAX_COUT:
            continue
        if list(conv.attr("strides", [1, 1])) != [1, 1]:
            continue
        if list(conv.attr("dilations", [1, 1])) != [1, 1]:
            continue
        auto = _as_str(conv.attr("auto_pad", "NOTSET"))
        pads_ok = (auto in ("NOTSET", "")
                   and list(conv.attr("pads", [0, 0, 0, 0])) == [1, 1, 1, 1])
        if not pads_ok and auto not in ("SAME_UPPER", "SAME_LOWER"):
            continue
        t = graph.value_types.get(conv.inputs[0])
        if (t is None or t.shape is None or len(t.shape) != 4
                or not all(isinstance(d, int) for d in t.shape[2:])
                or t.shape[2] % 2 or t.shape[3] % 2):
            continue
        bias = conv.inputs[2] if len(conv.inputs) > 2 else ""
        base = conv.name or conv.outputs[0]
        wk = graph.fresh_name(f"{conv.inputs[1]}_pk")
        graph.initializers[wk] = np.ascontiguousarray(_packed_weights(w))
        inputs = [conv.inputs[0], wk]
        if bias:
            bk = graph.fresh_name(f"{bias}_pk")
            graph.initializers[bk] = np.ascontiguousarray(
                np.tile(graph.initializers[bias], 4))
            inputs.append(bk)
        attrs = dict(conv.attrs)
        attrs.pop("auto_pad", None)
        attrs["kernel_shape"] = [4, 4]
        attrs["strides"] = [2, 2]
        attrs["pads"] = [1, 1, 1, 1]
        packed = graph.fresh_name(f"{conv.outputs[0]}_pk")
        new_nodes.append(Node("Conv", inputs, [packed], attrs,
                              name=f"{base}_pk"))
        new_nodes.append(Node("DepthToSpace", [packed], [conv.outputs[0]],
                              {"blocksize": 2, "mode": "DCR"},
                              name=f"{base}_pkd2s"))
        dead.add(id(conv))
        changed += 1
    if changed:
        graph.remove_nodes(dead)
        graph.nodes.extend(new_nodes)
        graph.toposort()
        graph.value_types.clear()  # see split_concat_conv
    return changed
