"""Decoder-chain rewrites: kill the materialized concat/upsample tensors
that dominate U-Net / ESRGAN-style graphs (reference scope:
Sources/Smelter/Converters.swift:478-574 — MPS upsample + concat nodes).

TPU probe data (experiments/tpu_probe18.py) showed XLA's upsample/concat
chains running at 93-270 GB/s of the 819 GB/s v5e HBM roofline. Instead of
hand-scheduling interleave-heavy Pallas kernels, these passes remove the
slow ops algebraically — the rewritten graphs are pure convs, which XLA
already maps well onto the MXU:

- split_concat_conv:  Conv(Concat(x_1..x_k), W) == sum_i Conv(x_i, W_i)
  with W channel-sliced. The concat tensor (ESRGAN dense blocks grow it to
  192 channels) is never materialized.
- subpixel_upsample_conv:  Conv3x3(nearest_up2(x)) == interleave of four
  2x2-kernel convs on x (exact; 2.25x fewer FLOPs, no 4x-size
  intermediate). The interleave is a Concat + DepthToSpace(DCR), which
  lowers to a reshape/transpose pair. 1x1 convs commute with nearest
  upsampling, so those are simply reordered (conv first, at low res).

Both rewrites are bit-exact in exact arithmetic and numerics-preserving to
accumulation roundoff (tested against the unfused forms in
tests/test_decoder_fusion.py).
"""

from __future__ import annotations

import numpy as np

from ..ir.graph import Graph, Node
from .pass_manager import register_pass

_MAX_FANIN = 8
# subpixel decomposition only pays above this input-channel count
# (tpu_probe19/20: 1.17x at 256ch, 0.71x at 64ch)
_SUBPIXEL_MIN_CIN = 128

# (coordinate_transformation_mode, nearest_mode) pairs for which a
# scale-2 nearest resize is exactly out[2i+d] = x[i] for every size.
_REPEAT_COMBOS = {
    ("asymmetric", "floor"),
    ("asymmetric", "round_prefer_floor"),
    ("half_pixel", "round_prefer_floor"),
    ("half_pixel", "round_prefer_ceil"),
    ("pytorch_half_pixel", "round_prefer_floor"),
    ("pytorch_half_pixel", "round_prefer_ceil"),
}


def _ensure_types(graph: Graph) -> bool:
    if graph.value_types:
        return True
    from ..ir.errors import SmelterError
    from ..runtime.executor import Executor

    try:
        Executor(graph).infer_value_types()
    except SmelterError:
        return False
    return bool(graph.value_types)


def _as_str(v) -> str:
    return v.decode() if isinstance(v, bytes) else str(v)


def _plain_conv(graph: Graph, node: Node, kernel: tuple[int, ...] | None):
    """Return the OIHW weight if `node` is an ungrouped NCHW Conv with an
    initializer weight (and the given spatial kernel, if specified)."""
    if node.op_type != "Conv" or node.attr("data_layout") == "NHWC":
        return None
    if int(node.attr("group", 1)) != 1:
        return None
    w = graph.initializers.get(node.inputs[1])
    if w is None or w.ndim != 4:
        return None
    if kernel is not None and tuple(w.shape[2:]) != kernel:
        return None
    return w


@register_pass("split_concat_conv")
def split_concat_conv(graph: Graph) -> int:
    """Conv(Concat(xs, axis=1), W) -> Sum_i Conv(x_i, W[:, slice_i]).

    Applies when the concat feeds only the conv; the bias rides on the
    first split. Any strides/dilations/pads are preserved (channel
    slicing commutes with the spatial part of the convolution)."""
    if not _ensure_types(graph):
        return 0
    changed = 0
    producers = graph.producers()
    consumers = graph.consumers()
    dead: set[int] = set()
    new_nodes: list[Node] = []
    for conv in list(graph.find_nodes("Conv")):
        if id(conv) in dead:
            continue
        w = _plain_conv(graph, conv, None)
        if w is None:
            continue
        cat = producers.get(conv.inputs[0])
        if cat is None or cat.op_type != "Concat" or id(cat) in dead:
            continue
        if cat.attr("data_layout") == "NHWC":
            continue
        if len(consumers.get(cat.outputs[0], [])) != 1:
            continue
        if int(cat.attr("axis", 0)) not in (1, -3):
            continue
        ins = [i for i in cat.inputs if i]
        if not 2 <= len(ins) <= _MAX_FANIN:
            continue
        chans: list[int] = []
        for name in ins:
            t = graph.value_types.get(name)
            if (t is None or t.shape is None or len(t.shape) != 4
                    or not isinstance(t.shape[1], int)):
                break
            chans.append(t.shape[1])
        if len(chans) != len(ins) or sum(chans) != w.shape[1]:
            continue
        bias = conv.inputs[2] if len(conv.inputs) > 2 else ""
        w_name = conv.inputs[1]
        parts: list[str] = []
        off = 0
        for idx, (src, c) in enumerate(zip(ins, chans)):
            wk = graph.fresh_name(f"{w_name}_split{idx}")
            graph.initializers[wk] = np.ascontiguousarray(w[:, off:off + c])
            off += c
            part = graph.fresh_name(f"{conv.outputs[0]}_part{idx}")
            inputs = [src, wk] + ([bias] if idx == 0 and bias else [])
            new_nodes.append(Node("Conv", inputs, [part], dict(conv.attrs),
                                  name=f"{conv.name or conv.outputs[0]}_s{idx}"))
            parts.append(part)
        new_nodes.append(Node("Sum", parts, [conv.outputs[0]],
                              name=f"{conv.name or conv.outputs[0]}_sum"))
        dead.add(id(conv))
        dead.add(id(cat))
        changed += 1
    if changed:
        graph.remove_nodes(dead)
        graph.nodes.extend(new_nodes)
        graph.toposort()
        # the new edges have no inferred types yet — downstream passes
        # (layout_nhwc) key decisions off value_types, so force re-infer
        graph.value_types.clear()
    return changed


def _is_nearest2x(graph: Graph, node: Node) -> bool:
    """True if `node` (Resize/Upsample, NCHW) is exactly a 2x nearest
    repeat over the two trailing spatial dims for any input size."""
    if node.attr("data_layout") == "NHWC":
        return False
    if node.op_type == "Upsample":
        mode = _as_str(node.attr("mode", "nearest"))
        if not mode.startswith("nearest"):
            return False
        if len(node.inputs) > 1 and node.inputs[1]:
            scales = graph.initializers.get(node.inputs[1])
            if scales is None:
                return False
        else:
            scales = np.asarray(node.attr("scales", []), np.float64)
        # lowering uses (asymmetric, floor): repeat-exact for scale 2
    elif node.op_type == "Resize":
        mode = _as_str(node.attr("mode", "nearest"))
        if not mode.startswith("nearest"):
            return False
        coord = _as_str(node.attr("coordinate_transformation_mode",
                                  "half_pixel"))
        nearest = _as_str(node.attr("nearest_mode", "round_prefer_floor"))
        if (coord, nearest) not in _REPEAT_COMBOS:
            return False
        if len(node.inputs) > 3 and node.inputs[3]:
            sizes = graph.initializers.get(node.inputs[3])
            t = graph.value_types.get(node.inputs[0])
            if (sizes is None or t is None or t.shape is None
                    or len(t.shape) != 4
                    or not all(isinstance(d, int) for d in t.shape)):
                return False
            want = (t.shape[0], t.shape[1], 2 * t.shape[2], 2 * t.shape[3])
            return tuple(int(s) for s in sizes) == want
        scales_in = node.inputs[1] if graph.opset == 10 else (
            node.inputs[2] if len(node.inputs) > 2 else "")
        if not scales_in:
            return False
        scales = graph.initializers.get(scales_in)
        if scales is None:
            return False
    else:
        return False
    sc = np.asarray(scales, np.float64).reshape(-1)
    return sc.size == 4 and tuple(sc.tolist()) == (1.0, 1.0, 2.0, 2.0)


def _subpixel_weights(w: np.ndarray, di: int, dj: int) -> np.ndarray:
    """Collapse an OIHW 3x3 kernel onto the parity-(di,dj) output lattice of
    a nearest-2x upsample: out[2i+di, 2j+dj] = sum_pq K[p,q] *
    x[(2i+di+p-1)//2, (2j+dj+q-1)//2], a 2x2 kernel over x anchored at
    (i-(1-di), j-(1-dj))."""
    k = np.zeros(w.shape[:2] + (2, 2), w.dtype)
    for p in range(3):
        u = (di + p - 1) // 2 - (di - 1)
        for q in range(3):
            v = (dj + q - 1) // 2 - (dj - 1)
            k[:, :, u, v] += w[:, :, p, q]
    return k


@register_pass("subpixel_upsample_conv")
def subpixel_upsample_conv(graph: Graph) -> int:
    """Fuse nearest-2x Resize/Upsample into a following Conv.

    - Conv 3x3/s1/p1: replaced by four 2x2-kernel convs at input
      resolution whose outputs interleave via Concat+DepthToSpace(DCR).
    - Conv 1x1/s1/p0: pixelwise, commutes with the repeat — the conv is
      moved before the resize so it runs on the 4x-smaller tensor."""
    if not _ensure_types(graph):
        return 0
    changed = 0
    producers = graph.producers()
    consumers = graph.consumers()
    dead: set[int] = set()
    new_nodes: list[Node] = []
    for conv in list(graph.find_nodes("Conv")):
        if id(conv) in dead:
            continue
        if list(conv.attr("strides", [1, 1])) != [1, 1]:
            continue
        if list(conv.attr("dilations", [1, 1])) != [1, 1]:
            continue
        up = producers.get(conv.inputs[0])
        if (up is None or id(up) in dead
                or up.op_type not in ("Resize", "Upsample")):
            continue
        if len(consumers.get(up.outputs[0], [])) != 1:
            continue
        if not _is_nearest2x(graph, up):
            continue

        w1 = _plain_conv(graph, conv, (1, 1))
        if w1 is not None and all(
                p == 0 for p in conv.attr("pads", [0, 0, 0, 0])) \
                and _as_str(conv.attr("auto_pad", "NOTSET")) in ("NOTSET",
                                                                 "VALID"):
            # reorder: x -> conv(1x1) -> resize  (conv at low resolution)
            low = graph.fresh_name(f"{conv.outputs[0]}_lowres")
            conv.inputs[0] = up.inputs[0]
            final = conv.outputs[0]
            conv.outputs[0] = low
            up.inputs[0] = low
            up.outputs[0] = final
            graph.value_types.pop(low, None)
            changed += 1
            continue

        w = _plain_conv(graph, conv, (3, 3))
        if w is None:
            continue
        if w.shape[1] < _SUBPIXEL_MIN_CIN:
            # measured on v5e (tpu_probe19/20): the full-resolution
            # interleave transpose eats the 2.25x FLOP saving below
            # ~128 input channels (0.71x at 128^2x64); XLA's fused
            # broadcast-upsample + conv wins there
            continue
        auto = _as_str(conv.attr("auto_pad", "NOTSET"))
        pads_ok = (auto in ("NOTSET", "")
                   and list(conv.attr("pads", [0, 0, 0, 0])) == [1, 1, 1, 1])
        if not pads_ok and auto not in ("SAME_UPPER", "SAME_LOWER"):
            continue  # k=3/s=1 SAME is symmetric (1,1): equivalent
        bias = conv.inputs[2] if len(conv.inputs) > 2 else ""
        base = conv.name or conv.outputs[0]
        parts = []
        for di in (0, 1):
            for dj in (0, 1):
                wk = graph.fresh_name(f"{conv.inputs[1]}_sp{di}{dj}")
                graph.initializers[wk] = np.ascontiguousarray(
                    _subpixel_weights(w, di, dj))
                part = graph.fresh_name(f"{conv.outputs[0]}_sp{di}{dj}")
                attrs = dict(conv.attrs)
                attrs.pop("auto_pad", None)
                attrs["kernel_shape"] = [2, 2]
                attrs["pads"] = [1 - di, 1 - dj, di, dj]
                inputs = [up.inputs[0], wk] + ([bias] if bias else [])
                new_nodes.append(Node("Conv", inputs, [part], attrs,
                                      name=f"{base}_sp{di}{dj}"))
                parts.append(part)
        cat = graph.fresh_name(f"{conv.outputs[0]}_spcat")
        new_nodes.append(Node("Concat", parts, [cat], {"axis": 1},
                              name=f"{base}_spcat"))
        new_nodes.append(Node("DepthToSpace", [cat], [conv.outputs[0]],
                              {"blocksize": 2, "mode": "DCR"},
                              name=f"{base}_spd2s"))
        dead.add(id(conv))
        dead.add(id(up))
        changed += 1
    if changed:
        graph.remove_nodes(dead)
        graph.nodes.extend(new_nodes)
        graph.toposort()
        graph.value_types.clear()  # see split_concat_conv
    return changed
