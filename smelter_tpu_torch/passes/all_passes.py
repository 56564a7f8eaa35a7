"""The standard pass set: nop elision, constant folding, pad-into-conv,
BN-into-conv fusion, DCE.

BN-into-Conv is capability parity with the reference's offline
`fuse_bn_into_conv` (reference: ONNX2MPS.py:107) — reimplemented on the
typed IR with support for grouped/depthwise Conv and ConvTranspose, and a
Gemm variant. Constant folding subsumes the reference's Constant-node
materialization (Converters.swift:716-727) and resolves Shape->...->Reshape
chains that real exporters emit.
"""

from __future__ import annotations

import numpy as np

from ..ir.graph import Graph, Node
from .pass_manager import register_pass


def _rewire(graph: Graph, old: str, new: str) -> None:
    """Replace every use of edge `old` with `new`."""
    for n in graph.nodes:
        n.inputs = [new if i == old else i for i in n.inputs]
    for v in graph.outputs:
        if v.name == old:
            v.name = new


@register_pass("dce")
def dce(graph: Graph) -> int:
    return graph.dead_code_eliminate()


@register_pass("eliminate_nops")
def eliminate_nops(graph: Graph) -> int:
    """Drop Dropout/Identity (inference passthrough — the reference keeps a
    real MPSCNNDropoutNode, Converters.swift:918-939; we elide instead),
    same-dtype Cast, and no-op Reshape."""
    changed = 0
    keep: list[Node] = []
    for node in graph.nodes:
        elide = False
        if node.op_type in ("Dropout", "Identity"):
            elide = True
        elif node.op_type == "Cast":
            src = node.inputs[0]
            t_in = graph.value_types.get(src)
            if t_in is not None and t_in.dtype == node.attr("to"):
                elide = True
        if elide and node.outputs and node.inputs:
            # Only elide the data output; an elided Dropout mask output (rare
            # in inference graphs) would dangle — keep the node in that case.
            extra_used = False
            if len(node.outputs) > 1:
                used = {i for n2 in graph.nodes for i in n2.inputs}
                used.update(graph.output_names)
                extra_used = any(o in used for o in node.outputs[1:])
            if not extra_used:
                _rewire(graph, node.outputs[0], node.inputs[0])
                changed += 1
                continue
        keep.append(node)
    graph.nodes = keep
    return changed


# Ops that constant folding must not evaluate (nondeterministic or stateful —
# none currently) or cannot (unknown). Everything registered is fair game.
_FOLD_SKIP: set[str] = set()


@register_pass("fold_constants")
def fold_constants(graph: Graph) -> int:
    """Evaluate nodes whose inputs are all initializers, on the CPU, and
    replace them with initializers. Uses the same op lowerings as the
    executor, so folding semantics can never diverge from runtime
    semantics. CPU tensors take every kernel wrapper's plain version, so
    folding never launches a kernel."""
    import torch

    from ..ops.registry import Ctx, lower_node, resolve
    from ..ir.errors import UnknownOpError

    changed = 0
    ctx = Ctx(graph, {}, None, device="cpu")
    folded: set[int] = set()
    for node in graph.nodes:
        try:
            resolve(node.op_type, graph.opset)
        except UnknownOpError:
            continue
        if node.op_type in _FOLD_SKIP:
            continue
        if not node.inputs and node.op_type != "Constant":
            continue
        if any(i and i not in graph.initializers and i not in ctx.static_env
               for i in node.inputs):
            continue
        try:
            for i in node.inputs:
                if i and i not in ctx.env:
                    ctx.env[i] = torch.as_tensor(np.array(graph.initializers[i]))
            lower_node(ctx, node)
            for o in node.outputs:
                if o:
                    graph.initializers[o] = ctx.env[o].numpy()
                    ctx.static_env.setdefault(o, graph.initializers[o])
            folded.add(id(node))
            changed += 1
        except Exception:
            pass  # leave un-foldable node for runtime
    graph.remove_nodes(folded)
    return changed


@register_pass("fuse_pad_conv")
def fuse_pad_conv(graph: Graph) -> int:
    """Fold a zero-valued constant Pad into the pads of a following
    Conv / MaxPool / AveragePool."""
    changed = 0
    producers = graph.producers()
    consumers = graph.consumers()
    dead: set[int] = set()
    for node in graph.nodes:
        if node.op_type not in ("Conv", "MaxPool", "AveragePool"):
            continue
        if node.attr("auto_pad", "NOTSET") not in ("NOTSET", ""):
            continue
        src = producers.get(node.inputs[0])
        if src is None or src.op_type != "Pad" or id(src) in dead:
            continue
        if len(consumers.get(src.outputs[0], [])) != 1:
            continue
        mode = src.attr("mode", "constant")
        if isinstance(mode, bytes):
            mode = mode.decode()
        if mode != "constant":
            continue
        if graph.opset >= 11:
            pads_name = src.inputs[1] if len(src.inputs) > 1 else ""
            pads_arr = graph.initializers.get(pads_name)
            cval = 0.0
            if len(src.inputs) > 2 and src.inputs[2]:
                cv = graph.initializers.get(src.inputs[2])
                if cv is None:
                    continue
                cval = float(np.asarray(cv).reshape(-1)[0])
        else:
            pads_arr = np.asarray(src.attr("pads"))
            cval = src.attr("value", 0.0)
        if pads_arr is None or cval != 0.0:
            continue
        # MaxPool pads with -inf semantics at the border only when the pad is
        # consumed by the window; zero-pad folding is only safe for Conv and
        # for AveragePool with count_include_pad=1... be conservative:
        if node.op_type == "AveragePool" and not node.attr("count_include_pad", 0):
            continue
        if node.op_type == "MaxPool":
            continue
        pads = np.asarray(pads_arr, np.int64).reshape(-1)
        rank = pads.size // 2
        if rank < 3 or any(pads[i] for i in (0, 1, rank, rank + 1)):
            continue  # batch/channel pad cannot fold into conv spatial pads
        sp = rank - 2
        node_pads = node.attr("pads", [0] * (2 * sp))
        new_pads = [
            int(node_pads[i] + pads[2 + i]) for i in range(sp)
        ] + [
            int(node_pads[sp + i] + pads[rank + 2 + i]) for i in range(sp)
        ]
        node.attrs["pads"] = new_pads
        node.inputs[0] = src.inputs[0]
        dead.add(id(src))
        changed += 1
    graph.remove_nodes(dead)
    return changed


def _bn_fold_params(graph: Graph, bn: Node):
    scale, bias, mean, var = (np.asarray(graph.initializers[n], np.float64)
                              for n in bn.inputs[1:5])
    eps = bn.attr("epsilon", 1e-5)
    mult = scale / np.sqrt(var + eps)
    add = bias - mean * mult
    return mult, add


@register_pass("fuse_bn_conv")
def fuse_bn_conv(graph: Graph) -> int:
    """Conv(+bias)->BN  =>  Conv with folded weights/bias. Also handles
    ConvTranspose (grouped) and Gemm(transB). Parity with the reference's
    offline fuse_bn_into_conv (ONNX2MPS.py:107), extended."""
    changed = 0
    producers = graph.producers()
    consumers = graph.consumers()
    dead: set[int] = set()
    for bn in list(graph.find_nodes("BatchNormalization")):
        if id(bn) in dead:
            continue
        src = producers.get(bn.inputs[0])
        if src is None or id(src) in dead:
            continue
        if src.op_type not in ("Conv", "ConvTranspose", "Gemm"):
            continue
        if len(consumers.get(src.outputs[0], [])) != 1:
            continue
        if any(n not in graph.initializers for n in bn.inputs[1:5]):
            continue
        w_name = src.inputs[1]
        if w_name not in graph.initializers:
            continue
        w = np.asarray(graph.initializers[w_name], np.float64)
        mult, add = _bn_fold_params(graph, bn)
        orig_dtype = graph.initializers[w_name].dtype

        if src.op_type == "Conv":
            # (O, I/g, kh, kw): scale output-channel axis 0.
            w_new = w * mult.reshape((-1,) + (1,) * (w.ndim - 1))
        elif src.op_type == "ConvTranspose":
            g_ = int(src.attr("group", 1))
            cin, cout_g = w.shape[0], w.shape[1]
            wg = w.reshape((g_, cin // g_, cout_g) + w.shape[2:])
            m = mult.reshape(g_, cout_g)
            w_new = (wg * m[:, None, :].reshape((g_, 1, cout_g) + (1,) * (w.ndim - 2))
                     ).reshape(w.shape)
        else:  # Gemm
            if src.attr("alpha", 1.0) != 1.0 or src.attr("transA", 0):
                continue
            if src.attr("transB", 0):
                w_new = w * mult[:, None]
            else:
                w_new = w * mult[None, :]

        if len(src.inputs) > 2 and src.inputs[2]:
            b_old = np.asarray(graph.initializers[src.inputs[2]], np.float64)
            beta = src.attr("beta", 1.0) if src.op_type == "Gemm" else 1.0
            b_new = beta * b_old * mult + add
        else:
            b_new = add
        b_name = graph.fresh_name(w_name + "_bnb")
        graph.initializers[b_name] = b_new.astype(orig_dtype)
        if len(consumers.get(w_name, [])) > 1:
            # weight shared with other nodes (weight tying / siamese
            # branches): fold into a private copy, leave the original alone
            new_w_name = graph.fresh_name(w_name + "_bnw")
            graph.initializers[new_w_name] = w_new.astype(orig_dtype)
            src.inputs[1] = new_w_name
        else:
            graph.initializers[w_name] = w_new.astype(orig_dtype)
        if len(src.inputs) > 2 and src.inputs[2]:
            src.inputs[2] = b_name
        else:
            src.inputs = src.inputs[:2] + [b_name]
        if src.op_type == "Gemm":
            src.attrs["beta"] = 1.0
        # BN's output takes the conv's place.
        _rewire(graph, bn.outputs[0], src.outputs[0])
        dead.add(id(bn))
        changed += 1
    graph.remove_nodes(dead)
    return changed
