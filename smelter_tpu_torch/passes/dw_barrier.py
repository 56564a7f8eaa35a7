"""Scheduling barrier after depthwise convs feeding LayerNorm.

probe84/86 (round 5): at ConvNeXt stage-1 geometry (c96@56, b64) XLA's
COMPOSED dw7x7 -> LN -> MLP chain measures 1.76 ms while the sum of the
same pieces in isolation is 1.05 ms — fusing the LayerNorm into the
depthwise conv's consumer produces a worse schedule than not fusing.
Barrier surgery isolated the seam: an optimization_barrier after the
dwconv recovers 1.18x at stage 1 (1.757 -> 1.484 ms) and 1.08x at
stage 2, while barriers at the LN->MLP or MLP->residual seams do
nothing. This pass inserts exactly that barrier: after every depthwise
Conv whose value flows into a LayerNormalization (directly or through
Transpose/Reshape layout glue).

Numerics-preserving by construction (the barrier is the identity).
Reference scope: none — XLA scheduling remediation, the analog of the
region gates in passes/pixel_regions.py.
"""

from __future__ import annotations

from ..ir.graph import Graph, Node
from .pass_manager import register_pass

_GLUE = {"Transpose", "Reshape", "Cast", "Identity"}
_NORMS = {"LayerNormalization", "SkipLayerNormalization",
          "SimplifiedLayerNormalization"}


def _is_depthwise(graph: Graph, node: Node) -> bool:
    if node.op_type != "Conv" or len(node.inputs) < 2:
        return False
    w = graph.initializers.get(node.inputs[1])
    if w is None:
        prod = next((n for n in graph.nodes
                     if node.inputs[1] in n.outputs), None)
        if prod is not None and prod.op_type == "DequantizeLinear":
            w = graph.initializers.get(prod.inputs[0])
    if w is None or w.ndim != 4 or int(node.attr("group", 1)) <= 1:
        return False
    cin_per_g = (w.shape[2] if node.attr("data_layout", "") == "NHWC"
                 else w.shape[1])
    return cin_per_g == 1


def _feeds_norm(graph: Graph, edge: str, depth: int = 3) -> bool:
    if depth < 0:
        return False
    for n in graph.nodes:
        if edge not in n.inputs:
            continue
        if n.op_type in _NORMS:
            return True
        if n.op_type in _GLUE and _feeds_norm(graph, n.outputs[0],
                                              depth - 1):
            return True
    return False


@register_pass("dwconv_ln_barrier")
def dwconv_ln_barrier(graph: Graph) -> int:
    """Insert OptimizationBarrier after dwconv outputs that reach a
    LayerNorm. Returns the number of barriers inserted."""
    count = 0
    new_nodes: list[Node] = []
    for node in graph.nodes:
        new_nodes.append(node)
        if not _is_depthwise(graph, node):
            continue
        out = node.outputs[0]
        if not _feeds_norm(graph, out):
            continue
        barred = graph.fresh_name(out + "_bar")
        bar = Node("OptimizationBarrier", inputs=[out],
                   outputs=[barred],
                   name=graph.fresh_name(node.name + "_bar"))
        new_nodes.append(bar)
        for consumer in graph.nodes:
            if consumer is node or consumer is bar:
                continue
            consumer.inputs = [barred if i == out else i
                               for i in consumer.inputs]
        count += 1
    if count:
        graph.nodes = new_nodes
        graph.toposort()
    return count
