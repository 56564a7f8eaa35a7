"""The walk's plan: runs of nodes that the executor lowers as one call.

The JAX package's graph runs under jit, and XLA fuses an int8-static
network's elementwise chains into the ops around them: the dequant -> add
-> relu -> quant chain of a residual join becomes one int8-in/int8-out
kernel (`smelter_tpu/quant/static_quant.py::_requantize_carries`), an int8
Relu joins the conv it follows. The port walks the graph eagerly, node by
node, so it makes those groupings itself, once per forward function and
from the graph alone. The graph stays node for node the JAX package's: the
grouping belongs to the walk, as XLA's fusion belongs to jit.

Two groups, each only where every inner edge has exactly one reader and is
no graph output, the scales are static and per tensor, the zero points zero
and the tensors int8:

- `ConvRelu`: QLinearConv -> Relu on its int8 output, one `qlinear_conv`
  call with the epilogue clipping at 0;
- `Join`: DequantizeLinear(a), DequantizeLinear(b) -> Add -> Relu [->
  QuantizeLinear], one `int8_join` call writing the int8 edge after the
  QuantizeLinear or, without one, the Relu's f32 edge.

A group runs where its last node stood: every input it reads is made by
then, and nothing reads its output before. On every device it gives, bit
for bit, the edges the node-by-node walk gives at the group's end (the CPU
and `meta` take the kernels' plain versions); the inner edges are not
made.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ir.graph import Graph, Node
from ..kernels import int8_join as ij
from ..ops import quant_ops
from ..ops.registry import Ctx


@dataclasses.dataclass(frozen=True)
class ConvRelu:
    conv: Node
    relu: Node

    @property
    def nodes(self) -> tuple[Node, ...]:
        return (self.conv, self.relu)

    @property
    def last(self) -> Node:
        return self.relu

    def run(self, ctx: Ctx) -> None:
        ctx.set(self.relu.outputs[0], quant_ops.qlinear_conv_out(ctx, self.conv, relu=True))


@dataclasses.dataclass(frozen=True)
class Join:
    dq_a: Node
    dq_b: Node
    add: Node
    relu: Node
    quant: Node | None  # None: the Relu's f32 edge ends the chain
    s_a: float
    s_b: float
    inv_y: float | None

    @property
    def nodes(self) -> tuple[Node, ...]:
        return tuple(n for n in (self.dq_a, self.dq_b, self.add, self.relu, self.quant)
                     if n is not None)

    @property
    def last(self) -> Node:
        return self.quant if self.quant is not None else self.relu

    def run(self, ctx: Ctx) -> None:
        y = ij.int8_join(ctx.get(self.dq_a.inputs[0]), ctx.get(self.dq_b.inputs[0]),
                         self.s_a, self.s_b, self.inv_y)
        ctx.set(self.last.outputs[0], y)


def _int8_zero(graph: Graph, node: Node, pos: int) -> bool:
    """Input `pos` of `node` is a static int8 zero point of zeros."""
    name = node.inputs[pos] if pos < len(node.inputs) else ""
    zp = graph.initializers.get(name) if name else None
    return zp is not None and np.asarray(zp).dtype == np.int8 and not np.any(zp)


def _per_tensor(graph: Graph, node: Node) -> np.ndarray | None:
    """For a DequantizeLinear or QuantizeLinear node: its static scale, 0-d
    as stored, where the node is the int8 per-tensor form with a zero point
    of zeros."""
    if int(node.attr("block_size", 0)) != 0 or not _int8_zero(graph, node, 2):
        return None
    s = graph.initializers.get(node.inputs[1])
    if s is None or np.asarray(s).size != 1 or not np.asarray(s).dtype.kind == "f":
        return None
    return np.asarray(s).reshape(())


def groups(graph: Graph) -> list:
    """The walk's groups of `graph`."""
    producers = graph.producers()
    consumers = graph.consumers()
    outputs = set(graph.output_names)

    def sole(edge: str, op_type: str) -> Node | None:
        """The one reader of an inner edge, if it is an `op_type`."""
        readers = consumers.get(edge, [])
        if edge in outputs or len(readers) != 1 or readers[0].op_type != op_type:
            return None
        return readers[0]

    found = []
    for node in graph.nodes:
        if node.op_type == "QLinearConv":
            relu = sole(node.outputs[0], "Relu")
            if relu is not None:
                found.append(ConvRelu(node, relu))
        elif node.op_type == "Add" and len(node.inputs) == 2:
            dqs = [producers.get(e) for e in node.inputs]
            if any(d is None or d.op_type != "DequantizeLinear"
                   or sole(d.outputs[0], "Add") is not node for d in dqs):
                continue
            scales = [_per_tensor(graph, d) for d in dqs]
            relu = sole(node.outputs[0], "Relu")
            if any(s is None for s in scales) or relu is None:
                continue
            quant = sole(relu.outputs[0], "QuantizeLinear")
            inv_y = None
            if quant is not None:
                s_y = _per_tensor(graph, quant)
                if s_y is None:
                    quant = None
                else:  # the reciprocal taken in f64, as the lowering folds it
                    inv_y = float(np.float32(np.reciprocal(s_y.astype(np.float64))))
            found.append(Join(dqs[0], dqs[1], node, relu, quant, float(np.float32(scales[0])),
                              float(np.float32(scales[1])), inv_y))
    return found


def plan(graph: Graph) -> list:
    """The walk: graph.nodes with each group's nodes replaced by the group,
    at its last node's place."""
    at_last, members = {}, set()
    for grp in groups(graph):
        at_last[id(grp.last)] = grp
        members.update(id(n) for n in grp.nodes)
    return [at_last.get(id(n), n) for n in graph.nodes
            if id(n) not in members or id(n) in at_last]
