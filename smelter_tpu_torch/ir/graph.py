"""Typed in-memory IR for ONNX-shaped compute graphs.

The reference keeps the raw protobuf as its IR and walks it directly
(reference: Sources/Smelter/ONNXGraph.swift:106-176). We instead convert to
a small typed IR so rewrite passes, shape inference, quantization and
lowering never touch protobuf objects. Multi-output graphs are supported
(the reference enforces exactly one output, ONNXGraph.swift:178-180 — a
restriction we deliberately lift).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import numpy as np

from ..utils import dtypes as dt

# A dim is a concrete int, or a string placeholder (ONNX dim_param), or None.
Dim = int | str | None


@dataclasses.dataclass(frozen=True)
class TensorType:
    """Element dtype (ONNX code) + shape of one graph edge."""

    dtype: int
    shape: tuple[Dim, ...]

    @property
    def np_dtype(self) -> np.dtype:
        return dt.onnx_to_numpy_dtype(self.dtype)

    @property
    def is_static(self) -> bool:
        return all(isinstance(d, int) for d in self.shape)

    @property
    def num_elements(self) -> int:
        n = 1
        for d in self.shape:
            if not isinstance(d, int):
                raise ValueError(f"dynamic shape {self.shape}")
            n *= d
        return n

    def __repr__(self) -> str:
        dims = "x".join(str(d) if d is not None else "?" for d in self.shape)
        return f"{dt.dtype_name(self.dtype)}[{dims}]"


@dataclasses.dataclass
class ValueInfo:
    """A named graph edge with (possibly partial) type information."""

    name: str
    type: TensorType | None = None


@dataclasses.dataclass
class Node:
    """One operation. Attributes are decoded Python values:
    int/float/str/bytes, lists thereof, numpy arrays (TENSOR) or Graph (GRAPH)."""

    op_type: str
    inputs: list[str]
    outputs: list[str]
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)
    name: str = ""
    domain: str = ""

    def attr(self, key: str, default: Any = None) -> Any:
        return self.attrs.get(key, default)

    def __repr__(self) -> str:
        return (
            f"Node({self.op_type}, {self.inputs} -> {self.outputs}"
            + (f", {self.name!r}" if self.name else "")
            + ")"
        )


@dataclasses.dataclass
class Graph:
    """A compute graph. `nodes` is kept in topological order; initializers are
    host numpy arrays keyed by edge name."""

    name: str = "graph"
    nodes: list[Node] = dataclasses.field(default_factory=list)
    inputs: list[ValueInfo] = dataclasses.field(default_factory=list)
    outputs: list[ValueInfo] = dataclasses.field(default_factory=list)
    initializers: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    # Filled by shape inference: every edge name -> TensorType.
    value_types: dict[str, TensorType] = dataclasses.field(default_factory=dict)
    opset: int = 17
    producer: str = ""
    metadata: dict[str, str] = dataclasses.field(default_factory=dict)

    # -- queries ---------------------------------------------------------

    @property
    def input_names(self) -> list[str]:
        return [v.name for v in self.inputs]

    @property
    def output_names(self) -> list[str]:
        return [v.name for v in self.outputs]

    def producers(self) -> dict[str, Node]:
        """edge name -> node that produces it."""
        out: dict[str, Node] = {}
        for n in self.nodes:
            for o in n.outputs:
                if o:
                    out[o] = n
        return out

    def consumers(self) -> dict[str, list[Node]]:
        """edge name -> nodes that consume it."""
        out: dict[str, list[Node]] = {}
        for n in self.nodes:
            for i in n.inputs:
                if i:
                    out.setdefault(i, []).append(n)
        return out

    def is_constant(self, name: str) -> bool:
        return name in self.initializers

    def constant(self, name: str) -> np.ndarray | None:
        return self.initializers.get(name)

    def find_nodes(self, op_type: str) -> Iterator[Node]:
        return (n for n in self.nodes if n.op_type == op_type)

    def fresh_name(self, base: str) -> str:
        """A new edge name not colliding with any existing edge."""
        used = set(self.initializers)
        used.update(v.name for v in self.inputs)
        used.update(v.name for v in self.outputs)
        for n in self.nodes:
            used.update(n.inputs)
            used.update(n.outputs)
        if base not in used:
            return base
        k = 0
        while f"{base}_{k}" in used:
            k += 1
        return f"{base}_{k}"

    # -- mutation helpers used by rewrite passes -------------------------

    def remove_nodes(self, dead: set[int]) -> None:
        """Remove nodes by identity (id())."""
        self.nodes = [n for n in self.nodes if id(n) not in dead]

    def toposort(self) -> None:
        """Re-sort nodes topologically (stable for already-sorted graphs)."""
        available = set(self.initializers) | {v.name for v in self.inputs}
        remaining = list(self.nodes)
        ordered: list[Node] = []
        while remaining:
            progressed = False
            still: list[Node] = []
            for n in remaining:
                if all((not i) or (i in available) for i in n.inputs):
                    ordered.append(n)
                    available.update(o for o in n.outputs if o)
                    progressed = True
                else:
                    still.append(n)
            remaining = still
            if not progressed and remaining:
                missing = {
                    i
                    for n in remaining
                    for i in n.inputs
                    if i and i not in available
                }
                raise ValueError(
                    f"graph has a cycle or dangling inputs: {sorted(missing)[:5]}"
                )
        self.nodes = ordered

    def dead_code_eliminate(self) -> int:
        """Drop nodes whose outputs reach no graph output. Returns #removed."""
        needed = set(self.output_names)
        kept_rev: list[Node] = []
        for n in reversed(self.nodes):
            if any(o in needed for o in n.outputs):
                kept_rev.append(n)
                needed.update(i for i in n.inputs if i)
        removed = len(self.nodes) - len(kept_rev)
        self.nodes = list(reversed(kept_rev))
        live = {i for n in self.nodes for i in n.inputs if i}
        live.update(self.output_names)
        self.initializers = {k: v for k, v in self.initializers.items() if k in live}
        return removed

    def summary(self) -> str:
        from collections import Counter

        ops = Counter(n.op_type for n in self.nodes)
        lines = [
            f"Graph {self.name!r}: {len(self.nodes)} nodes, "
            f"{len(self.initializers)} initializers, opset {self.opset}",
            f"  inputs:  {[(v.name, v.type) for v in self.inputs]}",
            f"  outputs: {[(v.name, v.type) for v in self.outputs]}",
            "  ops: " + ", ".join(f"{k}x{v}" for k, v in sorted(ops.items())),
        ]
        return "\n".join(lines)
