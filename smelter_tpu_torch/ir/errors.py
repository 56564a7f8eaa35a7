"""Error hierarchy for import/build/lowering failures.

Mirrors the capability of the reference's thrown error enum (reference:
Sources/Smelter/ONNXGraph.swift:38-47 — unknownNodeOpType, noSuchOutput,
insufficientInputs, inconsistentState, notSupported), as a Python exception
tree so callers can catch broad or narrow.
"""

from __future__ import annotations


class SmelterError(Exception):
    """Base class for all smelter-tpu errors."""


class ImportError_(SmelterError):
    """Model file could not be parsed / decoded."""


class UnknownOpError(SmelterError):
    """No lowering registered for an op type (+ opset version)."""

    def __init__(self, op_type: str, opset: int | None = None):
        self.op_type = op_type
        self.opset = opset
        suffix = f" (opset {opset})" if opset is not None else ""
        super().__init__(f"unknown op type {op_type!r}{suffix}")


class NoSuchValueError(SmelterError):
    """A node references an edge name that no prior node/initializer/input produced."""

    def __init__(self, name: str, consumer: str = ""):
        self.name = name
        where = f" (consumed by {consumer})" if consumer else ""
        super().__init__(f"no such value {name!r}{where}")


class InsufficientInputsError(SmelterError):
    """A node has fewer inputs than its op requires."""

    def __init__(self, node_name: str, op_type: str, got: int, want: int):
        super().__init__(
            f"node {node_name!r} ({op_type}): expected >= {want} inputs, got {got}"
        )


class ShapeError(SmelterError):
    """Shape inference failed or shapes are inconsistent."""


class UnresolvedDimError(ShapeError):
    """A symbolic/dynamic input dimension was not resolved by config overrides."""

    def __init__(self, value_name: str, axis: int, dim_param: str):
        self.value_name = value_name
        self.axis = axis
        self.dim_param = dim_param
        super().__init__(
            f"input {value_name!r} axis {axis} has unresolved dim "
            f"{dim_param!r}; pass dims={{...}} in Config to pin it"
        )


class NotSupportedError(SmelterError):
    """Valid ONNX, but outside this engine's supported envelope."""


class InconsistentStateError(SmelterError):
    """Internal invariant violated while building/lowering the graph."""
