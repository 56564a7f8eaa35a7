"""Op-lowering registry: ONNX op type -> function computing torch tensors.

The port's counterpart of `smelter_tpu/ops/registry.py`: registration is
versioned by ONNX opset, and each lowering reads its inputs from and writes
its outputs to the Ctx. PyTorch runs eagerly, so a lowering computes on the
tensors it is given, on their device (`meta` for shape inference).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..ir.errors import (
    InsufficientInputsError,
    NoSuchValueError,
    NotSupportedError,
    UnknownOpError,
)
from ..ir.graph import Graph, Node

# op_type -> list of (since_opset, fn, static_positions) sorted at
# resolve time.
_REGISTRY: dict[str, list[tuple[int, Callable, frozenset[int]]]] = {}


def register(op_type: str, since: int = 1,
             static: set[int] | frozenset[int] = frozenset()):
    """Register a lowering for `op_type`, valid for opset >= `since`.

    `static` declares the input POSITIONS this lowering reads as
    trace-time constants via `ctx.static(...)` — an initializer used
    *only* in such positions is folded into the compiled program instead
    of becoming a runtime param (the analog of the reference folding
    Constant nodes into its tensor dict, Converters.swift:716-727).
    Declaring it here, at the lowering, keeps the fold self-maintaining:
    a new op that calls ctx.static on an input MUST list that position
    or the constant is uploaded as a param every call."""

    def deco(fn: Callable) -> Callable:
        _REGISTRY.setdefault(op_type, []).append(
            (since, fn, frozenset(static)))
        return fn

    return deco


def _best(op_type: str, opset: int):
    cands = _REGISTRY.get(op_type)
    if not cands:
        raise UnknownOpError(op_type, opset)
    best = None
    for entry in cands:
        if entry[0] <= opset and (best is None or entry[0] > best[0]):
            best = entry
    if best is None:
        raise UnknownOpError(op_type, opset)
    return best


def resolve(op_type: str, opset: int) -> Callable:
    return _best(op_type, opset)[1]


def static_positions(op_type: str, opset: int) -> frozenset[int]:
    """Input positions the resolved lowering consumes as trace-time
    constants; empty for unknown ops (the executor's resolve loop
    reports those with a proper error)."""
    try:
        return _best(op_type, opset)[2]
    except UnknownOpError:
        return frozenset()


def registered_ops() -> list[str]:
    return sorted(_REGISTRY)


class Ctx:
    """Lowering context handed to each op lowering.

    `get`/`set` move torch tensors along edges; `static` reads host values
    known before the run (initializers, or values produced by statically
    evaluable ops like Constant). `device` is where new constants go.
    """

    def __init__(self, graph: Graph, env: dict[str, Any], config=None,
                 device: torch.device | str = "cpu"):
        self.graph = graph
        self.env = env
        self.config = config
        self.device = torch.device(device)
        # Host-side (numpy) values known at trace time, keyed by edge name.
        self.static_env: dict[str, np.ndarray] = {}

    @property
    def opset(self) -> int:
        return self.graph.opset

    def get(self, name: str):
        if name not in self.env:
            raise NoSuchValueError(name)
        return self.env[name]

    def has(self, name: str) -> bool:
        return bool(name) and name in self.env

    def set(self, name: str, value) -> None:
        self.env[name] = value

    def set_static(self, name: str, value: np.ndarray) -> None:
        """Record a host-side constant for `name` (also visible as a tensor)."""
        value = np.asarray(value)
        self.static_env[name] = value
        self.env[name] = torch.as_tensor(np.array(value), device=self.device)

    def static(self, name: str, *, required: bool = True) -> np.ndarray | None:
        """Host value of an edge known before the run, or None if
        absent/unknown."""
        if not name:
            if required:
                raise NoSuchValueError(name)
            return None
        if name in self.static_env:
            return self.static_env[name]
        if name in self.graph.initializers:
            return self.graph.initializers[name]
        if required:
            raise NotSupportedError(
                f"value {name!r} must be a compile-time constant (initializer "
                f"or statically evaluable); run constant folding first if it "
                f"is computed from constants"
            )
        return None

    def inputs(self, node: Node, minimum: int = 0) -> list[str]:
        names = [i for i in node.inputs]
        if len([n for n in names if n]) < minimum:
            raise InsufficientInputsError(node.name, node.op_type, len(names), minimum)
        return names


def lower_node(ctx: Ctx, node: Node) -> None:
    fn = resolve(node.op_type, ctx.opset)
    fn(ctx, node)
