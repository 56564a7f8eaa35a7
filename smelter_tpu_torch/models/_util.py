"""Shared helpers for the GraphBuilder-based model families; the port's
copy of `smelter_tpu/models/_util.py`."""

from __future__ import annotations

import numpy as np

from ..ir.graph import Graph


def rand_weight(rng, *shape, scale=None) -> np.ndarray:
    """Seeded 1/sqrt(fan_in)-scaled f32 weight."""
    scale = scale if scale is not None else 1.0 / np.sqrt(shape[0])
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def rename_edges(graph: Graph, mapping: list[tuple[str, str]]) -> None:
    """Rename graph edges (new_name, old_edge) everywhere they appear —
    used to give cache outputs stable names the generators key on."""
    for want_name, have_edge in mapping:
        for n in graph.nodes:
            n.outputs = [want_name if o == have_edge else o for o in n.outputs]
            n.inputs = [want_name if i == have_edge else i for i in n.inputs]
