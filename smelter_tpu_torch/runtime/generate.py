"""Decode-loop helpers shared by the decode servers.

The port's counterpart of `smelter_tpu/runtime/generate.py`, with
`_cache_dtypes` only; the generators (Generator, FusedGenerator and the
prefill ladder) are not ported yet.
"""

from __future__ import annotations

import torch

from ..utils import dtypes as dt
from .executor import _COMPUTE_DTYPES


def _cache_dtypes(step_graph, config, cache_names) -> list[torch.dtype]:
    """Dtypes to seed the KV caches with: the executor runs floating inputs
    in its compute dtype, and the caches are carried from step to step (in
    place, in the port), so a floating cache is made in the compute dtype
    and an integer one in its declared type."""
    cd = _COMPUTE_DTYPES[config.compute_dtype]
    by = {}
    for v in step_graph.inputs:
        tdt = dt.onnx_to_torch_dtype(v.type.dtype)
        by[v.name] = cd if tdt.is_floating_point else tdt
    return [by[n] for n in cache_names]
