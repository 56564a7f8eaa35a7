"""Calibration for the calibrated int8 modes: `calibrate`, the per-edge
abs-max of a graph's float activations over sample inputs.

The port's part of `smelter_tpu/quant/static_quant.py`. It runs the same
lowerings the compiled model runs, through the executor's return-all-edges
walk, on the configuration's device, so observed ranges are exactly what
the runtime computes. Each edge's abs-max is taken on the device and the
maxima of one sample come back to the host together; a percentile needs the
values on the host, subsampled there as the JAX package does. The static
rewrite (`quantize_static`) is not in the port yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ir.graph import Graph

_SUBSAMPLE = 1 << 20  # values a percentile reads at most from one edge


def calibrate(graph: Graph, sample_inputs: list[tuple[np.ndarray, ...]],
              config=None, percentile: float | None = None) -> dict[str, float]:
    """Run `sample_inputs` (a list of graph-input tuples) through the graph
    and record each float edge's |value| range (the max over samples).
    percentile (e.g. 99.9) clips outliers: it trades saturation of rare
    extremes for resolution of the bulk. Initializers are not edges."""
    from ..runtime.executor import Executor

    ex = Executor(graph, config)
    fn = ex.build_fn(return_all_edges=True)
    params = ex.cast_params(ex.init_params())
    amax: dict[str, float] = {}
    for inputs in sample_inputs:
        env = fn(params, *inputs)
        names, maxima = [], []
        for name, val in env.items():
            if name in graph.initializers or not isinstance(val, torch.Tensor) \
                    or not val.dtype.is_floating_point:
                continue
            if val.numel() == 0:
                m = torch.zeros((), device=val.device)
            elif percentile is not None:
                flat = val.detach().abs().reshape(-1)
                if flat.numel() > _SUBSAMPLE:
                    flat = flat[:: flat.numel() // _SUBSAMPLE + 1]
                m = torch.tensor(float(np.percentile(flat.float().cpu().numpy(), percentile)))
            else:
                m = val.detach().abs().amax().float()
            names.append(name)
            maxima.append(m.to(val.device))
        del env
        if not names:
            continue
        host = torch.stack(maxima).cpu().tolist()
        for name, m in zip(names, host):
            amax[name] = max(amax.get(name, 0.0), float(m))
    return amax
