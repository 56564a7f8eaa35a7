"""Parameters: host arrays -> torch tensors on the device.

`params_from_numpy` turns the arrays that name a graph's parameters (as the
JAX package's `Executor.param_names` / `graph.initializers` hand them out,
or the port's own initializers) into the port's: tensors on the device,
moved there once, in their stored dtype.

NHWC conv weights are HWIO after the layout pass. Given the graph, they are
stored over an OHWI buffer and handed out as an HWIO view of it: the Conv
lowering's OIHW view of that is channels-last, which is what cuDNN's
channels-last kernels read, so no weight is relaid per call.
"""

from __future__ import annotations

import numpy as np
import torch

from .ir.graph import Graph


def hwio_conv_weights(graph: Graph) -> set[str]:
    """Initializers that reach an NHWC Conv as its HWIO weight, directly or
    through a DequantizeLinear."""
    producers = graph.producers()
    names: set[str] = set()
    for node in graph.nodes:
        if node.op_type != "Conv" or node.attr("data_layout") != "NHWC":
            continue
        w = node.inputs[1]
        dq = producers.get(w)
        if dq is not None and dq.op_type == "DequantizeLinear":
            w = dq.inputs[0]
        if w in graph.initializers:
            names.add(w)
    return names


def _host_tensor(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr
    arr = np.asarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()  # torch.from_numpy wants writable memory
    return torch.from_numpy(np.ascontiguousarray(arr))


def params_from_numpy(arrays: dict, device, graph: Graph | None = None
                      ) -> dict[str, torch.Tensor]:
    """{name: array} -> {name: tensor on `device`}, dtypes unchanged. With
    `graph`, its NHWC conv weights are laid out for channels-last convs."""
    device = torch.device(device)
    hwio = hwio_conv_weights(graph) if graph is not None else set()
    out = {}
    for name, arr in arrays.items():
        t = _host_tensor(arr)
        if name in hwio and t.dim() == 4:
            # (H, W, I, O) view over an (O, H, W, I) buffer
            out[name] = t.permute(3, 0, 1, 2).contiguous().to(device).permute(1, 2, 3, 0)
        else:
            out[name] = t.to(device)
    return out
