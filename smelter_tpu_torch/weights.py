"""Parameters: host arrays -> torch tensors on the device.

`params_from_numpy` turns the arrays that name a graph's parameters (as the
JAX package's `Executor.param_names` / `graph.initializers` hand them out,
or the port's own initializers) into the port's: tensors on the device,
moved there once, in their stored dtype.

NHWC conv weights are HWIO after the layout pass. Given the graph, they are
stored over an OHWI buffer and handed out as an HWIO view of it: the Conv
lowering's OIHW view of that is channels-last, which is what cuDNN's
channels-last kernels read, so no weight is relaid per call. QLinearConv's
int8 weights are stored over an OHWI buffer too (an OIHW view of it, or an
HWIO one under data_layout=NHWC): K = kh * kw * C_in contiguous, the layout
`kernels/qlinear_conv.py` reads. PixelConv and PixelConvQ weights (OIHW)
are stored over an HWOI buffer, the [3, 3, C_out, C_in] layout
`kernels/pixel_conv.py` reads.
"""

from __future__ import annotations

import numpy as np
import torch

from .ir.graph import Graph


def hwio_conv_weights(graph: Graph) -> set[str]:
    """Initializers that reach an NHWC Conv as its HWIO weight, directly or
    through a DequantizeLinear, and NHWC QLinearConvs' HWIO weights."""
    producers = graph.producers()
    names: set[str] = set()
    for node in graph.nodes:
        if node.attr("data_layout") != "NHWC":
            continue
        if node.op_type == "QLinearConv" and node.inputs[3] in graph.initializers:
            names.add(node.inputs[3])
        if node.op_type != "Conv":
            continue
        w = node.inputs[1]
        dq = producers.get(w)
        if dq is not None and dq.op_type == "DequantizeLinear":
            w = dq.inputs[0]
        if w in graph.initializers:
            names.add(w)
    return names


def qlinear_conv_weights(graph: Graph) -> set[str]:
    """Initializers that are an NCHW QLinearConv's OIHW weight."""
    return {node.inputs[3] for node in graph.nodes
            if node.op_type == "QLinearConv" and node.attr("data_layout", "NCHW") == "NCHW"
            and node.inputs[3] in graph.initializers}


def pixel_conv_weights(graph: Graph) -> set[str]:
    """Initializers that are a PixelConv's or PixelConvQ's weight."""
    return {node.inputs[1] for node in graph.nodes
            if node.op_type in ("PixelConv", "PixelConvQ")
            and node.inputs[1] in graph.initializers}


def _host_tensor(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr
    arr = np.asarray(arr)
    if not (arr.flags.writeable and arr.flags.c_contiguous):
        # torch.from_numpy wants writable memory; a C-order copy keeps the
        # shape (np.ascontiguousarray makes a 0-d array 1-d)
        arr = np.array(arr, copy=True, order="C")
    return torch.from_numpy(arr)


def params_from_numpy(arrays: dict, device, graph: Graph | None = None
                      ) -> dict[str, torch.Tensor]:
    """{name: array} -> {name: tensor on `device`}, dtypes unchanged. With
    `graph`, its NHWC conv weights are laid out for channels-last convs, its
    QLinearConv weights for the int8 conv kernel and its PixelConv weights
    for the pixel-conv kernel."""
    device = torch.device(device)
    hwio = hwio_conv_weights(graph) if graph is not None else set()
    oihw = qlinear_conv_weights(graph) if graph is not None else set()
    pixel = pixel_conv_weights(graph) if graph is not None else set()
    out = {}
    for name, arr in arrays.items():
        t = _host_tensor(arr)
        if name in hwio and t.dim() == 4:
            # (H, W, I, O) view over an (O, H, W, I) buffer
            out[name] = t.permute(3, 0, 1, 2).contiguous().to(device).permute(1, 2, 3, 0)
        elif name in oihw and t.dim() == 4:
            # (O, I, H, W) view over an (O, H, W, I) buffer
            out[name] = t.permute(0, 2, 3, 1).contiguous().to(device).permute(0, 3, 1, 2)
        elif name in pixel and t.dim() == 4:
            # (O, I, H, W) view over an (H, W, O, I) buffer
            out[name] = t.permute(2, 3, 0, 1).contiguous().to(device).permute(2, 3, 0, 1)
        else:
            out[name] = t.to(device)
    return out
