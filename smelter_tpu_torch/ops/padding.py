"""ONNX convolution/pooling padding semantics -> explicit pad pairs.

This is the TPU-native equivalent of the reference's padding-policy layer
(reference: Sources/Smelter/Padding/ONNXConvolutionPadding.swift:91-113
closed-form conv/conv-transpose output sizes; PyTorchPoolPadding.swift:94-103
pool output formula; GlobalPoolPadding.swift:16-26). MPS needs runtime
offset callbacks; XLA shapes are static, so everything resolves at trace
time into explicit per-dimension (lo, hi) pads.
"""

from __future__ import annotations

import math

from ..ir.errors import NotSupportedError
from ..ir.graph import Node


def effective_kernel(k: int, dilation: int) -> int:
    return (k - 1) * dilation + 1


def conv_out_size(in_s: int, k: int, stride: int, dilation: int, lo: int, hi: int) -> int:
    """floor((in + lo + hi - eff_k)/stride) + 1 — matches the reference's
    ONNX_ConvolutionPadding.paddedSize (ONNXConvolutionPadding.swift:91-101)."""
    return (in_s + lo + hi - effective_kernel(k, dilation)) // stride + 1


def conv_transpose_out_size(
    in_s: int, k: int, stride: int, dilation: int, lo: int, hi: int, output_padding: int
) -> int:
    """(in-1)*stride + eff_k - lo - hi + output_padding — matches
    ONNXConvolutionPadding.swift:102-113."""
    return (in_s - 1) * stride + effective_kernel(k, dilation) - lo - hi + output_padding


def resolve_pads(
    node: Node,
    in_sizes: tuple[int, ...],
    kernel: tuple[int, ...],
    strides: tuple[int, ...],
    dilations: tuple[int, ...],
) -> list[tuple[int, int]]:
    """Resolve the ONNX pads/auto_pad attributes into per-spatial (lo, hi)."""
    rank = len(in_sizes)
    auto = node.attr("auto_pad", "NOTSET")
    if isinstance(auto, bytes):
        auto = auto.decode()
    if auto in ("NOTSET", ""):
        pads = node.attr("pads", [0] * (2 * rank))
        if len(pads) != 2 * rank:
            raise NotSupportedError(f"pads {pads} does not match rank {rank}")
        return [(int(pads[i]), int(pads[i + rank])) for i in range(rank)]
    if auto == "VALID":
        return [(0, 0)] * rank
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        out = []
        for i in range(rank):
            eff = effective_kernel(kernel[i], dilations[i])
            out_s = math.ceil(in_sizes[i] / strides[i])
            total = max(0, (out_s - 1) * strides[i] + eff - in_sizes[i])
            lo = total // 2 if auto == "SAME_UPPER" else (total + 1) // 2
            out.append((lo, total - lo))
        return out
    raise NotSupportedError(f"auto_pad {auto!r}")


def pool_extra_ceil_pad(
    in_s: int, k: int, stride: int, dilation: int, lo: int, hi: int
) -> int:
    """Extra trailing pad so that reduce_window(VALID) yields the ceil_mode
    output count. ONNX constrains the last window to start inside the
    (lo-)padded input."""
    eff = effective_kernel(k, dilation)
    out_ceil = math.ceil((in_s + lo + hi - eff) / stride) + 1
    # ONNX rule: last pooling window must start strictly inside input+lo pad.
    if (out_ceil - 1) * stride >= in_s + lo:
        out_ceil -= 1
    needed = (out_ceil - 1) * stride + eff - (in_s + lo + hi)
    return max(0, needed)
