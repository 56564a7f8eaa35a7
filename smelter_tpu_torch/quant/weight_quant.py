"""Weight quantization graph rewrites (north star: weight-only FP16/INT8
with per-channel scales, BASELINE.json:5; the fp16 mode is the analog of
ONNX2MPS --half, reference ONNX2MPS.py:14-31).

fp16 mode: cast weight initializers of matmul-family ops to fp16; the
lowering casts back up to the activation dtype at the op (weight-only —
activations keep their compute dtype).

int8 mode: per-output-channel symmetric scales s = amax/127; the weight
initializer becomes int8 and a DequantizeLinear node (standard ONNX op,
axis-scoped scales) is inserted before the consumer; the fuse_dequant_matmul
pass then turns DequantizeLinear + MatMul/Gemm into FusedDequantMatMul.

The port's copy of `smelter_tpu/quant/weight_quant.py`, bit-equal to it.
"""

from __future__ import annotations

import re

import numpy as np

from ..ir.errors import NotSupportedError
from ..ir.graph import Graph, Node

# Ops whose weight operand (input index 1) is worth quantizing.
QUANT_OPS = ("Conv", "ConvTranspose", "Gemm", "MatMul")


def _channel_axis(op_type: str, node: Node, w: np.ndarray) -> int:
    """Output-channel axis of the weight tensor, for per-channel scales."""
    if op_type == "Conv":
        return 0  # (O, I/g, *k)
    if op_type == "ConvTranspose":
        return 1  # (I, O/g, *k)
    if op_type == "Gemm":
        return 0 if node.attr("transB", 0) else 1
    return w.ndim - 1  # MatMul rhs: (..., K, N) -> N


def quantize_array(w: np.ndarray, axis: int) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-channel int8 quantization along `axis`.
    Returns (q: int8, scales: float32 with w's rank, size 1 except axis).

    Bit-equal to the JAX package, which sends axis-0 weights of 65,536 or
    more elements to its native library: that library computes
    nearbyint(w * (1/s)) in float32, and the smaller ones round(w / s).
    The two can differ by one step at half-way points, so both formulas
    are kept here, in numpy float32."""
    w = np.asarray(w, np.float32)
    red = tuple(i for i in range(w.ndim) if i != axis)
    amax = np.abs(w).max(axis=red, keepdims=True)
    scales = (amax / 127.0).astype(np.float32)
    scales = np.where(scales == 0, np.float32(1.0), scales)
    if axis == 0 and w.ndim >= 1 and w.size >= 1 << 16:
        inv = (np.float32(1.0) / scales).astype(np.float32)
        q = np.clip(np.rint(w * inv), -127, 127).astype(np.int8)
    else:
        q = np.clip(np.round(w / scales), -127, 127).astype(np.int8)
    return q, scales


def dequantize_array(q: np.ndarray, scales: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * scales


def quantize_weights(
    graph: Graph,
    mode: str = "int8",
    min_elements: int = 1024,
    ops: tuple[str, ...] = QUANT_OPS,
) -> Graph:
    """Rewrite `graph` in place with quantized weights. Weights consumed by
    several nodes are quantized once (first consumer's axis wins).

    mode: "int8" (per-channel) or "fp16". The JAX package's "fp8", "int4"
    and grouped "int8-g<N>" / "int4-g<N>" modes raise NotSupportedError
    here: they need 4-bit and fp8 storage, which the port has not got yet."""
    if mode not in ("int8", "fp16"):
        if mode in ("fp8", "int4") or re.fullmatch(r"int[48]-g\d+", mode or ""):
            raise NotSupportedError(
                f"quant mode {mode!r} is not in the PyTorch port yet")
        raise ValueError(f"quant mode {mode!r}")
    done: set[str] = set()
    new_nodes: list[Node] = []
    for node in graph.nodes:
        new_nodes.append(node)
        if node.op_type not in ops or len(node.inputs) < 2:
            continue
        w_name = node.inputs[1]
        w = graph.initializers.get(w_name)
        if w is None or w.dtype != np.float32 or w.size < min_elements:
            continue
        if mode == "fp16":
            if w_name not in done:
                graph.initializers[w_name] = w.astype(np.float16)
                done.add(w_name)
            continue
        # int8: replace weight, insert DequantizeLinear before this node.
        deq_name = w_name + "_deq"
        if w_name not in done:
            axis = _channel_axis(node.op_type, node, w)
            q, scales = quantize_array(w, axis)
            graph.initializers[w_name] = q
            graph.initializers[w_name + "_scale"] = scales.reshape(-1).astype(np.float32)
            deq = Node(
                "DequantizeLinear",
                inputs=[w_name, w_name + "_scale"],
                outputs=[deq_name],
                attrs={"axis": axis},
                name=graph.fresh_name(w_name + "_dq"),
            )
            new_nodes.insert(len(new_nodes) - 1, deq)
            done.add(w_name)
        node.inputs[1] = deq_name
    graph.nodes = new_nodes
    graph.toposort()
    graph.metadata["quant"] = mode
    return graph
