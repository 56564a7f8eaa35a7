"""Fused op lowerings: FusedDequantMatMul.

`passes/fuse_dequant.py` rewrites DequantizeLinear(int8 W, scales) ->
MatMul/Gemm into FusedDequantMatMul(x, W (K, N) int8, scales (N,)). Its
lowering always goes to the port's kernels: `dequant_matmul`, or
`int8_matmul` after `quantize_rows` when `Config.int8_activations` is set.
Each wrapper launches its Hopper kernel for CUDA tensors and takes its
plain version on the CPU and on `meta`. `Config.use_pallas` is kept so
configurations carry across from the JAX package; the port ignores it.
"""

from __future__ import annotations

from ..ir.graph import Node
from ..kernels.dequant_matmul import dequant_matmul
from ..kernels.int8_matmul import dequant_matmul_int8
from .registry import Ctx, register


@register("FusedDequantMatMul")
def fused_dequant_matmul(ctx: Ctx, node: Node):
    x = ctx.get(node.inputs[0])
    q = ctx.get(node.inputs[1])
    s = ctx.get(node.inputs[2])
    cfg = ctx.config
    int8_acts = bool(cfg is not None and getattr(cfg, "int8_activations", False))
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    fn = dequant_matmul_int8 if int8_acts else dequant_matmul
    y = fn(x2, q, s.reshape(-1))
    ctx.set(node.outputs[0], y.reshape(lead + (q.shape[-1],)))
