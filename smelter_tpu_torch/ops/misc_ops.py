"""Miscellaneous op lowerings: OptimizationBarrier (the ConvNeXt graph).

Counterpart of `smelter_tpu/ops/misc_ops.py`. `passes/dw_barrier.py` puts an
OptimizationBarrier after each depthwise Conv that feeds a LayerNorm; there
it keeps XLA from fusing across the seam. PyTorch runs eagerly and fuses
nothing, so here it is the identity.
"""

from __future__ import annotations

from ..ir.graph import Node
from .registry import Ctx, register


@register("OptimizationBarrier")
def optimization_barrier(ctx: Ctx, node: Node):
    ctx.set(node.outputs[0], ctx.get(node.inputs[0]))
