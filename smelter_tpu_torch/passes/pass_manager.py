"""Graph rewrite pass pipeline.

The TPU-native analog of the reference's offline optimizer
(reference: ONNX2MPS.py:104-109 — onnx.checker validate, BN-into-Conv
fusion via onnx.optimizer, dtype cast, weight swizzle). Here passes are
first-class functions over the typed IR, composable and individually
tested. The default pipeline is what the offline tool and the engine's
`optimize=True` path run.
"""

from __future__ import annotations

from typing import Callable

from ..ir.graph import Graph

PassFn = Callable[[Graph], int]  # returns number of changes

_PASSES: dict[str, PassFn] = {}


def register_pass(name: str):
    def deco(fn: PassFn) -> PassFn:
        _PASSES[name] = fn
        return fn

    return deco


def get_pass(name: str) -> PassFn:
    return _PASSES[name]


def available_passes() -> list[str]:
    return sorted(_PASSES)


DEFAULT_PIPELINE = [
    "eliminate_nops",
    "fold_constants",
    "fuse_pad_conv",
    "fuse_bn_conv",
    # split_concat_conv is registered but OFF by default: the micro win
    # (tpu_probe19 [A]: 2.52x on 5x64->64) inverts in real decoder graphs
    # (tpu_probe22: ESRGAN 173 vs 213 img/s, tpu_probe23: U-Net 1000 vs
    # 1024) — the split parts' small C_in pads worse on the 128-lane MXU
    # than the one concatenated GEMM.
    "subpixel_upsample_conv",
    # pixel_conv_regions routes small-C_out 3x3 convs to the pixel-major
    # Pallas kernel and keeps decoder trunks in its NHCW layout (2.5x on
    # ESRGAN RRDB trunks, probe43); it runs before pack_conv_output so
    # packing only takes the convs it cannot.
    "pixel_conv_regions",
    # stem_space_to_depth is registered but OFF by default: probe34c shows
    # XLA already lowers the small-C_in stride-2 stem at the same cost as
    # every alternative formulation (f32 NCHW 0.895 ms == transposed NHWC
    # 0.849 == int8 0.846 == S2D 0.906 on the b128 ResNet stem) — the conv
    # is input-layout-bound and the rewrite buys nothing end-to-end
    # (probe34b: 12,266 vs 12,158 img/s, within run noise).
    "pack_conv_output",
    "fold_constants",
    "fuse_attention",
    "fuse_qkv_attention",
    # whole-block attention kernel (LN->QKV->attn->proj in one pallas
    # call): 2.5x XLA's block at ViT-B geometry (probe52); gated inside
    # the pass to even heads with 128-lane head pairs
    "fuse_vit_block",
    "fuse_residual_ln",
    # fuse_mlp_block is registered but OFF by default: the whole-MLP
    # kernel wins its microbench (164 vs 109 TF, probe54) yet LOSES every
    # interleaved e2e A/B (probe55/56: ViT-B -2.3%, BERT -5%, speech
    # -24%) — XLA's batched (B*N, D) GEMM formulation beats per-image
    # grids for the MLP, whose fusion barriers were already cheap.
    "eliminate_nops",
    "dce",
]


def run_passes(graph: Graph, pipeline: list[str] | None = None, verbose: bool = False) -> Graph:
    """Run the pipeline in place (returns the same graph for chaining)."""
    from . import (  # noqa: F401  (registration side effects)
        all_passes, decoder_fusion, dw_barrier, fuse_attention,
        fuse_dequant, layout, mxu_packing, pixel_regions, vit_block)

    for name in pipeline or DEFAULT_PIPELINE:
        n = _PASSES[name](graph)
        if verbose and n:
            print(f"[pass] {name}: {n} changes")
    return graph
