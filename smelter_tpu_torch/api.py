"""Convenience top-level API.

    import smelter_tpu_torch as stt

    model = stt.compile("model.onnx", quant="int8")      # load + optimize + params on the card
    logits = model(images)                                # numpy in/out

    server = stt.serve("model.onnx", max_batch=16)        # continuous batching
    fut = server.submit(image)

The port's counterpart of `smelter_tpu/api.py`: the same load path and pass
pipeline. Models run on the CUDA card unless `device="cpu"` is passed;
without a card the default raises. Pre-optimized artifacts (producer
"smelter-tpu" and metadata optimized=1) skip the pass pipeline.
"""

from __future__ import annotations

import dataclasses
import os

from .ir.errors import NotSupportedError
from .ir.graph import Graph
from .ir.importer import PREPROCESSED_PRODUCER, load_model
from .runtime.config import Config
from .runtime.executor import CompiledModel, resolve_device


def _prepare(model: str | os.PathLike | Graph, quant: str | None,
             optimize: bool, layout: str = "nhwc") -> Graph:
    g = load_model(model) if not isinstance(model, Graph) else model
    # Preprocessed detection needs BOTH the producer tag and the explicit
    # optimized flag the offline tool writes — a bare save_model also stamps
    # the producer, and that alone must not skip optimization.
    already = (g.producer == PREPROCESSED_PRODUCER
               and g.metadata.get("optimized") == "1")
    if optimize and not already:
        from .passes.pass_manager import run_passes

        run_passes(g)
    if quant in ("int8-static", "int8-pixel"):
        if g.metadata.get("quant") != quant:
            raise NotSupportedError(
                f"quant={quant!r} (calibrated int8) is not in the PyTorch port yet")
    elif quant and g.metadata.get("quant") != quant:
        from .quant import quantize_weights

        quantize_weights(g, mode=quant)
    from .passes.pass_manager import run_passes

    if layout == "nhwc" and optimize and g.metadata.get("layout") != "nhwc":
        from .passes.layout import NHWC_PIPELINE

        run_passes(g, NHWC_PIPELINE)
    gq = g.metadata.get("quant", "")
    if gq == "int8" or (gq.startswith(("int4-g", "int8-g"))):
        run_passes(g, ["fuse_dequant_matmul"])
    run_passes(g, ["dce"])
    return g


def _with_device(config: Config | None, device) -> Config:
    config = config or Config()
    if device is not None:
        config = dataclasses.replace(config, device=str(device))
    return config


def compile(model: str | os.PathLike | Graph, config: Config | None = None,
            quant: str | None = None, optimize: bool = True,
            layout: str = "nhwc", device: str | None = None) -> CompiledModel:
    """Load (path or Graph), optimize, optionally quantize, and put the
    params on the device (`device`, else `config.device`, else "cuda").
    layout="nhwc" (default) rewrites 4-D CNN flow to channels-last; pass
    "nchw" to keep ONNX order.
    quant:
      None        — keep float weights.
      "fp16"      — fp16 weight-only.
      "int8"      — int8 weight-only, per-channel scales; matmul weights
                    run in the port's dequant_matmul / int8_matmul kernels.
    The JAX package's calibrated modes ("int8-static", "int8-pixel") and
    4-bit/fp8 modes raise NotSupportedError here; "int8-conv" is not taken."""
    config = _with_device(config, device)
    resolve_device(config.device)  # fail before the passes, not after
    return CompiledModel(
        _prepare(model, quant, optimize, layout), config)


def serve(model: str | os.PathLike | Graph, config: Config | None = None,
          quant: str | None = None, optimize: bool = True,
          layout: str = "nhwc", device: str | None = None, **server_kw):
    from .serving import InferenceServer

    config = _with_device(config, device)
    resolve_device(config.device)
    return InferenceServer(_prepare(model, quant, optimize, layout), config,
                           **server_kw)
