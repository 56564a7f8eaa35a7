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

from .ir.graph import Graph
from .ir.importer import PREPROCESSED_PRODUCER, load_model
from .runtime.config import Config
from .runtime.executor import CompiledModel, resolve_device


def _prepare(model: str | os.PathLike | Graph, quant: str | None,
             optimize: bool, layout: str = "nhwc", calibration_data=None,
             device: str | None = None) -> Graph:
    g = load_model(model) if not isinstance(model, Graph) else model
    # Preprocessed detection needs BOTH the producer tag and the explicit
    # optimized flag the offline tool writes — a bare save_model also stamps
    # the producer, and that alone must not skip optimization.
    already = (g.producer == PREPROCESSED_PRODUCER
               and g.metadata.get("optimized") == "1")
    if optimize and not already:
        from .passes.pass_manager import run_passes

        run_passes(g)
    if quant == "int8-static":
        # Full static int8: activations and weights, folded requant
        # epilogues. Calibration runs in f32 on `device`.
        if g.metadata.get("quant") != quant:
            if calibration_data is None:
                raise ValueError(
                    "quant='int8-static' needs calibration_data: a list of "
                    "graph-input tuples, e.g. [(batch1,), (batch2,)]")
            from .quant import calibrate, quantize_static

            amax = calibrate(g, calibration_data, Config(device=device))
            quantize_static(g, amax)
    elif quant == "int8-pixel":
        # Calibrated int8 over the NHCW pixel-conv trunks only (ESRGAN-class
        # decoders); everything outside the regions stays float. Calibration
        # runs in f32 on `device`.
        if g.metadata.get("quant") != quant:
            if calibration_data is None:
                raise ValueError(
                    "quant='int8-pixel' needs calibration_data: a list of "
                    "graph-input tuples, e.g. [(batch1,), (batch2,)]")
            from .quant import calibrate, quantize_pixel_regions

            amax = calibrate(g, calibration_data, Config(device=device))
            quantize_pixel_regions(g, amax)
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
            layout: str = "nhwc", device: str | None = None,
            calibration_data=None) -> CompiledModel:
    """Load (path or Graph), optimize, optionally quantize, and put the
    params on the device (`device`, else `config.device`, else "cuda").
    layout="nhwc" (default) rewrites 4-D CNN flow to channels-last; pass
    "nchw" to keep ONNX order.
    quant:
      None        — keep float weights.
      "fp16"      — fp16 weight-only.
      "int8"      — int8 weight-only, per-channel scales; matmul weights
                    run in the port's dequant_matmul / int8_matmul kernels
                    under Config.use_pallas, else in their composites.
      "int8-static"— full static int8 (activations and weights, folded
                    requant epilogues; QLinearConv on the qlinear_conv
                    kernel); needs calibration_data: a list of graph-input
                    tuples, run in f32 on the model's device.
      "int8-pixel"— calibrated int8 over the NHCW pixel-conv regions only
                    (ESRGAN-class decoders, the pixel_conv_rowdot_q kernel;
                    everything outside the regions stays float); needs
                    calibration_data, as "int8-static".
    The JAX package's 4-bit/fp8 weight modes raise
    NotSupportedError here; "int8-conv" is not taken."""
    config = _with_device(config, device)
    resolve_device(config.device)  # fail before the passes, not after
    return CompiledModel(
        _prepare(model, quant, optimize, layout, calibration_data, config.device), config)


def serve(model: str | os.PathLike | Graph, config: Config | None = None,
          quant: str | None = None, optimize: bool = True,
          layout: str = "nhwc", device: str | None = None, **server_kw):
    from .serving import InferenceServer

    config = _with_device(config, device)
    resolve_device(config.device)
    # As in the JAX package, a calibrated mode takes a graph quantized by
    # compile's path (its metadata names the mode): serve does not calibrate.
    return InferenceServer(_prepare(model, quant, optimize, layout), config,
                           **server_kw)
