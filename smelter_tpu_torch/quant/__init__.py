"""Quantization: weight-only (fp16 cast, int8 per-channel symmetric, int4
groups), calibration, the full static int8 rewrite, and the calibrated
int8 pixel-conv regions."""

from .pixel_quant import quantize_pixel_regions  # noqa: F401
from .static_quant import calibrate, quantize_static  # noqa: F401
from .weight_quant import dequantize_array, quantize_array, quantize_weights  # noqa: F401
