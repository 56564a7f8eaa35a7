"""Weight-only quantization: fp16 cast and int8 per-channel symmetric."""

from .weight_quant import dequantize_array, quantize_array, quantize_weights  # noqa: F401
