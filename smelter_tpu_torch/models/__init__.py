"""Model zoo of the port: ResNet-50 and the LLaMA-style decoder, built as in
the JAX package."""

from . import llama_style, resnet50  # noqa: F401
