"""Model zoo of the port: ResNet-50, the LLaMA-style decoder and ViT, built
as in the JAX package."""

from . import llama_style, resnet50, vit  # noqa: F401
