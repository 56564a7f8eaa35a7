"""Model zoo of the port: ResNet-50, the LLaMA-style decoder, ViT, ESRGAN's
RRDBNet and SegNet, built as in the JAX package."""

from . import esrgan, llama_style, resnet50, segnet, vit  # noqa: F401
