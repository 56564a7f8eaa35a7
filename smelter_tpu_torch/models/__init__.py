"""Model zoo of the port: ResNet-50, the LLaMA-style decoder, ViT, ESRGAN's
RRDBNet, SegNet, ConvNeXt and the SD-style UNet, built as in the JAX
package."""

from . import convnext, esrgan, llama_style, resnet50, sd_unet, segnet, vit  # noqa: F401
