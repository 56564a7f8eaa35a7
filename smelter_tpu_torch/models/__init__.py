"""Model zoo of the port: ResNet-50, built as in the JAX package."""

from . import resnet50  # noqa: F401
