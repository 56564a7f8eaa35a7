"""Serving layer: continuous batching + metrics."""

from .metrics import Metrics  # noqa: F401
from .server import InferenceServer  # noqa: F401
