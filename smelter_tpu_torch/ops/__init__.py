"""Op-lowering registry and the op implementations of the port's slice.

Only the ops the ResNet-50 int8 path, the decode steps (paged and
static-cache) and the prefill graph emit are registered; any other op
raises UnknownOpError when an Executor is built.
"""

from . import (  # noqa: F401  (registration side effects)
    contrib_ops, fused_ops, math_ops, misc_ops, nn, quant_ops, reduce_ops, tensor_ops)
from .registry import Ctx, lower_node, register, registered_ops, resolve  # noqa: F401

ALL_OPS_LOADED = True
