"""Op-lowering registry and the op implementations of the port's slice.

Only the ops the ResNet-50 int8 path emits are registered; any other op
raises UnknownOpError when an Executor is built.
"""

from . import fused_ops, math_ops, nn, quant_ops, tensor_ops  # noqa: F401  (registration side effects)
from .registry import Ctx, lower_node, register, registered_ops, resolve  # noqa: F401

ALL_OPS_LOADED = True
