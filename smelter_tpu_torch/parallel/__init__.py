"""Parallelism: device meshes, the ring between ranks, sequence-sharded
attention."""

from .mesh import Mesh, MeshPlan, ShardedTensor  # noqa: F401
from .ring import Ring  # noqa: F401
from .ring_attention import ring_attention, sequence_sharded_attention  # noqa: F401
