"""smelter_tpu_torch: the PyTorch/CUDA port of smelter_tpu.

Importer -> typed IR -> graph-rewrite passes -> weight-only quantization ->
an executor over torch tensors, with hand-written Hopper kernels (CUDA C++
under csrc/) for the hot ops -> continuous-batching serving, on one NVIDIA
H100. It imports neither JAX nor the JAX package; models run on the card
unless `device="cpu"` is passed.
"""

__version__ = "0.1.0"

from .ir.graph import Graph, Node, TensorType, ValueInfo  # noqa: F401
from .ir.importer import import_model, load_model, export_model, save_model  # noqa: F401
from .ir.build import GraphBuilder  # noqa: F401
from .runtime.config import Config  # noqa: F401
from .runtime.executor import CompiledModel, Executor  # noqa: F401
from .api import compile, serve  # noqa: F401,A001
from .weights import params_from_numpy  # noqa: F401
from .parallel import MeshPlan  # noqa: F401
