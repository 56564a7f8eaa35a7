"""Graph executor: IR -> a function over torch tensors -> CompiledModel.

The port's counterpart of `smelter_tpu/runtime/executor.py`. The node list
is walked once per call, each lowering computing on the tensors it is
given; PyTorch runs eagerly, so there is no trace and no compile step.
Weights are a dict of tensors resident on the device, inputs positional.

Shape inference falls out of the same walk on the `meta` device, which
stands in for `jax.eval_shape`: the lowerings are the shape oracle, and
every kernel wrapper takes its plain version for `meta` tensors.

The forward function walks the plan of `runtime/chains.py`: runs of nodes
that XLA would fuse under the JAX package's jit (an int8-static network's
conv + Relu and residual joins) as one call each. A walk that returns every
edge walks node by node unless asked to fuse.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..ir.errors import ShapeError, UnresolvedDimError
from ..ir.graph import Graph, Node, TensorType
from ..ops import ALL_OPS_LOADED  # noqa: F401  (forces op registration)
from ..ops.registry import Ctx, lower_node
from ..utils import dtypes as dt
from . import chains
from .config import Config

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                   "float16": torch.float16}

# Inputs that must keep full precision under a reduced compute dtype:
# quantization scales (rounding them to bf16 would corrupt dequantization).
_SCALE_POS = {
    "DequantizeLinear": (1, 2),
    "FusedDequantMatMul": (2,),
    "FusedDequantMatMulI4": (2,),
    # scales (2) and bias (3) feed the kernel's f32 epilogue
    "PixelConvQ": (2, 3),
}


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device a model runs on: "cuda" unless the caller asked for
    another. Without a card, the default raises instead of falling back."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available; pass device='cpu' to run on the CPU")
    return dev


def split_params(graph: Graph) -> tuple[list[str], list[str]]:
    """Partition initializer names into (runtime params, static-only).

    The static input positions are declared at each lowering's
    @register(..., static={...}) site (ops/registry.py): an initializer
    used *only* in such positions is read on the host and never becomes a
    device param."""
    from ..ops.registry import static_positions

    dynamic: set[str] = set()
    static_only_candidates: set[str] = set(graph.initializers)
    for node in graph.nodes:
        static_pos = static_positions(node.op_type, graph.opset)
        for i, name in enumerate(node.inputs):
            if name in graph.initializers and i not in static_pos:
                dynamic.add(name)
    for name in graph.output_names:
        if name in graph.initializers:
            dynamic.add(name)
    params = sorted(dynamic)
    static_only = sorted(static_only_candidates - dynamic)
    return params, static_only


class Executor:
    """Builds and owns the forward function for one graph."""

    def __init__(self, graph: Graph, config: Config | None = None):
        self.graph = graph
        self.config = config or Config()
        self.input_types = self._resolve_input_types()
        self.param_names, self.static_names = split_params(graph)
        # Fail at build time for unknown ops, as the JAX executor does.
        from ..ops.registry import resolve

        for node in graph.nodes:
            resolve(node.op_type, graph.opset)

    @property
    def device(self) -> torch.device:
        return resolve_device(self.config.device)

    # -- shapes ----------------------------------------------------------

    def _resolve_input_types(self) -> dict[str, TensorType]:
        out: dict[str, TensorType] = {}
        for vi in self.graph.inputs:
            if vi.type is None:
                raise ShapeError(f"graph input {vi.name!r} has no declared type")
            dims = []
            for axis, d in enumerate(vi.type.shape):
                r = self.config.resolve_dim(vi.name, axis, d)
                if r is None:
                    raise UnresolvedDimError(vi.name, axis, str(d))
                dims.append(r)
            out[vi.name] = TensorType(vi.type.dtype, tuple(dims))
        return out

    def _compute_dtype(self, t: TensorType) -> torch.dtype:
        tdt = dt.onnx_to_torch_dtype(t.dtype)
        if tdt.is_floating_point:
            return _COMPUTE_DTYPES[self.config.compute_dtype]
        return tdt

    def param_shapes(self) -> dict[str, torch.Tensor]:
        """The params as `meta` tensors: shapes and dtypes, no data."""
        out = {}
        for name in self.param_names:
            arr = self.graph.initializers[name]
            tdt = arr.dtype if isinstance(arr, torch.Tensor) \
                else torch.from_numpy(np.zeros(0, arr.dtype)).dtype
            out[name] = torch.empty(tuple(arr.shape), dtype=tdt, device="meta")
        return out

    def input_shapes(self) -> list[torch.Tensor]:
        return [torch.empty(t.shape, dtype=self._compute_dtype(t), device="meta")
                for t in (self.input_types[v.name] for v in self.graph.inputs)]

    # -- params ----------------------------------------------------------

    def init_params(self) -> dict[str, torch.Tensor]:
        """The params on the executor's device, in their stored dtype."""
        from ..weights import params_from_numpy

        return params_from_numpy(
            {name: self.graph.initializers[name] for name in self.param_names},
            self.device, graph=self.graph)

    def precision_critical(self) -> set[str]:
        """Params that keep f32 under a reduced compute dtype."""
        keep: set[str] = set()
        for node in self.graph.nodes:
            if node.op_type.startswith("Q"):
                keep.update(n for n in node.inputs if n)
                continue
            for pos in _SCALE_POS.get(node.op_type, ()):
                if pos < len(node.inputs):
                    keep.add(node.inputs[pos])
        return keep

    def cast_params(self, params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Params as the forward function uses them: f32 params other than
        scales in the compute dtype, so activations stay in it end to end.
        Done once, not per call."""
        cd = _COMPUTE_DTYPES[self.config.compute_dtype]
        if cd == torch.float32:
            return dict(params)
        keep = self.precision_critical()
        return {name: v.to(cd) if v.dtype == torch.float32 and name not in keep
                else v for name, v in params.items()}

    # -- the forward function -------------------------------------------

    def build_fn(self, return_all_edges: bool = False,
                 device: str | torch.device | None = None,
                 donate: tuple[str, ...] | frozenset[str] = (),
                 fuse: bool | None = None) -> Callable:
        """fn(params, *inputs) -> outputs, computing on `device` (default:
        the executor's). `params` come as `cast_params` gives them.

        `fuse` (default: not `return_all_edges`) walks the plan of
        `runtime/chains.py`, whose groups make no inner edges; without it
        the walk is node by node and every edge is made (calibration reads
        them all).

        `donate` names inputs the caller gives away, as JAX's buffer
        donation does: lowerings may update them in place (ScatterND's cache
        writes), and an output may then be the input's own tensor. A donated
        input must arrive as a tensor on `device` in the dtype the walk
        computes it in, so that it is not copied on the way in."""
        graph, config = self.graph, self.config
        dev = torch.device(device) if device is not None else self.device
        input_names = graph.input_names
        output_names = graph.output_names
        cd = _COMPUTE_DTYPES[config.compute_dtype]
        param_names = self.param_names
        donated = frozenset(donate)
        unknown = donated - set(input_names)
        if unknown:
            raise ValueError(f"donated names {sorted(unknown)} are not graph inputs")
        memo: dict = {}  # the lowerings' folded constants, kept across calls
        if fuse is None:
            fuse = not return_all_edges
        steps = chains.plan(graph) if fuse else list(graph.nodes)

        def fn(params: dict[str, Any], *inputs):
            if len(inputs) != len(input_names):
                raise TypeError(
                    f"model expects {len(input_names)} input(s) "
                    f"{input_names}, got {len(inputs)}")
            with torch.inference_mode():
                env: dict[str, Any] = {name: params[name] for name in param_names}
                for name, given in zip(input_names, inputs):
                    x = torch.as_tensor(given, device=dev)
                    if x.dtype.is_floating_point and x.dtype != cd:
                        x = x.to(cd)
                    if name in donated and x is not given:
                        raise TypeError(
                            f"donated input {name!r} must be a tensor on {dev} in "
                            f"{cd if x.dtype.is_floating_point else x.dtype}")
                    env[name] = x
                ctx = Ctx(graph, env, config, device=dev, donated=donated, memo=memo)
                for step in steps:
                    if isinstance(step, Node):
                        lower_node(ctx, step)
                    else:
                        step.run(ctx)
                if return_all_edges:
                    return dict(env)
                return tuple(env[o] for o in output_names)

        return fn

    def infer_value_types(self) -> dict[str, TensorType]:
        """Populate graph.value_types for every edge by running the walk on
        the `meta` device."""
        fn = self.build_fn(return_all_edges=True, device="meta")
        out = fn(self.cast_params(self.param_shapes()), *self.input_shapes())
        types = {}
        for name, s in out.items():
            if not isinstance(s, torch.Tensor):
                continue
            try:
                code = dt.torch_to_onnx_dtype(s.dtype)
            except ValueError:
                continue
            types[name] = TensorType(code, tuple(int(d) for d in s.shape))
        self.graph.value_types.update(types)
        return types


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy of an output; bf16 (which numpy cannot hold) as f32."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class CompiledModel:
    """User-facing handle: params resident on the device + the forward
    function. `params` (for example from `weights.params_from_numpy`)
    replaces the graph's own initializers."""

    def __init__(self, graph: Graph, config: Config | None = None,
                 params: dict[str, torch.Tensor] | None = None):
        self.executor = Executor(graph, config)
        self.params = self.executor.init_params() if params is None else params
        self._run_params = self.executor.cast_params(self.params)
        self._fn = self.executor.build_fn()

    @property
    def graph(self) -> Graph:
        return self.executor.graph

    @property
    def device(self) -> torch.device:
        return self.executor.device

    def __call__(self, *inputs) -> list[np.ndarray]:
        return [to_numpy(o) for o in self.run_device(*inputs)]

    def run_device(self, *inputs) -> tuple[torch.Tensor, ...]:
        """Run without host readback (outputs stay on the device)."""
        return self._fn(self._run_params, *inputs)
