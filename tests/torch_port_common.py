"""Shared helpers of the tests that hold smelter_tpu_torch against smelter_tpu.

The same ONNX bytes, exported by the JAX package from its ResNet-50 builder
at a small size, go to both packages; inputs come from a numpy seed.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import torch

import smelter_tpu as st
import smelter_tpu_torch as stt
from smelter_tpu.ir.build import GraphBuilder as JGraphBuilder
from smelter_tpu.models import resnet50 as jax_resnet50
from smelter_tpu.runtime.executor import Executor as JExecutor
from smelter_tpu_torch.ir.build import GraphBuilder
from smelter_tpu_torch.runtime.executor import Executor
from smelter_tpu_torch.utils import dtypes as dt

# ResNet-50 at test size: one bottleneck per stage, width 16, 16 classes.
SMALL = dict(batch=2, image_size=32, layers=(1, 1, 1, 1), width=16,
             num_classes=16)


@functools.lru_cache(maxsize=None)
def small_resnet_bytes(**overrides) -> tuple[bytes, tuple[int, ...]]:
    """ONNX bytes of the small ResNet-50 (JAX package's exporter) and its
    input shape."""
    g, _m, shape = jax_resnet50.build(**{**SMALL, **overrides})
    return st.export_model(g), shape


def image(shape, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _same_value(a, b) -> bool:
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and torch.equal(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return (a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same_value(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def _vi(values) -> list:
    return [(v.name, None if v.type is None else (v.type.dtype, tuple(v.type.shape)))
            for v in values]


def value_types(g) -> dict:
    return {k: (t.dtype, tuple(t.shape)) for k, t in g.value_types.items()}


def assert_graphs_equal(gj, gt, folded_rtol: float = 0.0) -> None:
    """Node for node (op_type, inputs, outputs, attrs, name, domain), the
    same inputs/outputs/types, and bit-equal initializers of one dtype.
    With `folded_rtol`, float initializers may differ by that share of their
    largest magnitude: constants that `fold_constants` computed, each
    package with its own lowerings (XLA's and PyTorch's CPU products round
    differently in the last bit)."""
    assert gj.opset == gt.opset
    assert _vi(gj.inputs) == _vi(gt.inputs)
    assert _vi(gj.outputs) == _vi(gt.outputs)
    assert len(gj.nodes) == len(gt.nodes)
    for nj, nt in zip(gj.nodes, gt.nodes):
        assert (nj.op_type, nj.inputs, nj.outputs, nj.name, nj.domain) == \
            (nt.op_type, nt.inputs, nt.outputs, nt.name, nt.domain)
        assert set(nj.attrs) == set(nt.attrs), nj.name
        for k in nj.attrs:
            assert _same_value(nj.attrs[k], nt.attrs[k]), (nj.name, k)
    assert list(gj.initializers) == list(gt.initializers)
    for name, arr in gj.initializers.items():
        a, b = np.asarray(arr), np.asarray(gt.initializers[name])
        if folded_rtol and a.dtype == b.dtype and a.shape == b.shape and a.dtype.kind == "f":
            assert np.abs(a - b).max(initial=0) <= folded_rtol * np.abs(a).max(initial=0), name
            continue
        assert _same_value(a, b), name
    assert gj.metadata == gt.metadata


def _one_op(op_type, inputs: dict, attrs: dict, inits: dict = (), n_out=1, opset: int = 17,
            **config):
    """One node through both executors under the same configuration fields:
    graph inputs `inputs`, initializers `inits`. Returns (port outputs, JAX
    outputs) as f32 or integer numpy arrays."""
    inits = dict(inits)
    res = []
    for GB, Ex, cfg, conv in ((GraphBuilder, Executor, stt.Config(device="cpu", **config),
                               torch.from_numpy),
                              (JGraphBuilder, JExecutor, st.Config(**config), jnp.asarray)):
        b = GB("op", opset=opset)
        for n, a in inputs.items():
            b.input(n, a.shape, dt.numpy_to_onnx_dtype(a.dtype))
        for n, a in inits.items():
            b.init(a, n)
        names = list(attrs.pop("_order", [])) or list(inputs) + list(inits)
        outs = b.node(op_type, names, outputs=n_out, **attrs)
        g = b.finish([o for o in outs if o] if isinstance(outs, list) else [outs])
        ex = Ex(g, cfg)
        params = ex.init_params()
        if Ex is Executor:
            params = ex.cast_params(params)
        got = ex.build_fn()(params, *[conv(a.copy()) for a in inputs.values()])
        res.append([np.asarray(o.float() if isinstance(o, torch.Tensor)
                               and o.dtype == torch.bfloat16 else o.astype(jnp.float32)
                               if o.dtype == jnp.bfloat16 else o) for o in got])
        attrs = dict(attrs, _order=names)
    return res


def _close(got, want, rel=1e-5):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert np.abs(a.astype(np.float64) - b).max() <= rel * max(np.abs(b).max(), 1e-30)
