"""Shared helpers of the tests that hold smelter_tpu_torch against smelter_tpu.

The same ONNX bytes, exported by the JAX package from its ResNet-50 builder
at a small size, go to both packages; inputs come from a numpy seed.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

import smelter_tpu as st
from smelter_tpu.models import resnet50 as jax_resnet50

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


def assert_graphs_equal(gj, gt) -> None:
    """Node for node (op_type, inputs, outputs, attrs, name, domain), the
    same inputs/outputs/types, and bit-equal initializers of one dtype."""
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
        assert _same_value(np.asarray(arr), np.asarray(gt.initializers[name])), name
    assert gj.metadata == gt.metadata
