"""A 0-d initializer keeps its shape () in the port, as in the JAX package.

`weights._host_tensor` turns every initializer into a tensor for
`Executor.init_params` and `compile`; numpy's `ascontiguousarray` returns a
1-d array for a 0-d one, which made a Gather on a 0-d index keep the gathered
axis and a 0-d Add return (1,). Each case runs one graph through both
packages on the CPU and asks for the reference's shape and values.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import smelter_tpu as st
import smelter_tpu_torch as stt
from smelter_tpu.ir.build import GraphBuilder as JGraphBuilder
from smelter_tpu_torch import weights
from smelter_tpu_torch.utils import dtypes as dt
from torch_port_common import _one_op


def _x(shape, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _gather():
    return _one_op("Gather", {"x": _x((2, 3, 5, 7))}, {"axis": 1},
                   inits={"i": np.array(2, np.int64)})


def _add():
    return _one_op("Add", {"a": np.array(1.25, np.float32)}, {},
                   inits={"b": np.array(-3.5, np.float32)})


def _constant_gather_relu():
    """Constant (0-d int64) -> Gather (axis 1) -> Relu, exported by the JAX
    package and compiled by both."""
    b = JGraphBuilder("const_gather", opset=17)
    b.input("x", (2, 3, 5), dt.FLOAT)
    c = b.node("Constant", [], value=np.array(1, np.int64))
    y = b.node("Relu", [b.node("Gather", ["x", c], axis=1)])
    data = st.export_model(b.finish([y]))
    x = _x((2, 3, 5), 1)
    got = stt.compile(stt.import_model(data), device="cpu")(x)
    want = st.compile(st.import_model(data))(x)
    return ([np.asarray(o) for o in got], [np.asarray(o, np.float32) for o in want])


CASES = {"gather": (_gather, (2, 5, 7)), "add": (_add, ()),
         "constant_gather_relu": (_constant_gather_relu, (2, 5))}


@pytest.mark.parametrize("case", list(CASES))
def test_zero_d_matches_jax(case):
    """The port's output has the reference's shape and values."""
    run, shape = CASES[case]
    (got,), (want,) = run()
    assert want.shape == shape
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arr", [np.array(3, np.int64), np.array(2.5, np.float32),
                                 np.zeros((0,), np.float32), np.arange(6.0).reshape(2, 3).T])
def test_host_tensor_keeps_shape(arr):
    """Any rank, read-only or strided, comes back with its shape and values."""
    arr.flags.writeable = False
    t = weights._host_tensor(arr)
    assert tuple(t.shape) == arr.shape and t.is_contiguous()
    np.testing.assert_array_equal(t.numpy(), arr)
    assert torch.from_numpy(np.asarray(arr).copy()).dtype == t.dtype
