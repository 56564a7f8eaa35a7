"""ReduceMean of an integer tensor against the JAX lowering: `jnp.mean`
returns the f32 mean (ONNX would keep the input's type, and the reference
does not follow that). Float inputs keep their `torch.mean` call, held in
`tests/test_torch_convnext.py`."""

import numpy as np
import pytest

from torch_port_common import _one_op


def _int_x(dtype, shape=(3, 5, 4), seed=0):
    info = np.iinfo(dtype)
    lo, hi = max(info.min, -1000), min(info.max, 1000)
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(dtype)


@pytest.mark.parametrize("axes,keepdims,opset", [
    ([1], 1, 17),        # axes as an attribute
    ([1, 2], 0, 17),
    ([-1], 0, 18),       # axes as an input (opset 18)
    ([0, 2], 1, 18),
    (None, 0, 17),       # every axis
])
@pytest.mark.parametrize("dtype", [np.int8, np.int32, np.int64])
def test_int_reduce_mean_is_the_f32_mean_as_in_jax(dtype, axes, keepdims, opset):
    x = _int_x(dtype)
    attrs, inits = {"keepdims": keepdims}, {}
    if axes is not None and opset >= 18:
        inits["axes"] = np.array(axes, np.int64)
    elif axes is not None:
        attrs["axes"] = axes
    (got,), (want,) = _one_op("ReduceMean", {"x": x}, attrs, inits, opset=opset)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_int32_reduce_mean_example():
    x = np.array([[1, 2], [3, 6]], np.int32)
    (got,), (want,) = _one_op("ReduceMean", {"x": x}, {"axes": [1], "keepdims": 1})
    assert got.tolist() == want.tolist() == [[1.5], [4.5]]
