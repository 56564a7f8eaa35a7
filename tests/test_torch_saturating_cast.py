"""Cast and CastLike from a float into a narrower int, against the JAX
lowering: XLA's convert clamps to the type's range and maps NaN to 0
(`smelter_tpu/ops/tensor_ops.py`'s `astype`), and the port's
`saturating_cast` does the same on every device. One node through both
executors, in f32 and f16, on values past every bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smelter_tpu_torch as stt
from smelter_tpu.ir.build import GraphBuilder as JGraphBuilder
from smelter_tpu.runtime.executor import Executor as JExecutor
from smelter_tpu_torch.ir.build import GraphBuilder
from smelter_tpu_torch.runtime.executor import Executor
from smelter_tpu_torch.utils import dtypes as dt

VALUES = [1e3, -1e3, 300.0, 3e9, -3e9, np.nan, np.inf, -np.inf, 126.9, -128.7, -0.5, 0.0]
INTS = [np.int8, np.uint8, np.int16, np.int32]


def _values(src):
    with np.errstate(over="ignore"):  # +-3e9 is inf in f16
        return np.asarray(VALUES, np.float32).astype(src)


def _run(op_type, inputs: dict, attrs: dict, via=None):
    """One node through the port's executor (CPU) and the JAX one; returns
    both outputs as numpy. With `via`, the first input is Cast to that ONNX
    type first (a bf16 source, which numpy inputs cannot carry)."""
    outs = []
    for GB, Ex, conv in ((GraphBuilder, Executor, torch.from_numpy),
                         (JGraphBuilder, JExecutor, jnp.asarray)):
        b = GB("op", opset=17)
        for n, a in inputs.items():
            b.input(n, a.shape, dt.numpy_to_onnx_dtype(a.dtype))
        names = list(inputs)
        if via is not None:
            names[0] = b.node("Cast", [names[0]], to=via)
        g = b.finish([b.node(op_type, names, **attrs)])
        ex = Ex(g, stt.Config(device="cpu")) if Ex is Executor else Ex(g)
        params = ex.init_params()
        got = ex.build_fn()(params if Ex is JExecutor else ex.cast_params(params),
                            *[conv(a.copy()) for a in inputs.values()])
        outs.append(np.asarray(got[0]))
    return outs


@pytest.mark.parametrize("src", [np.float32, np.float16])
@pytest.mark.parametrize("to", INTS)
def test_cast_saturates_as_jax(src, to):
    x = _values(src)
    got, want = _run("Cast", {"x": x}, {"to": dt.numpy_to_onnx_dtype(to)})
    assert got.dtype == want.dtype == to
    assert np.array_equal(got, want), (got, want)


@pytest.mark.parametrize("src", [np.float32, np.float16])
@pytest.mark.parametrize("to", INTS)
def test_cast_like_saturates_as_jax(src, to):
    x = _values(src)
    got, want = _run("CastLike", {"x": x, "like": np.zeros(3, to)}, {})
    assert got.dtype == want.dtype == to
    assert np.array_equal(got, want), (got, want)


def test_saturating_cast_bounds_and_other_casts():
    x = torch.tensor(VALUES, dtype=torch.float32)
    assert dt.saturating_cast(x, torch.int8).tolist() == [
        127, -128, 127, 127, -128, 0, 127, -128, 126, -128, 0, 0]
    assert dt.saturating_cast(x, torch.int32)[[3, 4, 6, 7]].tolist() == [
        2**31 - 1, -2**31, 2**31 - 1, -2**31]
    assert dt.saturating_cast(x, torch.uint8)[[0, 1, 2]].tolist() == [255, 0, 255]
    # bf16 takes the same path as f32 (every VALUE above is near a bf16 one)
    assert torch.equal(dt.saturating_cast(x.bfloat16(), torch.int16),
                       dt.saturating_cast(x.bfloat16().float(), torch.int16))
    # an int into a narrower int keeps its low bits; float targets are plain
    assert dt.saturating_cast(torch.tensor([300], dtype=torch.int32), torch.int8).item() == 44
    assert torch.allclose(dt.saturating_cast(x, torch.float16), x.to(torch.float16),
                          rtol=0, atol=0, equal_nan=True)
    assert dt.saturating_cast(torch.empty(2, device="meta"), torch.int8).device.type == "meta"


# Past int64's bounds and near them: 2^63 and -2^63 are exact in every
# float type; 2^63 - 2^39 is the f32 just below 2^63 (bf16 rounds it up to
# 2^63, f16 takes everything past 65504 to inf).
VALUES_64 = VALUES + [1e30, -1e30, 2.0**63, -2.0**63, 2.0**63 - 2.0**39,
                      -(2.0**63 - 2.0**39), 3e10, -1.5, 2.0**62]
SOURCES_64 = {"f32": (np.float32, None), "f16": (np.float16, None),
              "bf16": (np.float32, dt.BFLOAT16)}


def _values_64(src):
    with np.errstate(over="ignore"):
        return np.asarray(VALUES_64, np.float32).astype(src)


@pytest.mark.parametrize("src", list(SOURCES_64))
@pytest.mark.parametrize("op_type", ["Cast", "CastLike"])
def test_cast_to_int64_saturates_as_jax_x64(src, op_type):
    """Into int64, as XLA's convert under x64: NaN 0, at or past 2^63
    INT64_MAX, below -2^63 INT64_MIN, the rest truncated toward zero."""
    np_src, via = SOURCES_64[src]
    x = _values_64(np_src)
    inputs, attrs = {"x": x}, {"to": dt.INT64}
    if op_type == "CastLike":
        inputs, attrs = {"x": x, "like": np.zeros(3, np.int64)}, {}
    with jax.enable_x64(True):
        got, want = _run(op_type, inputs, attrs, via=via)
    assert got.dtype == want.dtype == np.int64
    assert np.array_equal(got, want), (got, want)
    info = np.iinfo(np.int64)
    assert (got[np.isnan(VALUES_64)] == 0).all()
    assert got[VALUES_64.index(1e30)] == info.max and got[VALUES_64.index(-1e30)] == info.min
    assert got[VALUES_64.index(-2.0**63)] == info.min


def test_saturating_cast_int64_keeps_ints_and_meta():
    x = torch.tensor([-1.5, 3e10, float("nan"), 1e30, -1e30], dtype=torch.float32)
    assert dt.saturating_cast(x, torch.int64).tolist() == [
        -1, 30000001024, 0, 2**63 - 1, -2**63]
    x64 = torch.tensor([-1.5, 3e10, float("nan"), 1e30, -1e30], dtype=torch.float64)
    assert dt.saturating_cast(x64, torch.int64).tolist() == [
        -1, 30000000000, 0, 2**63 - 1, -2**63]
    big = torch.tensor([2**62 + 1], dtype=torch.int64)
    assert dt.saturating_cast(big, torch.int64).item() == 2**62 + 1
    assert dt.saturating_cast(torch.empty(2, device="meta"), torch.int64).dtype == torch.int64
