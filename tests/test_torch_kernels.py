"""The plain versions of the port's kernels against the JAX package's.

On the CPU the port's wrappers take their plain versions; the JAX side runs
its Pallas kernels in interpret mode (as its own tests do) and its XLA
references. Shapes include ragged edges: M, N and K not multiples of the
tiles of either implementation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smelter_tpu.kernels import dequant_matmul as jdm
from smelter_tpu.kernels import int8_matmul as jim
from smelter_tpu_torch.kernels import dequant_matmul as dm
from smelter_tpu_torch.kernels import int8_matmul as im

SHAPES = [(2, 16, 64), (37, 100, 70), (130, 257, 300), (8, 1000, 2048)]


def _operands(m, n, k, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.integers(-127, 128, (k, n), dtype=np.int8)
    s = rng.uniform(1e-3, 2e-2, n).astype(np.float32)
    return x, w, s


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequant_matmul_plain_matches_jax(shape, dtype):
    m, n, k = shape
    x, w, s = _operands(m, n, k)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = dm.dequant_matmul(xt, torch.from_numpy(w), torch.from_numpy(s))
    assert dm.launches == 0  # CPU tensors never reach the kernel
    assert got.dtype == xt.dtype and got.shape == (m, n)
    got = got.float().numpy()
    xj = jnp.asarray(x).astype(dtype)
    # f32: both sum in f32 in other orders -> 1e-5 of the largest output.
    # bf16: the outputs round to 8 mantissa bits after sums in other orders
    # (the reference rounds W*s to bf16 first) -> 1e-2 of the largest.
    tol = {"float32": 1e-5, "bfloat16": 1e-2}[dtype]
    for ref in (jdm.dequant_matmul(xj, jnp.asarray(w), jnp.asarray(s), interpret=True),
                jdm.dequant_matmul_reference(xj, jnp.asarray(w), jnp.asarray(s))):
        ref = np.asarray(ref.astype(jnp.float32))
        assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_bit_equal(dtype):
    x, _, _ = _operands(33, 1, 300, seed=1)
    x[3] = 0.0  # an all-zero row takes the 1e-30 floor
    x[5, :4] = [0.5, -1.5, 2.5, 127.0]  # half-way values round to even
    q, s = im.quantize_rows(torch.from_numpy(x).to(getattr(torch, dtype)))
    qj, sj = jim.quantize_rows(jnp.asarray(x).astype(dtype))
    assert np.array_equal(q.numpy(), np.asarray(qj))
    assert s.numpy().tobytes() == np.asarray(sj).tobytes()


@pytest.mark.parametrize("shape", SHAPES)
def test_int8_matmul_plain_matches_jax(shape):
    m, n, k = shape
    x, w, s = _operands(m, n, k, seed=2)
    xq, sr = im.quantize_rows(torch.from_numpy(x))
    wt, st_ = torch.from_numpy(w), torch.from_numpy(s)
    acc = im.int8_matmul(xq, wt, sr, st_, out_dtype=torch.int32)
    acc_j = np.matmul(xq.numpy().astype(np.int64), w.astype(np.int64))
    assert acc.dtype == torch.int32 and np.array_equal(acc.numpy(), acc_j)
    got = im.int8_matmul(xq, wt, sr, st_, out_dtype=torch.float32).numpy()
    args = (jnp.asarray(xq.numpy()), jnp.asarray(w), jnp.asarray(sr.numpy()), jnp.asarray(s))
    ref_kernel = np.asarray(jim.int8_matmul(*args, out_dtype=jnp.float32, interpret=True))
    ref_plain = np.asarray(jim.int8_matmul_reference(*args, out_dtype=jnp.float32))
    # exact integer sums and the same two f32 multiplies: equal outputs
    assert np.array_equal(got, ref_kernel) and np.array_equal(got, ref_plain)
    assert im.launches == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequant_matmul_int8_matches_jax(dtype):
    x, w, s = _operands(19, 130, 257, seed=4)
    got = im.dequant_matmul_int8(torch.from_numpy(x).to(getattr(torch, dtype)),
                                 torch.from_numpy(w), torch.from_numpy(s))
    xj = jnp.asarray(x).astype(dtype)
    for ref in (jim.dequant_matmul_int8(xj, jnp.asarray(w), jnp.asarray(s), interpret=True),
                jim.dequant_matmul_int8_xla(xj, jnp.asarray(w), jnp.asarray(s))):
        assert np.array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_meta_tensors_take_the_plain_version():
    x = torch.empty(5, 64, device="meta", dtype=torch.bfloat16)
    w = torch.empty(64, 10, device="meta", dtype=torch.int8)
    s = torch.empty(10, device="meta")
    assert dm.dequant_matmul(x, w, s).shape == (5, 10)
    assert im.dequant_matmul_int8(x, w, s).shape == (5, 10)
    assert dm.launches == 0 and im.launches == 0
