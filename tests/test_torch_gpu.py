"""The port's Hopper kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and skip without one. This file imports no JAX,
so on a machine without JAX run it without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from smelter_tpu_torch.kernels import dequant_matmul as dm
from smelter_tpu_torch.kernels import int8_matmul as im

pytestmark = pytest.mark.gpu

# Ragged edges (M, N, K not multiples of the 128/128/32-or-64 tiles, N not
# a multiple of the vector width) beside the ResNet-50 head shape.
SHAPES = [(1, 8, 16), (37, 100, 70), (130, 257, 1000), (128, 1000, 2048),
          (300, 1001, 99)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(m, n, k, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k), np.float32)).to(device, dtype)
    w = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8)).to(device)
    s = torch.from_numpy(rng.uniform(1e-3, 2e-2, n).astype(np.float32)).to(device)
    return x, w, s


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_dequant_matmul_matches_plain(cuda, shape, dtype):
    m, n, k = shape
    x, w, s = _operands(m, n, k, dtype, cuda)
    before = dm.launches
    got = dm.dequant_matmul(x, w, s)
    torch.cuda.synchronize()
    assert dm.launches == before + 1
    ref = dm.dequant_matmul_plain(x, w, s)
    assert got.dtype == dtype and got.shape == (m, n)
    # bf16/f16: the two sums differ in order, then both round to 8 or 11
    # mantissa bits, so ~1 ulp of the largest output; f32: order only.
    tol = {torch.bfloat16: 1e-2, torch.float16: 2e-3, torch.float32: 1e-5}[dtype]
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


@pytest.mark.parametrize("shape", SHAPES)
def test_int8_matmul_exact(cuda, shape):
    m, n, k = shape
    rng = np.random.default_rng(1)
    xq = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8)).to(cuda)
    wq = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8)).to(cuda)
    sr = torch.from_numpy(rng.uniform(1e-3, 1e-2, (m, 1)).astype(np.float32)).to(cuda)
    sc = torch.from_numpy(rng.uniform(1e-3, 1e-2, n).astype(np.float32)).to(cuda)
    acc = im.int8_matmul(xq, wq, sr, sc, out_dtype=torch.int32)
    assert torch.equal(acc, im.int8_matmul_plain(xq, wq, sr, sc, out_dtype=torch.int32))
    for dt in (torch.float32, torch.bfloat16):
        got = im.int8_matmul(xq, wq, sr, sc, out_dtype=dt)
        assert torch.equal(got, im.int8_matmul_plain(xq, wq, sr, sc, out_dtype=dt))


def test_dequant_matmul_int8_matches_plain(cuda):
    x, w, s = _operands(64, 1000, 2048, torch.bfloat16, cuda)
    before = im.launches
    got = im.dequant_matmul_int8(x, w, s)
    assert im.launches == before + 1
    xq, sr = im.quantize_rows(x)
    assert torch.equal(got, im.int8_matmul_plain(xq, w, sr, s, out_dtype=torch.bfloat16))


def test_wrappers_raise_on_bad_operands(cuda):
    x, w, s = _operands(16, 32, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        dm.dequant_matmul(x.t(), w, s)
    with pytest.raises(TypeError):
        im.int8_matmul(x, w, s[:16].reshape(16, 1), s)
