"""The plain versions of the port's last single-card kernels against the JAX
package's Pallas kernels in interpret mode, on the CPU.

`dequant_matmul_int8_fused` and `dequant_matmul_int8_fused2` quantize each
row of x in the kernel, then run the int8 GEMM: the port's plain version,
`quantize_rows` then `int8_matmul_plain`, is bit-equal to both. Their JAX
entries have no test in the JAX package; (64, 256, 128) with 32 x 128 x 128
blocks runs `fused`'s manual-DMA panel kernel, (48, 384, 200) its two-pass
fall-back and `fused2`'s padding. `pixel_conv_blockdot` (NHCW) and
`pixel_conv_patch` (flat NCHW) compute `pixel_conv_rowdot`'s function at
`tests/test_pixel_conv.py`'s shapes: f32 within 1e-5 of the largest output
(sums in other orders), bf16 within 1e-2 (f32 sums of the same bf16
products, each rounded once).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smelter_tpu.kernels import int8_matmul as jim
from smelter_tpu.kernels import pixel_conv as jpc
from smelter_tpu_torch.kernels import int8_matmul as im
from smelter_tpu_torch.kernels import pixel_conv as pc

# (M, K, N) and the Pallas blocks: the panel kernel's aligned case, then
# the unaligned one.
GEMMS = [((64, 256, 128), dict(block_m=32, block_n=128, block_k=128)),
         ((48, 384, 200), dict(block_m=32, block_n=128, block_k=128))]


def _gemm_operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[3] = 0.0  # an all-zero row takes the 1e-30 floor
    w = rng.integers(-127, 128, (k, n), dtype=np.int8)
    s = rng.uniform(1e-3, 2e-2, n).astype(np.float32)
    return x, w, s


@pytest.mark.parametrize("gemm", GEMMS, ids=["panel", "unaligned"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("out_dtype", [None, "float32"])
def test_dequant_matmul_int8_fused_plain_matches_pallas(gemm, dtype, out_dtype):
    (m, k, n), blocks = gemm
    x, w, s = _gemm_operands(m, k, n)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    tod = None if out_dtype is None else getattr(torch, out_dtype)
    got = im.dequant_matmul_int8_fused_plain(xt, torch.from_numpy(w), torch.from_numpy(s),
                                             out_dtype=tod)
    assert got.dtype == (tod or xt.dtype) and got.shape == (m, n)
    # the wrappers take the plain version on the CPU
    for fn in (im.dequant_matmul_int8_fused, im.dequant_matmul_int8_fused2):
        assert torch.equal(fn(xt, torch.from_numpy(w), torch.from_numpy(s), out_dtype=tod), got)
    assert im.fused_launches == 0 and im.fused2_launches == 0
    jod = None if out_dtype is None else getattr(jnp, out_dtype)
    args = (jnp.asarray(x).astype(dtype), jnp.asarray(w), jnp.asarray(s))
    for fn in (jim.dequant_matmul_int8_fused, jim.dequant_matmul_int8_fused2):
        want = fn(*args, out_dtype=jod, interpret=True, **blocks)
        assert want.dtype == getattr(jnp, out_dtype or dtype)
        assert np.array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def _pixel_operands(b, h, cin, w, cout, seed=0):
    """tests/test_pixel_conv.py's operands, NHCW."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, cin, w)).astype(np.float32)
    wt = (rng.standard_normal((cout, cin, 3, 3)) / (3 * np.sqrt(cin))).astype(np.float32)
    bias = rng.standard_normal((cout,)).astype(np.float32)
    return x, wt, bias


def _nchw_flat(x):
    """NHCW -> flat NCHW (B, C, H*W)."""
    b, h, c, w = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3)).reshape(b, c, h * w)


def _held(got, want, dtype):
    tol = {"float32": 1e-5, "bfloat16": 1e-2}[dtype]
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    assert np.abs(got.float().numpy() - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("geom", [(2, 16, 16, 128, 8), (2, 16, 32, 128, 16)])
@pytest.mark.parametrize("dtype,alpha", [("float32", None), ("float32", 0.2),
                                         ("bfloat16", 0.2)])
def test_pixel_conv_blockdot_plain_matches_pallas(geom, dtype, alpha):
    x, wt, bias = _pixel_operands(*geom)
    tdt = getattr(torch, dtype)
    got = pc.pixel_conv_blockdot(torch.from_numpy(x).to(tdt), torch.from_numpy(wt),
                                 torch.from_numpy(bias), alpha=alpha)
    assert pc.blockdot_launches == 0 and got.dtype == tdt
    want = jpc.pixel_conv_blockdot(jnp.asarray(x).astype(dtype), jnp.asarray(wt),
                                   jnp.asarray(bias), alpha=alpha, rows=8, interpret=True)
    _held(got, want, dtype)


@pytest.mark.parametrize("geom", [(2, 16, 16, 128, 8), (2, 16, 32, 128, 16)])
@pytest.mark.parametrize("dtype,alpha", [("float32", None), ("float32", 0.2),
                                         ("bfloat16", 0.2)])
def test_pixel_conv_patch_plain_matches_pallas(geom, dtype, alpha):
    x, wt, bias = _pixel_operands(*geom)
    width = geom[3]
    xf = _nchw_flat(x)
    tdt = getattr(torch, dtype)
    got = pc.pixel_conv_patch(torch.from_numpy(xf).to(tdt), torch.from_numpy(wt),
                              torch.from_numpy(bias), width=width, alpha=alpha)
    assert pc.patch_launches == 0 and got.dtype == tdt
    want = jpc.pixel_conv_patch(jnp.asarray(xf).astype(dtype), jnp.asarray(wt),
                                jnp.asarray(bias), width=width, alpha=alpha, rows=8,
                                interpret=True)
    _held(got, want, dtype)


@pytest.mark.parametrize("alpha", [None, 0.2])
def test_pixel_conv_variants_take_any_height(alpha):
    """H 12 under rows=8: the Pallas entries assert H % rows == 0; the port
    takes it, against the JAX package's XLA reference."""
    x, wt, bias = _pixel_operands(2, 12, 16, 128, 8, seed=2)
    want = jpc.pixel_conv_reference(jnp.asarray(x.transpose(0, 2, 1, 3)), jnp.asarray(wt),
                                    jnp.asarray(bias), alpha=alpha)
    want = np.asarray(want)  # (B, C_out, H, W)
    tol = 1e-5 * np.abs(want).max()
    args = (torch.from_numpy(wt), torch.from_numpy(bias))
    got = pc.pixel_conv_blockdot(torch.from_numpy(x), *args, alpha=alpha, rows=8)
    assert np.abs(got.numpy().transpose(0, 2, 1, 3) - want).max() <= tol
    got = pc.pixel_conv_patch(torch.from_numpy(_nchw_flat(x)), *args, width=128, alpha=alpha,
                              rows=8)
    assert np.abs(got.numpy() - want.reshape(2, 8, -1)).max() <= tol


def test_variants_on_meta_and_other_devices():
    """`meta` tensors take the plain versions (shapes, types, no launch); a
    device that is neither the CPU nor CUDA raises."""
    x = torch.empty(2, 16, 32, 128, device="meta", dtype=torch.bfloat16)
    w = torch.empty(64, 32, 3, 3, device="meta")
    v = torch.empty(64, device="meta")
    out = pc.pixel_conv_blockdot(x, w, v, alpha=0.2)
    assert out.shape == (2, 16, 64, 128) and out.dtype == torch.bfloat16
    xf = torch.empty(2, 32, 16 * 128, device="meta", dtype=torch.bfloat16)
    out = pc.pixel_conv_patch(xf, w, v, width=128)
    assert out.shape == (2, 64, 16 * 128) and out.dtype == torch.bfloat16
    xm = torch.empty(5, 64, device="meta", dtype=torch.bfloat16)
    wq = torch.empty(64, 10, device="meta", dtype=torch.int8)
    s = torch.empty(10, device="meta")
    for fn in (im.dequant_matmul_int8_fused, im.dequant_matmul_int8_fused2):
        out = fn(xm, wq, s, out_dtype=torch.float32)
        assert out.shape == (5, 10) and out.dtype == torch.float32
    assert (pc.blockdot_launches, pc.patch_launches, im.fused_launches,
            im.fused2_launches) == (0, 0, 0, 0)

    def elsewhere(shape):
        return types.SimpleNamespace(device=torch.device("xpu"), shape=shape,
                                     dtype=torch.bfloat16, dim=lambda: len(shape))

    with pytest.raises(ValueError, match="no kernel"):
        pc.pixel_conv_blockdot(elsewhere((2, 16, 32, 128)), w, v)
    with pytest.raises(ValueError, match="no kernel"):
        pc.pixel_conv_patch(elsewhere((2, 32, 2048)), w, v, width=128)
    for fn in (im.dequant_matmul_int8_fused, im.dequant_matmul_int8_fused2):
        with pytest.raises(ValueError, match="no kernel"):
            fn(elsewhere((5, 64)), wq, s)


def test_patch_refuses_a_map_that_is_not_whole_rows():
    x = torch.zeros(1, 4, 100)
    with pytest.raises(ValueError, match="rows of 7"):
        pc.pixel_conv_patch(x, torch.zeros(4, 4, 3, 3), torch.zeros(4), width=7)


def test_fused_panel_rows_follow_k():
    """The fused form by K at the serving GEMM's M and N: a resident panel
    of 128 rows on 4 ranks to K 4,096, on 8 to 9,216, the revisit form
    (`_fused2`'s TMA-fed wgmma kernel) past it. No K raises (the mma.sync
    panel kernel raised past 5,952)."""
    ks = (1024, 4096, 5952, 5960, 9216, 9344)
    forms = [im.wgmma_plan.fused_plan(8192, 4096, k, 2) for k in ks]
    assert [(p.form, p.split if p.form == "panel" else 0) for p in forms] == [
        ("panel", 4), ("panel", 4), ("panel", 8), ("panel", 8), ("panel", 8), ("revisit", 0)]
    assert all(p.k_chunk * p.split >= k for p, k in zip(forms, ks))
