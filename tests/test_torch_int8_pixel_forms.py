"""Plain-PyTorch emulations of the wgmma forms of `int8_matmul` and of
16-bit `pixel_conv_rowdot`, held to the JAX package's Pallas kernels in
interpret mode (`smelter_tpu/kernels/int8_matmul.py::_int8_matmul_impl`,
`smelter_tpu/kernels/pixel_conv.py::pixel_conv_rowdot`):

- int8: the tma form's walk (128 x 128 tiles, K steps of 128 bytes) and the
  cluster form's K split (128 x 64 tiles, int32 partials of S ranks summed
  in rank order), then float(acc) * s_row * s_col rounded once: int32 sums
  and every output type exact.
- pixel: per K step of 16 channels the producer's copy of the input (zeros
  past the map and past C_in), each tap dx reading it dx pixels on, the 9
  taps summed into f32 accumulators of 4 output rows x 64 pixels, bias,
  LeakyReLU and one rounding: bf16 within 1e-2, f32 within 1e-5 of the
  largest output (sums in another order than the Pallas kernel's dx fold).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from smelter_tpu.kernels import int8_matmul as jim
from smelter_tpu.kernels import pixel_conv as jpc
from smelter_tpu_torch.kernels import int8_matmul as im
from smelter_tpu_torch.kernels import pixel_conv as pc
from smelter_tpu_torch.kernels import wgmma_plan as wp


def _epilogue(acc, sr, sc, out_dtype):
    if out_dtype == torch.int32:
        return acc
    return (acc.float() * sr * sc.reshape(1, -1)).to(out_dtype)


def _i32(a, b):
    """An exact int32 product of int8 blocks (float64 sums are exact here)."""
    return torch.matmul(a.double(), b.double()).to(torch.int32)


def _int8_tma_emulation(xq, wq, sr, sc, out_dtype):
    """gemm_tma_s8's walk: 128 W columns x 128 x rows a tile, the int32
    accumulator summed over K steps of 128 bytes (zeros past K)."""
    M, K = xq.shape
    N = wq.shape[1]
    out = torch.empty(M, N, dtype=out_dtype)
    for m0 in range(0, M, wp.BM):
        for n0 in range(0, N, 128):
            acc = torch.zeros(min(wp.BM, M - m0), min(128, N - n0), dtype=torch.int32)
            for k0 in range(0, K, wp.S8_BK):
                acc += _i32(xq[m0:m0 + wp.BM, k0:k0 + wp.S8_BK], wq[k0:k0 + wp.S8_BK, n0:n0 + 128])
            out[m0:m0 + wp.BM, n0:n0 + 128] = _epilogue(acc, sr[m0:m0 + wp.BM],
                                                        sc[n0:n0 + 128], out_dtype)
    return out


def _int8_cluster_emulation(xq, wq, sr, sc, out_dtype, p: wp.Plan):
    """gemm_cluster_s8's split: each 128 x 64 tile's K range cut into
    `p.split` chunks of `p.k_chunk`, each rank's int32 partial summed over
    steps of 128 bytes, then the partials summed in rank order 0..S-1."""
    M, K = xq.shape
    N = wq.shape[1]
    out = torch.empty(M, N, dtype=out_dtype)
    for m0 in range(0, M, p.bm):
        for n0 in range(0, N, p.bn):
            rows, cols = slice(m0, m0 + p.bm), slice(n0, n0 + p.bn)
            parts = []
            for z in range(p.split):
                part = torch.zeros(min(p.bm, M - m0), min(p.bn, N - n0), dtype=torch.int32)
                k_end = min(K, (z + 1) * p.k_chunk)
                for k0 in range(z * p.k_chunk, k_end, wp.S8_BK):
                    part += _i32(xq[rows, k0:min(k0 + wp.S8_BK, k_end)],
                                 wq[k0:min(k0 + wp.S8_BK, k_end), cols])
                parts.append(part)
            acc = parts[0].clone()
            for part in parts[1:]:
                acc += part
            out[rows, cols] = _epilogue(acc, sr[rows], sc[cols], out_dtype)
    return out


@pytest.mark.parametrize("shape", [(128, 1000, 300), (130, 257, 1000), (17, 16, 100),
                                   (256, 272, 384)])
@pytest.mark.parametrize("form", ["tma", "cluster"])
def test_int8_forms_equal_the_pallas_kernel(shape, form):
    """Exact int32 sums, then the same two f32 multiplies: the emulated forms
    equal `_int8_matmul_impl` in interpret mode in every output type (int32:
    the raw sums, held with unit scales, exact in f32 at these K)."""
    M, N, K = shape
    rng = np.random.default_rng(M + N + K)
    xq = rng.integers(-127, 128, (M, K), dtype=np.int8)
    wq = rng.integers(-127, 128, (K, N), dtype=np.int8)
    sr = rng.uniform(1e-3, 1e-2, (M, 1)).astype(np.float32)
    sc = rng.uniform(1e-3, 1e-2, N).astype(np.float32)
    tx, tw, tsr, tsc = (torch.from_numpy(a) for a in (xq, wq, sr, sc))
    p = wp.int8_plan(M, N, K, sms=wp.SMS)
    if form == "cluster" and p.form != "cluster":
        p = wp.Plan("cluster", wp.BM, wp.CL_BN, 2, wp.cdiv(wp.cdiv(K, wp.S8_BK), 2) * wp.S8_BK,
                    0, 0)

    def emulate(out_dtype, srs=tsr, scs=tsc):
        if form == "tma":
            return _int8_tma_emulation(tx, tw, srs, scs, out_dtype)
        return _int8_cluster_emulation(tx, tw, srs, scs, out_dtype, p)

    args = (jnp.asarray(xq), jnp.asarray(wq))
    ones_r, ones_c = np.ones((M, 1), np.float32), np.ones(N, np.float32)
    acc_j = np.asarray(jim._int8_matmul_impl(*args, jnp.asarray(ones_r), jnp.asarray(ones_c),
                                             out_dtype=jnp.int32, interpret=True))
    acc = emulate(torch.int32)
    assert np.array_equal(acc.numpy(), acc_j)
    assert torch.equal(acc, im.int8_matmul_plain(tx, tw, tsr, tsc, out_dtype=torch.int32))
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
                     (torch.float16, jnp.float16)):
        want = jim._int8_matmul_impl(*args, jnp.asarray(sr), jnp.asarray(sc), out_dtype=jdt,
                                     interpret=True)
        got = emulate(tdt)
        assert np.array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    if form == "cluster":
        assert p.split >= 2 or wp.cdiv(K, wp.S8_BK) == 1


def _pixel_wgmma_emulation(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, alpha):
    """pixel_conv_wgmma's data movement and sums: the weight rounded to x's
    type; per K step of 16 channels (zeros past C_in) the producer's copy of
    the tiles' input rows and pixels w0 - 1 .. (zeros past the map), tap
    (dy, dx) reading rows r + dy from pixel row dx, 9 taps added into f32
    accumulators of the tiles' R rows x 64 pixels; bias, LeakyReLU and one
    rounding to x's type; the store clips the tiles to H and W."""
    B, H, C, W = x.shape
    co = w.shape[0]
    R, PX, CK = wp.PC_R, wp.PC_PX, wp.PC_CK
    Hp, Wp, Cp = wp.cdiv(H, R) * R, wp.cdiv(W, PX) * PX, wp.cdiv(C, CK) * CK
    # the map's zero fill: rows -1 .. Hp, pixels -1 .. Wp, channels to Cp
    xs = F.pad(x.float(), (1, Wp - W + 1, 0, Cp - C, 1, Hp - H + 1))  # (B, Hp + 2, Cp, Wp + 2)
    wk = F.pad(w.to(x.dtype).float(), (0, 0, 0, 0, 0, Cp - C))        # (co, Cp, 3, 3)
    acc = torch.zeros(B, Hp, Wp, co)
    for kt in range(Cp // CK):
        ch = slice(kt * CK, (kt + 1) * CK)
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            box = xs[:, dy:dy + Hp, ch, dx:dx + Wp]  # rows r + dy of the copy, from pixel row dx
            acc += torch.einsum("bhcw,oc->bhwo", box, wk[:, ch, dy, dx])
    y = acc + bias.float()
    if alpha is not None:
        y = torch.where(y >= 0, y, y * float(alpha))
    return y.to(x.dtype)[:, :H, :W].permute(0, 1, 3, 2).contiguous()


@pytest.mark.parametrize("geom", [(1, 8, 24, 64, 32), (2, 8, 16, 72, 64), (1, 8, 48, 128, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("alpha", [None, 0.0, 0.2])
def test_pixel_wgmma_emulation_matches_pallas(geom, dtype, alpha):
    """The emulated form against the Pallas kernel in interpret mode: f32
    within 1e-5 of the largest output, bf16 within 1e-2 (f32 sums of the same
    products in another order, each rounded once)."""
    B, H, C, W, co = geom
    rng = np.random.default_rng(C + W)
    x = rng.standard_normal((B, H, C, W)).astype(np.float32)
    wt = (rng.standard_normal((co, C, 3, 3)) / (3 * np.sqrt(C))).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = _pixel_wgmma_emulation(torch.from_numpy(x).to(tdt), torch.from_numpy(wt),
                                 torch.from_numpy(bias), alpha)
    want = jpc.pixel_conv_rowdot(jnp.asarray(x).astype(dtype), jnp.asarray(wt),
                                 jnp.asarray(bias), alpha=alpha, rows=8, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    tol = {"float32": 1e-5, "bfloat16": 1e-2}[dtype]
    assert got.dtype == tdt and got.shape == want.shape
    assert np.abs(got.float().numpy() - want).max() <= tol * np.abs(want).max()
    # and the wrapper's CPU path, the plain version, agrees with the emulation
    plain = pc.pixel_conv_rowdot(torch.from_numpy(x).to(tdt), torch.from_numpy(wt),
                                 torch.from_numpy(bias), alpha=alpha)
    assert np.abs(plain.float().numpy() - got.float().numpy()).max() <= tol * np.abs(want).max()
    assert pc.launches == 0
