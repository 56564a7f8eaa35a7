"""`convnext_block`'s walk on the wgmma GEMM core, replayed in plain PyTorch
and held to the JAX package's Pallas kernel in interpret mode
(`smelter_tpu/kernels/convnext_block.py::convnext_block`), and its plans,
checked without a card:

- the walk: the depthwise taps (dy outer, dx inner, f32 products and sums,
  then the bias) and the LayerNorm in f32, xn rounded once; FC1 and FC2 on
  gemm_tma's tiles of 128 x 128 with f32 sums over K steps of 64 (K 24 and
  96 end inside a step, N 24 and 96 inside a tile); FC1's epilogue (b1 and
  GELU in f32, one rounding) and FC2's kEpiBiasScaleRes (x + gamma (acc +
  b2), each f32 operation rounded on its own, one rounding to x's type):
  bf16 within 1e-2 and f32 within 1e-5 of the largest output, at C 96
  (stage 1's FC2, N below a tile) and C 24, with f32 and 16-bit parameters;
- `convnext_block.plans`: `gemm_tma` for FC1 and FC2 at ConvNeXt-T's three
  fused stages at batch 64 (FC2's N 96 included), csrc/gemm.cuh for f32
  and where a map cannot read the shape.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smelter_tpu.kernels import convnext_block as jcb
from smelter_tpu_torch.kernels import convnext_block as cb
from smelter_tpu_torch.kernels import wgmma_plan as wp


def _activate(h: torch.Tensor) -> torch.Tensor:
    """csrc/common.cuh's `activate` (the exact form) in f32, operation for
    operation."""
    z = h * 0.7071067811865476
    az = z.abs()
    t = 1.0 / (1.0 + 0.3275911 * az)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    erf_abs = 1.0 - poly * torch.exp(-az * az)
    erf = torch.where(z > 0, erf_abs, torch.where(z < 0, -erf_abs, torch.zeros_like(z)))
    return 0.5 * h * (1.0 + erf)


def _tma_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """gemm_tma's sums: 128 x 128 tiles of out, each f32 accumulator summed
    over K steps of 64 in order (the boxes past K or N read zeros)."""
    M, K = a.shape
    N = b.shape[1]
    out = torch.zeros(M, N)
    for m0 in range(0, M, wp.BM):
        for n0 in range(0, N, wp.TMA_BN):
            acc = torch.zeros(min(wp.BM, M - m0), min(wp.TMA_BN, N - n0))
            for k0 in range(0, K, wp.BK):
                acc += (a[m0:m0 + wp.BM, k0:k0 + wp.BK].float()
                        @ b[k0:k0 + wp.BK, n0:n0 + wp.TMA_BN].float())
            out[m0:m0 + wp.BM, n0:n0 + wp.TMA_BN] = acc
    return out


def _dw_ln(x, dw, dw_b, ln_g, ln_b, eps):
    """dw_ln_staged: the 49 taps of the zero-padded tile in f32, dy outer and
    dx inner, the bias added after them; the LayerNorm over C in f32 (mean,
    then the mean of squared deviations), xn rounded once."""
    B, H, W, C = x.shape
    xp = torch.zeros(B, H + 6, W + 6, C)
    xp[:, 3:3 + H, 3:3 + W] = x.float()
    w = dw.float().reshape(7, 7, C)
    acc = torch.zeros(B, H, W, C)
    for dy in range(7):
        for dx in range(7):
            acc = acc + xp[:, dy:dy + H, dx:dx + W] * w[dy, dx]
    acc = acc + dw_b.float()
    mu = acc.mean(-1, keepdim=True)
    d = acc - mu
    var = (d * d).mean(-1, keepdim=True)
    return (d * torch.rsqrt(var + eps) * ln_g.float() + ln_b.float()).to(x.dtype)


def _convnext_tma_emulation(x, dw, dw_b, ln_g, ln_b, w1, b1, w2, b2, gamma, *, eps):
    """csrc/convnext_block.cu with both products on gemm_tma: FC1 with
    kEpiBiasGelu, FC2 with kEpiBiasScaleRes."""
    dt = x.dtype
    B, H, W, C = x.shape
    xn = _dw_ln(x, dw, dw_b, ln_g, ln_b, eps).reshape(-1, C)
    h = _activate(_tma_gemm(xn, w1) + b1.float()).to(dt)
    y = (_tma_gemm(h, w2) + b2.float()) * gamma.float()  # __fadd_rn, then __fmul_rn
    return (x.reshape(-1, C).float() + y).to(dt).reshape(x.shape)  # __fadd_rn, one rounding


def _operands(B, H, W, C, dtype, p_dtype, seed):
    rng = np.random.default_rng(seed)
    F = 4 * C
    arrs = (rng.standard_normal((B, H, W, C)), rng.standard_normal((7, 7, 1, C)) / 7,
            0.1 * rng.standard_normal(C), 1 + 0.1 * rng.standard_normal(C),
            0.1 * rng.standard_normal(C), rng.standard_normal((C, F)) / np.sqrt(C),
            0.1 * rng.standard_normal(F), rng.standard_normal((F, C)) / np.sqrt(F),
            0.1 * rng.standard_normal(C), 0.5 + 0.1 * rng.standard_normal(C))
    dts = (dtype, dtype, p_dtype, p_dtype, p_dtype, dtype, p_dtype, dtype, p_dtype, p_dtype)
    return [torch.from_numpy(a.astype(np.float32)).to(d) for a, d in zip(arrs, dts)]


def _jax(t: torch.Tensor):
    a = jnp.asarray(t.float().numpy())
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


# (B, H, W, C): stage 1's C 96 (FC2's N 96 inside one 128-column tile, FC1's
# K 96 one and a half steps) over 196 rows (a ragged row tile); C 24 (K and
# N inside one box) over odd H and W
GEOMS = [(1, 14, 14, 96), (2, 5, 9, 24)]


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("dtype,p_dtype", [(torch.float32, torch.float32),
                                           (torch.bfloat16, torch.float32),
                                           (torch.bfloat16, torch.bfloat16)])
def test_convnext_tma_emulation_matches_pallas(geom, dtype, p_dtype):
    """f32 within 1e-5 of the largest output; bf16 within 1e-2 (xn and h
    round to bf16 after sums in other orders)."""
    args = _operands(*geom, dtype, p_dtype, 18)
    got = _convnext_tma_emulation(*args, eps=1e-6)
    want = jcb.convnext_block(*(_jax(t) for t in args), eps=1e-6, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert got.dtype == dtype and tuple(got.shape) == geom
    assert np.abs(got.float().numpy() - want).max() <= tol * np.abs(want).max()
    # the wrapper's CPU path (the plain version) agrees with the walk
    plain = cb.convnext_block(*args, eps=1e-6)
    assert (plain.float() - got.float()).abs().max() <= tol * np.abs(want).max()
    assert cb.launches == 0


# (B, H, W, C) at batch 64: ConvNeXt-T's three fused stages, FC2's N 96 in
CNX_T = [(64, 56, 56, 96), (64, 28, 28, 192), (64, 14, 14, 384)]


@pytest.mark.parametrize("geom", CNX_T)
def test_convnext_plans_take_gemm_tma(geom):
    B, H, W, C = geom
    M, F = B * H * W, 4 * C
    fc1, fc2 = cb.plans(M, C, F, torch.bfloat16)
    assert (fc1.form, fc2.form) == ("tma", "tma")
    assert fc1 == wp.block_plan(M, F, C, gelu=True)
    assert fc2 == wp.layer_scale_plan(M, C, F)
    assert fc1.smem == wp.tma_smem(wp.TMA_BN, False, recv=True)
    assert fc2.smem == wp.tma_smem(wp.TMA_BN, False)
    for p, n in ((fc1, F), (fc2, C)):
        assert p.grid == min(wp.cdiv(M, wp.BM) * wp.cdiv(n, wp.TMA_BN), wp.SMS)
        assert p.smem <= wp.SMEM_LIMIT and p.code == 1
    # block_plan alone refuses stage 1's FC2 (N 96 below a tile)
    if C < wp.TMA_BN:
        assert wp.block_plan(M, C, F).form == "mma"
    assert cb.plans(M, C, F, torch.float16) == (fc1, fc2)
    assert cb.plans(M, C, F, torch.bfloat16, sms=64)[0].grid == 64


# (M, C, F, dtype) -> forms
OTHER_PLANS = [
    ((64 * 56 * 56, 96, 384), torch.float32, ("mma", "mma")),   # f32: the full-f32 kernel
    ((100, 96, 384), torch.bfloat16, ("mma", "mma")),           # M below a row tile
    ((8192, 48, 192), torch.bfloat16, ("mma", "mma")),          # FC1's K 48 below a step
    ((8192, 64, 256), torch.bfloat16, ("tma", "tma")),          # FC2's N one 64-column box
    ((8192, 40, 160), torch.bfloat16, ("mma", "mma")),          # FC2's N 40 below a box
]


@pytest.mark.parametrize("case", OTHER_PLANS)
def test_convnext_plans_elsewhere(case):
    (M, C, F), dtype, forms = case
    fc1, fc2 = cb.plans(M, C, F, dtype)
    assert (fc1.form, fc2.form) == forms
    assert all(p.code == (1 if p.form == "tma" else 0) for p in (fc1, fc2))
