"""`mlp_block`'s form on the wgmma GEMM core, replayed in plain PyTorch and
held to the JAX package's Pallas kernel in interpret mode
(`smelter_tpu/kernels/mlp_block.py::mlp_block`), and its plans, checked
without a card:

- the GELU epilogue as `activate` (csrc/common.cuh) spells it in f32 equals
  `gelu_kernel_form`, both forms;
- the walk: the pre-LN, then FC1 and FC2 on gemm_tma's tiles of 128 x 128
  with f32 sums over K steps of 64, FC1's epilogue (bias and GELU in f32,
  one rounding), FC2's (bias in f32, the residual x + (acc + b) in f32, one
  rounding): bf16 within 1e-2 and f32 within 1e-5 of the largest output,
  pre_ln 0/1, both GELU forms, residual 0/1, f32 and 16-bit biases;
- `mlp_block.plans`: `gemm_tma` for ViT-B/16's FC1 and FC2 and at SD-UNet's
  widths, csrc/gemm.cuh where a map cannot read the shape, and for f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smelter_tpu.kernels import mlp_block as jmb
from smelter_tpu_torch.kernels import mlp_block as mb
from smelter_tpu_torch.kernels import wgmma_plan as wp
from smelter_tpu_torch.kernels.layer_norm import layer_norm_plain


def _activate(h: torch.Tensor, approximate: bool) -> torch.Tensor:
    """csrc/common.cuh's `activate` in f32, operation for operation: the
    tanh form, or the exact form's polynomial with erf's sign chosen by
    z > 0 / z < 0."""
    if approximate:
        return 0.5 * h * (1.0 + torch.tanh(0.7978845608028654 * (h + 0.044715 * h * h * h)))
    z = h * 0.7071067811865476
    az = z.abs()
    t = 1.0 / (1.0 + 0.3275911 * az)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    erf_abs = 1.0 - poly * torch.exp(-az * az)
    erf = torch.where(z > 0, erf_abs, torch.where(z < 0, -erf_abs, torch.zeros_like(z)))
    return 0.5 * h * (1.0 + erf)


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_epilogue_equals_the_kernel_form(approximate):
    rng = np.random.default_rng(3)
    h = torch.cat([torch.linspace(-9, 9, 8001), torch.zeros(3),
                   torch.from_numpy(rng.standard_normal(20000).astype(np.float32) * 4)])
    assert torch.equal(_activate(h, approximate), mb.gelu_kernel_form(h, approximate))


def _tma_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """gemm_tma's sums: 128 x 128 tiles of out, each f32 accumulator summed
    over K steps of 64 in order."""
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


def _mlp_tma_emulation(x, ln_g, ln_b, w1, b1, w2, b2, *, eps, approximate, residual, pre_ln):
    """csrc/mlp_block.cu with both products on gemm_tma: the pre-LN
    (csrc/layer_norm.cuh, rounded to x's type), FC1 with kEpiBiasGelu /
    kEpiBiasGeluTanh (acc + b1 in f32, GELU in f32, one rounding), FC2 with
    kEpiBiasRes (x + (acc + b2) in f32, one rounding) or kEpiBias."""
    dt = x.dtype
    D = x.shape[-1]
    rows = x.reshape(-1, D)
    xn = layer_norm_plain(rows, ln_g, ln_b, eps=eps) if pre_ln else rows
    h = _activate(_tma_gemm(xn, w1) + b1.float(), approximate).to(dt)
    y = _tma_gemm(h, w2) + b2.float()
    if residual:
        y = rows.float() + y
    return y.to(dt).reshape(x.shape)


def _operands(M, D, F, dtype, bias_dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((M, D)), 1 + 0.1 * rng.standard_normal(D),
            0.1 * rng.standard_normal(D), rng.standard_normal((D, F)) / np.sqrt(D),
            0.1 * rng.standard_normal(F), rng.standard_normal((F, D)) / np.sqrt(F),
            0.1 * rng.standard_normal(D))
    t = [torch.from_numpy(a.astype(np.float32)) for a in arrs]
    dts = (dtype, bias_dtype, bias_dtype, dtype, bias_dtype, dtype, bias_dtype)
    return [a.to(d) for a, d in zip(t, dts)]


def _jax(t: torch.Tensor):
    a = jnp.asarray(t.float().numpy())
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


@pytest.mark.parametrize("pre_ln", [True, False])
@pytest.mark.parametrize("approximate", [False, True])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("dtype,bias_dtype", [(torch.float32, torch.float32),
                                              (torch.bfloat16, torch.float32),
                                              (torch.bfloat16, torch.bfloat16)])
def test_mlp_tma_emulation_matches_pallas(pre_ln, approximate, residual, dtype, bias_dtype):
    """M 160 (a ragged row tile), D 128, F 256: FC1 and FC2 both past one
    K step and one N tile. f32 within 1e-5 of the largest output; bf16
    within 1e-2 (xn and h round to bf16 after sums in other orders)."""
    x, g, b, w1, b1, w2, b2 = _operands(160, 128, 256, dtype, bias_dtype, 16)
    kw = dict(eps=1e-6, approximate=approximate, residual=residual, pre_ln=pre_ln)
    got = _mlp_tma_emulation(x, g, b, w1, b1, w2, b2, **kw)
    want = jmb.mlp_block(*(_jax(t)[None] if i == 0 else _jax(t)
                           for i, t in enumerate((x, g, b, w1, b1, w2, b2))),
                         interpret=True, **kw)
    want = np.asarray(want.astype(jnp.float32))[0]
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert got.dtype == dtype
    assert np.abs(got.float().numpy() - want).max() <= tol * np.abs(want).max()
    # the wrapper's CPU path (the plain version) agrees with the walk
    plain = mb.mlp_block(x, g, b, w1, b1, w2, b2, **kw)
    assert (plain.float() - got.float()).abs().max() <= tol * np.abs(want).max()
    assert mb.launches == 0


# (M, D, F, dtype) -> (FC1's form, FC2's form)
PLANS = [
    ((25_216, 768, 3072), torch.bfloat16, ("tma", "tma")),   # ViT-B/16 at batch 128
    ((1576, 768, 3072), torch.float16, ("tma", "tma")),      # ... at batch 8
    ((8192, 320, 1280), torch.bfloat16, ("tma", "tma")),     # SD-UNet's widths
    ((2048, 640, 2560), torch.bfloat16, ("tma", "tma")),
    ((200, 64, 256), torch.bfloat16, ("tma", "mma")),        # FC2's N 64: below a tile
    ((100, 256, 1024), torch.bfloat16, ("mma", "mma")),      # M 100: below a tile
    ((256, 48, 128), torch.bfloat16, ("mma", "mma")),        # D 48: FC1's K below a step
    ((25_216, 768, 3072), torch.float32, ("mma", "mma")),    # f32: the full-f32 kernel
]


@pytest.mark.parametrize("case", PLANS)
def test_mlp_plans(case):
    (M, D, F), dtype, forms = case
    fc1, fc2 = mb.plans(M, D, F, dtype)
    assert (fc1.form, fc2.form) == forms
    for p, (m, n, k), gelu in ((fc1, (M, F, D), True), (fc2, (M, D, F), False)):
        if p.form == "tma":
            assert p == wp.block_plan(m, n, k, gelu=gelu)
            assert p.smem == wp.tma_smem(wp.TMA_BN, False, recv=gelu)
            assert p.grid == min(wp.cdiv(m, wp.BM) * wp.cdiv(n, wp.TMA_BN), wp.SMS)
            assert p.smem <= wp.SMEM_LIMIT and p.code == 1
        else:
            assert p.code == 0
    assert mb.plans(25_216, 768, 3072, torch.bfloat16, sms=64)[0].grid == 64
