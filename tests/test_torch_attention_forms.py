"""The orders of `csrc/wgmma_attention.cuh`'s two forms as `short_attention`
and `flash_attention` run them on the card, emulated in plain PyTorch on
the CPU and held to the JAX package's Pallas kernels in interpret mode at
small sizes:

- the normalised form (`short_attention`): 128-key tiles; one tile: max,
  exps, their sum, p = e / l; two tiles in one pass, the first tile's exps
  against its own row max staged, p = e0 exp(m0 - m) / l and e1 / l; more:
  a pass for each row's max and sum, a second for p;
- the streaming form in one call (`flash_attention`): per 128-key tile m =
  max(m, max s), p = exp(s - m), l = alpha l + sum p over the f32 p, acc =
  alpha acc + p v with p rounded to the operands' 16-bit type, out = acc /
  l; no state leaves the call. A positive scale is folded into the
  exponent: the row max of the unscaled scores times scale, p = 2^(s scale
  log2 e - m log2 e).

In both, keys past N in the last tile are -inf against V rows of zeros
(TMA's fill), as the kernels do. Tolerances are the existing attention
tests': f32 1e-5 x max|Pallas| (sums in other orders), bf16 1e-2 (p
rounded to bf16 in both, or only in the kernel, and one ulp of an f32 p
can round apart).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smelter_tpu.kernels import attention_short as jas
from smelter_tpu.kernels import flash_attention as jfa
from smelter_tpu_torch.kernels import attention_plan as ap

KT = ap.KEY_TILE


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax(t: torch.Tensor):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


def _tile(q, k, scale, t, N):
    """The scores (..., Nq, KT) of key tile t in f32, times scale unless
    scale is None, keys past N -inf."""
    kt = k[..., t * KT:(t + 1) * KT, :].float()
    s = torch.einsum("...qd,...kd->...qk", q.float(), kt)
    if scale is not None:
        s = s * scale
    return torch.cat([s, s.new_full(s.shape[:-1] + (KT - s.shape[-1],), -torch.inf)], -1)


def _rounded(p, dtype):
    return p.to(dtype).float() if dtype != torch.float32 else p


def _v(v, t):
    """V's rows of tile t, zeros past N (TMA's fill)."""
    vt = v[..., t * KT:(t + 1) * KT, :].float()
    return torch.cat([vt, vt.new_zeros(vt.shape[:-2] + (KT - vt.shape[-2], vt.shape[-1]))], -2)


def norm_emulation(q, k, v, scale):
    """short_attention's normalised form (one pass up to two tiles, else two
    passes over resident tiles); q, k, v (B, H, N, hd)."""
    N, dt = q.shape[2], q.dtype
    tiles = -(-N // KT)
    o = 0
    if tiles == 1:
        s = _tile(q, k, scale, 0, N)
        e = torch.exp(s - s.amax(-1, keepdim=True))
        p = e * (1 / e.sum(-1, keepdim=True))
        o = _rounded(p, dt) @ _v(v, 0)
    elif tiles == 2:
        s0, s1 = _tile(q, k, scale, 0, N), _tile(q, k, scale, 1, N)
        m0 = s0.amax(-1, keepdim=True)
        e0 = torch.exp(s0 - m0)
        m = torch.maximum(m0, s1.amax(-1, keepdim=True))
        e1 = torch.exp(s1 - m)
        a0 = torch.exp(m0 - m)
        inv = 1 / (e0.sum(-1, keepdim=True) * a0 + e1.sum(-1, keepdim=True))
        o = _rounded(e1 * inv, dt) @ _v(v, 1) + _rounded(e0 * (a0 * inv), dt) @ _v(v, 0)
    else:
        m = torch.full(q.shape[:3] + (1,), -torch.inf)
        l = torch.zeros(q.shape[:3] + (1,))
        for t in range(tiles):
            s = _tile(q, k, scale, t, N)
            mn = torch.maximum(m, s.amax(-1, keepdim=True))
            l = l * torch.exp(m - mn) + torch.exp(s - mn).sum(-1, keepdim=True)
            m = mn
        for t in range(tiles):
            s = _tile(q, k, scale, t, N)
            o = o + _rounded(torch.exp(s - m) * (1 / l), dt) @ _v(v, t)
    return o.to(dt)


def stream_emulation(q, k, v, scale):
    """flash_attention's single-call streaming step with the scale folded
    into the exponent: q (B, H, Nq, hd), k and v (B, H, Nk, hd); no f32
    state leaves it."""
    Nk, dt = k.shape[2], q.dtype
    c = scale * math.log2(math.e)
    m = torch.full(q.shape[:3] + (1,), -torch.inf)
    l = torch.zeros(q.shape[:3] + (1,))
    acc = torch.zeros(q.shape[:3] + (q.shape[3],))
    for t in range(-(-Nk // KT)):
        s = _tile(q, k, None, t, Nk)  # unscaled
        mn = torch.maximum(m, s.amax(-1, keepdim=True) * scale)
        alpha = torch.exp2((m - mn) * math.log2(math.e))
        p = torch.exp2(s * c - mn * math.log2(math.e))
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = alpha * acc + _rounded(p, dt) @ _v(v, t)
        m = mn
    return (acc / l).to(dt)


def _err(got, want):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    got = got.double().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max()), float(np.abs(want).max())


# N: one tile (30, 128), two in one pass with a ragged tail (197: 9 of 16
# blocks live; 129: one), resident tiles (300)
@pytest.mark.parametrize("N", [30, 128, 129, 197, 300])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_normalised_form_matches_pallas(N, hd, dtype):
    B, H = 1, 2
    q, k, v = (torch.from_numpy(_rand((B, H, N, hd), s)).to(dtype) for s in (3, 4, 5))
    scale = hd ** -0.5
    got = norm_emulation(q, k, v, scale)
    assert got.dtype == dtype and got.shape == q.shape
    want = jas.short_attention(_jax(q), _jax(k), _jax(v), scale=scale, interpret=True)
    err, top = _err(got.float(), want)
    assert err <= (1e-5 if dtype == torch.float32 else 1e-2) * top, err


# (B, H, Nq, hd), Nk: a ragged last tile (600: 11 of 16 blocks live), Nq !=
# Nk both ways, a single key, hd 32 and 128
@pytest.mark.parametrize("case", [((1, 2, 600, 64), 600), ((1, 2, 300, 64), 600),
                                  ((2, 2, 130, 32), 65), ((1, 2, 5, 128), 1),
                                  ((1, 2, 70, 64), 257)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streaming_form_matches_pallas(case, dtype):
    (B, H, Nq, hd), Nk = case
    q = torch.from_numpy(_rand((B, H, Nq, hd), 0)).to(dtype)
    k = torch.from_numpy(_rand((B, H, Nk, hd), 1)).to(dtype)
    v = torch.from_numpy(_rand((B, H, Nk, hd), 2)).to(dtype)
    scale = hd ** -0.5
    got = stream_emulation(q, k, v, scale)
    assert got.dtype == dtype and got.shape == q.shape
    want = jfa.flash_attention(_jax(q), _jax(k), _jax(v), scale=scale, interpret=True)
    err, top = _err(got.float(), want)
    assert err <= (1e-5 if dtype == torch.float32 else 1e-2) * top, err


@pytest.mark.parametrize("scale", [0.125, 0.3, 1.0, 2.5])
def test_folded_scale_keeps_the_max(scale):
    """The streaming form's folded scale: the row max of the unscaled scores
    times a positive scale is, bit for bit, the row max of the scaled ones
    (f32 rounding is monotonic), so m and alpha are the unfolded order's."""
    q, k = (torch.from_numpy(_rand((2, 3, 197, 64), s)) for s in (7, 8))
    s = torch.einsum("bhqd,bhkd->bhqk", q, k)
    assert torch.equal(s.amax(-1) * scale, (s * scale).amax(-1))
