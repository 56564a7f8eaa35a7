"""`cross_attn_block`'s wgmma form, replayed in plain PyTorch and held to the
JAX package's Pallas kernel in interpret mode
(`smelter_tpu/kernels/vit_block.py::cross_attn_block`), and its plan,
checked without a card:

- the walk: a CTA a 64-row tile x a group of 64 / hd heads; q = x Wq[:,
  group] summed in f32 and rounded; per head the scores in f32 times scale,
  keys padded to 16 scoring -inf, the softmax in f32 as exp(s - max) / sum,
  p rounded, p v in f32; the group's heads side by side, rounded: its part
  of the row tile's attention output, which the cluster's CTAs share; then
  each CTA's group of output columns, att Wp[:, group] summed in f32 over
  the whole of D, bp added in f32, one rounding: bf16 within 1e-2 and f32
  within 1e-5 of the largest output, at both SD-UNet geometries cut to B 2,
  Bk 1 and B, S 16 and 7;
- `attention_plan.cross_plan`: the wgmma form with clusters of D / 64 CTAs
  and at least 128 CTAs at SD-UNet's two b8 shapes, the mma.sync form for
  other 16-bit D, the f32 kernel for f32, and no kernel for D > 256 or hd
  128; its shared memory is the .cu's.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smelter_tpu.kernels import vit_block as jvb
from smelter_tpu_torch.kernels import attention_plan as ap
from smelter_tpu_torch.kernels import cross_attn_block as xa

CU = (Path(__file__).resolve().parents[1] / "smelter_tpu_torch" / "csrc"
      / "cross_attn_block.cu").read_text()


def _operands(B, N, D, H, S, bk, seed=0):
    rng = np.random.default_rng(seed)
    hd = D // H
    return tuple(a.astype(np.float32) for a in (
        rng.standard_normal((B, N, D)), rng.standard_normal((D, D)) / np.sqrt(D),
        rng.standard_normal((bk, H, S, hd)), rng.standard_normal((bk, H, S, hd)),
        rng.standard_normal((D, D)) / np.sqrt(D), 0.1 * rng.standard_normal(D)))


def wgmma_replay(x, wq, k, v, wp, bp, *, heads: int, scale=None) -> torch.Tensor:
    """The wgmma form's arithmetic: each (64-row tile, head group) CTA's
    part of the attention output, then each CTA's group of output columns
    from the whole row tile's, bp in f32, one rounding. x (B, N, D) in its
    working type."""
    B, N, D = x.shape
    hd = D // heads
    gh = ap.XG_COLS // hd
    scale = scale if scale else 1.0 / hd ** 0.5
    dt = x.dtype
    sp = ap.cross_keys(k.shape[2])
    out = torch.empty(B, N, D, dtype=dt)
    for b in range(B):
        kb, vb = (k[b], v[b]) if k.shape[0] > 1 else (k[0], v[0])
        for r0 in range(0, N, ap.XG_ROWS):
            xt = torch.zeros(ap.XG_ROWS, D, dtype=dt)  # rows past N: zeros
            rows = min(ap.XG_ROWS, N - r0)
            xt[:rows] = x[b, r0:r0 + rows]
            att = []
            for g in range(D // ap.XG_COLS):
                cols = slice(g * ap.XG_COLS, (g + 1) * ap.XG_COLS)
                q = (xt.float() @ wq[:, cols].float()).to(dt)
                outs = []
                for hl in range(gh):
                    h = g * gh + hl
                    kp = torch.zeros(sp, hd, dtype=dt)  # keys past S: zeros, scored -inf
                    vp = torch.zeros(sp, hd, dtype=dt)
                    kp[:k.shape[2]], vp[:k.shape[2]] = kb[h], vb[h]
                    s = q[:, hl * hd:(hl + 1) * hd].float() @ kp.float().T * scale
                    s[:, k.shape[2]:] = -torch.inf
                    e = torch.exp(s - s.amax(-1, keepdim=True))
                    p = (e / e.sum(-1, keepdim=True)).to(dt)
                    outs.append(p.float() @ vp.float())
                att.append(torch.cat(outs, 1).to(dt))  # the group's part
            att = torch.cat(att, 1)  # the cluster's shared copy: 64 x D
            for g in range(D // ap.XG_COLS):
                cols = slice(g * ap.XG_COLS, (g + 1) * ap.XG_COLS)
                acc = att.float() @ wp[:, cols].float() + bp.float()[cols]
                out[b, r0:r0 + rows, cols] = acc[:rows].to(dt)
    return out


# (B, N, D, H): SD-UNet's two cross-attention geometries cut to batch 2
SD_GEOMS = [(2, 1024, 128, 8), (2, 256, 256, 8)]


@pytest.mark.parametrize("geom", SD_GEOMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bk", ["B", 1])
@pytest.mark.parametrize("S", [16, 7])
def test_wgmma_walk_matches_pallas(geom, dtype, bk, S):
    B, N, D, H = geom
    args = _operands(B, N, D, H, S, B if bk == "B" else 1)
    tdt = getattr(torch, dtype)
    got = wgmma_replay(*(torch.from_numpy(a).to(tdt) for a in args[:5]),
                       torch.from_numpy(args[5]), heads=H)
    want = jvb.cross_attn_block(*(jnp.asarray(a).astype(dtype) for a in args[:5]),
                                jnp.asarray(args[5]), heads=H, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    # f32: sums in other orders (the groups' K split among them) -> 1e-5;
    # bf16: q, p, the attention output and the result round to 8 bits -> 1e-2
    tol = {"float32": 1e-5, "bfloat16": 1e-2}[dtype]
    assert got.dtype == tdt and tuple(got.shape) == (B, N, D)
    assert np.abs(got.float().numpy() - want).max() <= tol * np.abs(want).max()


def test_wgmma_walk_ragged_rows_and_scale():
    """N 70 (a part row tile), D 256 (four groups of one hd-64 head), S 33
    (padded to 64) and a stated scale, against the Pallas kernel."""
    args = _operands(1, 70, 256, 4, 33, 1, seed=2)
    got = wgmma_replay(*(torch.from_numpy(a).to(torch.bfloat16) for a in args[:5]),
                       torch.from_numpy(args[5]), heads=4, scale=0.3)
    want = jvb.cross_attn_block(*(jnp.asarray(a).astype("bfloat16") for a in args[:5]),
                                jnp.asarray(args[5]), heads=4, scale=0.3, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    assert np.abs(got.float().numpy() - want).max() <= 1e-2 * np.abs(want).max()


def test_wgmma_walk_rows_do_not_depend_on_batch_position():
    """The replay of image 1 alone equals its rows inside B 2 bit for bit:
    a CTA reads only its own image's rows, k and v, and each output column
    is one CTA's sum in a fixed order."""
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in _operands(2, 256, 256, 8, 16, 2)]
    x, wq, k, v, wp, bp = args
    full = wgmma_replay(x, wq, k, v, wp, bp.float(), heads=8)
    one = wgmma_replay(x[1:], wq, k[1:], v[1:], wp, bp.float(), heads=8)
    assert torch.equal(full[1:], one)


def test_cross_plan_at_sd_unets_shapes():
    for (N, D, groups, heads) in ((1024, 128, 2, 4), (256, 256, 4, 2)):
        for dtype in (torch.bfloat16, torch.float16):
            p = ap.cross_plan(8, N, D, 8, 16, dtype)
            assert (p.form, p.code, p.groups, p.heads, p.cluster) == ("wgmma", 1, groups, heads,
                                                                      groups)
            assert p.grid == (groups, N // 64, 8) and p.ctas >= 128
            assert p.cluster <= 8 and p.smem == ap.cross_smem(D, 16) <= ap.SMEM_LIMIT
    # the mma.sync form gave one block a 64-row tile: 32 at (N 256, D 256)
    assert ap.cross_plan(8, 256, 256, 8, 16, torch.bfloat16).ctas == 4 * 32


@pytest.mark.parametrize("case", [
    # (B, N, D, heads, S, dtype, form)
    (8, 1024, 128, 8, 16, torch.float32, "f32"),
    (8, 256, 256, 8, 16, torch.float32, "f32"),
    (1, 70, 96, 3, 33, torch.bfloat16, "mma"),    # D 96: no multiple of 64
    (1, 10, 80, 5, 1, torch.float16, "mma"),
    (3, 100, 192, 3, 40, torch.bfloat16, "wgmma"),
    (3, 100, 256, 4, 40, torch.bfloat16, "wgmma"),
    (2, 37, 64, 4, 5, torch.float16, "wgmma"),
    (1, 8, 512, 8, 16, torch.bfloat16, "none"),  # D above 256
    (1, 8, 256, 2, 16, torch.bfloat16, "none"),  # hd 128
    (1, 8, 128, 8, 65, torch.bfloat16, "none"),  # 65 keys
])
def test_cross_plan_forms(case):
    B, N, D, heads, S, dtype, form = case
    p = ap.cross_plan(B, N, D, heads, S, dtype)
    assert p.form == form and p.code == (1 if form == "wgmma" else 0)
    if form == "wgmma":
        assert p.cluster == D // 64 and p.grid == (D // 64, -(-N // 64), B)
    elif form == "mma":
        assert p.cluster == 1 and p.grid == (-(-N // 64), B, 1)
        assert p.smem == ap.cross_mma_smem(D, heads, S) <= ap.SMEM_LIMIT
    elif form == "f32":
        assert p.grid == (-(-N // 16), B, 1) and p.smem == 0


def test_cross_plan_constants_are_the_cu_files():
    nums = dict(re.findall(r"constexpr int (XG_COLS|XG_ROWS) = (\d+);", CU))
    assert {k: int(v) for k, v in nums.items()} == {"XG_COLS": ap.XG_COLS, "XG_ROWS": ap.XG_ROWS}
    assert "return 1024 + 3 * 128 * D + 2 * 128 * SP + 3 * 8;" in CU
    # the row tile's attention output (64 rows of D, 16-bit) fits in x's bytes
    assert ap.XG_ROWS * 2 == 128
    # two CTAs an SM at SD-UNet's D 256 (228 KB an SM, 1 KB of it a CTA's)
    assert 2 * (ap.cross_smem(256, 16) + 1024) <= 228 * 1024
    assert int(re.search(r"constexpr int XMAX_D = (\d+);", CU).group(1)) == ap.CROSS_MAX_D
    assert int(re.search(r"constexpr int XMAX_S = (\d+);", CU).group(1)) == ap.CROSS_MAX_S
    assert ap.cross_smem(256, 64) <= ap.SMEM_LIMIT


def test_wrapper_plans_and_takes_the_plain_version_on_cpu():
    x = torch.zeros(2, 64, 128, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 16, 16, dtype=torch.bfloat16)
    assert xa.plan(x, k, 8) == ap.cross_plan(2, 64, 128, 8, 16, torch.bfloat16)
    w = torch.eye(128, dtype=torch.bfloat16)
    out = xa.cross_attn_block(x, w, k, k, w, torch.zeros(128), heads=8)
    assert out.shape == x.shape and xa.launches == 0 and sum(xa.forms.values()) == 0
