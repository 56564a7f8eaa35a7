"""`dequant_conv`'s shape-to-form choice (`smelter_tpu_torch/kernels/
wgmma_plan.py::conv_plan`) and the addressing of its wgmma form, checked
without a card: every output pixel and channel is stored once, a K step
never crosses a tap, shared memory fits, the plan's constants are the
header's, and a numpy replay of what `csrc/wgmma_gemm.cuh::gemm_tma_ra`'s
producer asks of the TMA unit's im2col walk (each box's first pixel, each
K step's tap and channels, zeros in the padding), multiplied out in
float64, equals `dequant_conv_plain` exactly on integer-valued inputs."""

from pathlib import Path

import numpy as np
import pytest
import torch

from smelter_tpu_torch.kernels import wgmma_plan as wp
from smelter_tpu_torch.kernels.dequant_conv import dequant_conv_plain

HEADER = (Path(__file__).resolve().parents[1] / "smelter_tpu_torch" / "csrc"
          / "wgmma_gemm.cuh").read_text()

# (N, H, W, C_in, C_out, k, pads): the card tests' DCONV_GEOMS and
# DCONV_WGMMA_GEOMS, ResNet-50's four stride-1 3x3 convs at batch 128 and 8.
DCONV_GEOMS = [(2, 14, 14, 64, 64, 3, ((1, 1), (1, 1))), (2, 12, 12, 128, 128, 5, ((2, 2), (2, 2))),
               (2, 11, 9, 128, 128, 3, ((0, 0), (0, 0))), (1, 28, 28, 128, 128, 3, ((1, 1), (1, 1))),
               (2, 17, 19, 3, 64, 3, ((1, 1), (1, 1))), (1, 9, 10, 40, 37, 3, ((0, 2), (1, 0)))]
WGMMA_GEOMS = [(2, 9, 13, 64, 128, 3, ((0, 2), (1, 0))), (3, 10, 15, 128, 64, 3, ((2, 0), (0, 1))),
               (2, 12, 12, 64, 128, 5, ((2, 2), (2, 2))), (3, 10, 10, 64, 64, 3, ((1, 1), (1, 1)))]
RESNET = [(b, hw, hw, c, c, 3, ((1, 1), (1, 1))) for b in (128, 8)
          for hw, c in ((56, 64), (28, 128), (14, 256), (7, 512))]
# the forms DCONV_GEOMS take: VALID 11 x 9 has 126 pixels, less than a tile
DCONV_FORMS = ["wgmma", "wgmma", "mma", "wgmma", "mma", "mma"]


def _out_shape(geom):
    n, h, w, cin, cout, k, ((pt, pb), (pl, pr)) = geom
    return n * (h + pt + pb - k + 1) * (w + pl + pr - k + 1), cout


@pytest.mark.parametrize("geom", DCONV_GEOMS + WGMMA_GEOMS + RESNET)
@pytest.mark.parametrize("aligned", [True, False])
def test_conv_plan_stores_every_output_once(geom, aligned):
    n, h, w, cin, cout, k, pads = geom
    p = wp.conv_plan(n, h, w, cin, cout, k, k, pads, aligned=aligned)
    M, N = _out_shape(geom)
    assert p.split == 1 and p.smem <= wp.SMEM_LIMIT
    if not aligned:
        assert p.form == "mma"
    nt = wp.cdiv(N, p.bn)
    assert p.tiles == wp.cdiv(M, p.bm) * nt
    stored = np.zeros((M, N), np.int64)
    blocks = range(p.grid) if p.form == "wgmma" else range(p.tiles)
    for b in blocks:  # the persistent CTAs of the wgmma form, a block a tile for mma
        for tile in (range(b, p.tiles, p.grid) if p.form == "wgmma" else [b]):
            m0, n0 = (tile // nt) * p.bm, (tile % nt) * p.bn
            stored[m0:m0 + p.bm, n0:n0 + p.bn] += 1
    assert (stored == 1).all()
    if p.form == "wgmma":
        assert cin % 64 == 0 and cout % 16 == 0 and M >= p.bm and p.grid <= wp.SMS
        assert p.bn == (128 if cout % 128 == 0 else 64) and p.bm == wp.ra_rows(p.bn)
        K = k * k * cin
        for kt in range(K // wp.BK):  # a K step lies inside one tap
            assert (kt * wp.BK) // cin == (kt * wp.BK + wp.BK - 1) // cin


def test_conv_plan_forms():
    """ResNet-50's shapes at b128 take the wgmma form (C_out 64: 1,568
    tiles of 256 pixels x 64 channels, not 3,136 half-empty ones of 128 x
    128), the odd ones the mma.sync kernel; fewer SMs, fewer CTAs."""
    assert [wp.conv_plan(*g[:5], g[5], g[5], g[6]).form for g in DCONV_GEOMS] == DCONV_FORMS
    plans = [wp.conv_plan(*g[:5], 3, 3, g[6]) for g in RESNET[:4]]
    assert [(p.form, p.bm, p.bn, p.tiles, p.grid) for p in plans] == [
        ("wgmma", 256, 64, 1568, 132), ("wgmma", 128, 128, 784, 132),
        ("wgmma", 128, 128, 392, 132), ("wgmma", 128, 128, 196, 132)]
    assert [p.code for p in plans] == [1] * 4
    assert wp.conv_plan(128, 7, 7, 512, 512, 3, 3, ((1, 1), (1, 1)), sms=64).grid == 64
    # negative pads, and corners a 4-D im2col map cannot hold, take mma
    assert wp.conv_plan(2, 16, 16, 64, 64, 3, 3, ((-1, 0), (0, 0))).form == "mma"
    assert wp.conv_plan(1, 300, 300, 64, 64, 3, 3, ((200, 0), (0, 0))).form == "mma"


def test_conv_plan_constants_are_the_headers():
    for wc, stages in ((128, 8), (64, 5)):
        assert wp.ra_stages(wc) == stages
    assert f"BN 128 int8 (and 32,768 for its staged 16-bit output): 8 stages, " \
           f"{wp.ra_smem(128):,}" in HEADER
    assert f"WC 64 int8 (two x boxes a stage): 5 stages, {wp.ra_smem(64):,}" in HEADER
    assert wp.ra_smem(128) == wp.tma_smem(128, True)


def _im2col_replay(x: np.ndarray, p: wp.ConvPlan, k: int, pads) -> np.ndarray:
    """A (M, K) as gemm_tma_ra's boxes fill it: for each tile the producer's
    first pixel of each box (its window column j - pl, row i - pt, image
    n), for each K step the tap (ky, kx) and channel c0, and the TMA unit's
    walk over the box's 128 pixels inside the bounding box of window starts
    that make_im2col_map encodes (lower corner (-pl, -pt), upper corner
    offsets (Wo - W - pl, Ho - H - pt) from the last pixel), each read at
    (w + kx, h + ky), zero outside the map."""
    n, h, w, c = x.shape
    (pt, pb), (pl, pr) = pads
    ho, wo = h + pt + pb - k + 1, w + pl + pr - k + 1
    M, K = n * ho * wo, k * k * c
    w_lo, w_hi = -pl, w - 1 + (wo - w - pl)
    h_lo, h_hi = -pt, h - 1 + (ho - h - pt)
    A = np.full((wp.cdiv(M, p.bm) * p.bm, K), np.nan)
    nt = wp.cdiv(p.tiles, wp.cdiv(M, p.bm))
    for tile in range(p.tiles):
        m0 = (tile // nt) * p.bm
        for b in range(min(p.bm // wp.BM, wp.cdiv(M - m0, wp.BM))):
            m = m0 + b * wp.BM
            img = m // (ho * wo)
            r = m - img * ho * wo
            i = r // wo
            first = (r - i * wo - pl, i - pt, img)
            for kt in range(K // wp.BK):
                k0 = kt * wp.BK
                tap = k0 // c
                ky, kx, c0 = tap // k, tap % k, k0 - tap * c
                wc, hc, nc = first
                for q in range(wp.BM):
                    hh, ww = hc + ky, wc + kx
                    inside = nc < n and 0 <= hh < h and 0 <= ww < w
                    A[m + q, k0:k0 + wp.BK] = x[nc, hh, ww, c0:c0 + wp.BK] if inside else 0.0
                    wc += 1
                    if wc > w_hi:
                        wc, hc = w_lo, hc + 1
                    if hc > h_hi:
                        hc, nc = h_lo, nc + 1
    return A[:M]


@pytest.mark.parametrize("geom", [(3, 9, 10, 64, 64, 3, ((1, 1), (1, 1))),
                                  (2, 8, 9, 64, 128, 5, ((2, 2), (2, 2))),
                                  (3, 11, 9, 64, 128, 3, ((0, 0), (0, 0)))])
def test_im2col_replay_equals_plain_exactly(geom):
    """3x3 pad 1 (256-pixel tiles of 64 channels, a last box past the last
    pixel), 5x5 pad 2 and VALID 11 x 9: the replayed A times an integer W,
    in float64, equals the plain conv of integer-valued f32 x (every sum an
    integer below 2^24, so exact in any order)."""
    n, h, w, cin, cout, k, pads = geom
    p = wp.conv_plan(n, h, w, cin, cout, k, k, pads)
    assert p.form == "wgmma"
    rng = np.random.default_rng(5)
    x = rng.integers(-4, 5, (n, h, w, cin)).astype(np.float32)
    wq = rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8)
    A = _im2col_replay(x, p, k, pads)
    assert not np.isnan(A).any()
    got = A @ wq.reshape(k * k * cin, cout).astype(np.float64)
    ref = dequant_conv_plain(torch.from_numpy(x), torch.from_numpy(wq),
                             torch.ones(cout), pads=pads).numpy()
    M = got.shape[0]
    assert np.array_equal(got, ref.reshape(M, cout).astype(np.float64))
