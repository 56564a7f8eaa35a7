"""`dequant_conv`'s shape-to-form choice (`smelter_tpu_torch/kernels/
wgmma_plan.py::conv_plan`) and the addressing of its wgmma form, checked
without a card: every output pixel and channel is stored once, a K step
never crosses a tap, shared memory fits, the plan's constants are the
header's, and a numpy replay of what `csrc/wgmma_gemm.cuh::gemm_tma_ra`'s
producer asks of the TMA unit's im2col walk (each box's first pixel, each
K step's tap and channels, zeros in the padding), multiplied out in
float64, equals `dequant_conv_plain` exactly on integer-valued inputs."""

import re
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


# -- pixel_conv_blockdot's taller tile (wgmma_plan.pixel_plan(..., tall=True)) --

CONV_HEADER = (Path(__file__).resolve().parents[1] / "smelter_tpu_torch" / "csrc"
               / "wgmma_conv.cuh").read_text()
# ESRGAN x4's eight PixelConv shapes at batch 8: (B, H, C_in, W, C_out)
ESRGAN = [(8, 128, 64 + 32 * i, 128, 32 if i < 4 else 64) for i in range(5)] + [
    (8, s, 64, s, 64) for s in (128, 256, 512)]


def _strides(b, h, c, w):
    return (h * c * w, c * w, w)


@pytest.mark.parametrize("shape", ESRGAN)
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_blockdot_plan_at_esrgans_shapes(shape, dtype):
    """The 8-row tile where the plan's rule takes the shape (C_out 32, C_in
    >= 96; else the 4-row tile): its stages and shared memory within the budget,
    and every (image, row block, pixel tile) taken once by the persistent
    CTAs."""
    b, h, c, w, co = shape
    p = wp.pixel_plan(b, h, w, c, co, _strides(b, h, c, w), dtype, tall=True)
    rows = wp.PC_TALL_R if wp.pixel_tall_takes(c, co) else wp.PC_R
    assert (p.form, p.rows, p.px) == ("wgmma", rows, wp.PC_PX)
    assert p.code == (2 if p.resident else 1)
    assert p.tiles == b * wp.cdiv(h, rows) * wp.cdiv(w, wp.PC_PX)
    assert p.grid == min(p.tiles, wp.SMS)
    want = (wp.pixel_resident_smem(c, co, rows=rows) if p.resident
            else wp.pixel_smem(co, rows=rows))
    assert p.smem == want <= wp.SMEM_LIMIT
    assert p.smem - 1024 <= wp.SMEM_BUDGET
    if rows == wp.PC_TALL_R:
        assert p.stages >= wp.PC_TALL_MIN_STAGES
        assert p == wp.pixel_tall_plan(b, h, w, c, co)
    taken = sorted(t for cta in range(p.grid) for t in range(cta, p.tiles, p.grid))
    assert taken == list(range(p.tiles))


def test_blockdot_tall_tile_sizes_are_the_headers():
    """A tall step stages 10 rows: the box 25,600 bytes in a ring of two
    (and two mbarriers a slot), a stage its copy, 23,040 padded to 23,552,
    and the weights; the header's table of stages and bytes; the 4-row
    tile's own sizes unchanged."""
    assert wp.pixel_box(wp.PC_TALL_R) == 10 * 16 * 80 * 2
    assert wp.pixel_ring(wp.PC_TALL_R) == 2 * (25_600 + 16) and wp.pixel_ring() == 0
    assert wp.pixel_stage(32, True, rows=wp.PC_TALL_R) == 23_552
    assert wp.pixel_stage(64, rows=wp.PC_TALL_R) == 23_552 + 9 * 64 * 32
    assert wp.pixel_stage(64) == 15_360 + 14_336 + 9 * 64 * 32
    nums = dict(re.findall(r"constexpr int (PC_TALL_RW|PC_EPI_RW|PC_TRANSPOSERS) = (\d+);",
                           CONV_HEADER))
    assert {k: int(v) for k, v in nums.items()} == {
        "PC_TALL_RW": wp.PC_TALL_RW, "PC_EPI_RW": wp.PC_EPI_RW,
        "PC_TRANSPOSERS": wp.PC_TRANSPOSERS}
    for co in (64, 32):
        stages = wp.pixel_stages(co, rows=wp.PC_TALL_R)
        assert re.search(rf"tall, C_out {co}: {stages} stages, "
                         rf"{wp.pixel_smem(co, rows=wp.PC_TALL_R):,}", CONV_HEADER)
    for c_in, co in ((64, 32), (64, 64)):
        stages = wp.pixel_resident_stages(c_in, co, rows=wp.PC_TALL_R)
        assert re.search(rf"tall, resident, C_in {c_in} -> C_out {co}: {stages} stages, "
                         rf"{wp.pixel_resident_smem(c_in, co, rows=wp.PC_TALL_R):,}",
                         CONV_HEADER)
    # the producer's 96 transposers take whole units of the 10-row copy
    assert (wp.PC_TALL_R + 2) * 2 * wp.PC_XPX % wp.PC_TRANSPOSERS == 0
    assert wp.pixel_smem(64) == 226_400 and wp.pixel_stages(64) == 4


BLOCKDOT_EDGES = [
    # (B, H, C_in, W, C_out, dtype, form, rows)
    (1, 16, 64, 128, 64, "float32", "mma", 4),    # f32: its FMA kernel's 4-row blocks
    (1, 16, 64, 128, 40, "bfloat16", "mma", 4),   # C_out 40: mma.sync's 4-row blocks
    (1, 16, 64, 64, 32, "bfloat16", "mma", 4),    # W 64: narrower than the 80-pixel box
    (1, 16, 64, 72, 32, "float16", "mma", 4),
    (2, 7, 64, 88, 32, "bfloat16", "wgmma", 4),   # H 7 < 10: the 4-row tile
    (1, 9, 96, 136, 64, "bfloat16", "wgmma", 4),
    (1, 5, 64, 128, 32, "bfloat16", "mma", 4),    # H 5: below the 4-row tile's box too
    (2, 12, 96, 88, 32, "bfloat16", "wgmma", 8),  # H 12: one whole and one part 8-row tile
    (1, 10, 128, 80, 32, "float16", "wgmma", 8),
    (2, 12, 64, 88, 32, "bfloat16", "wgmma", 4),  # C_in 64: four K steps, the 4-row tile
    (1, 12, 96, 136, 64, "bfloat16", "wgmma", 4),  # C_out 64: the 4-row tile
]


@pytest.mark.parametrize("case", BLOCKDOT_EDGES)
def test_blockdot_plan_edges(case):
    b, h, c, w, co, dtype, form, rows = case
    p = wp.pixel_plan(b, h, w, c, co, _strides(b, h, c, w), dtype, tall=True)
    assert (p.form, p.rows) == (form, rows)
    assert (rows == wp.PC_TALL_R) == (form == "wgmma" and h >= wp.PC_TALL_R + 2
                                      and wp.pixel_tall_takes(c, co))
    if form == "mma":
        assert p.code == 0 and p.smem == 0
    else:
        assert p.smem <= wp.SMEM_LIMIT
        # rowdot's plan at the same shape keeps its 4-row tile
        assert wp.pixel_plan(b, h, w, c, co, _strides(b, h, c, w), dtype).rows == wp.PC_R


def _tall_replay(x, wt, rows: int) -> np.ndarray:
    """The wgmma form's sums in float64 on tiles of `rows` output rows:
    per K step of 16 channels the TMA box of rows + 2 input rows (zeros
    outside the map) and the producer's K-major copy of pixel rows w0 - 1 ..
    w0 + 70, then 9 taps x rows products from the copy at row offset dx."""
    B, H, C, W = x.shape
    co = wt.shape[0]
    wpk = np.transpose(wt, (2, 3, 0, 1)).reshape(9, co, C)
    xp = np.zeros((B, H + rows + 2, C, W + 72))
    xp[:, 1:H + 1, :, 1:W + 1] = x  # row -1 and pixel -1 at index 0
    out = np.full((B, H, co, W), np.nan)
    for b in range(B):
        for h0 in range(0, H, rows):
            for w0 in range(0, W, wp.PC_PX):
                acc = np.zeros((rows, wp.PC_PX, co))
                for c0 in range(0, C, wp.PC_CK):
                    n = min(wp.PC_CK, C - c0)
                    # copy[r, p, ci] = x[h0 - 1 + r, c0 + ci, w0 - 1 + p]
                    copy = xp[b, h0:h0 + rows + 2, c0:c0 + n, w0:w0 + wp.PC_XPX]
                    copy = copy.transpose(0, 2, 1)
                    for r in range(rows):
                        for tap in range(9):
                            dy, dx = divmod(tap, 3)
                            a = copy[r + dy, dx:dx + wp.PC_PX]
                            acc[r] += a @ wpk[tap, :, c0:c0 + n].T
                for r in range(rows):
                    if h0 + r < H:
                        m = min(wp.PC_PX, W - w0)
                        out[b, h0 + r, :, w0:w0 + m] = acc[r, :m].T
    return out


@pytest.mark.parametrize("shape", [(1, 12, 24, 88, 32), (2, 10, 16, 80, 64),
                                   (1, 17, 40, 136, 32)])
def test_blockdot_tall_taps_equal_the_plain_conv(shape):
    """Integer-valued inputs make every sum exact: the 8-row tile's walk
    (ragged H, a part pixel tile, channels past C_in) equals the plain
    version exactly and stores each output once."""
    from smelter_tpu_torch.kernels.pixel_conv import pixel_conv_blockdot_plain

    B, H, C, W, co = shape
    rng = np.random.default_rng(4)
    x = rng.integers(-4, 5, (B, H, C, W)).astype(np.float64)
    wt = rng.integers(-3, 4, (co, C, 3, 3)).astype(np.float64)
    p = wp.pixel_tall_plan(B, H, W, C, co)
    assert p is not None and p.rows == wp.PC_TALL_R
    got = _tall_replay(x, wt, p.rows)
    want = pixel_conv_blockdot_plain(torch.from_numpy(x), torch.from_numpy(wt),
                                     torch.zeros(co, dtype=torch.float64)).numpy()
    assert not np.isnan(got).any() and np.array_equal(got, want)


# -- pixel_conv_patch on the wgmma core at flat NCHW strides (patch_plan) -------

PATCH_EDGES = [
    # (B, H, C_in, W, C_out, dtype, form): form 0 keeps rowdot's edges
    (1, 16, 64, 128, 64, "float32", "mma"),     # f32: its FMA kernel
    (1, 16, 64, 128, 40, "bfloat16", "mma"),    # C_out 40
    (1, 16, 64, 100, 32, "bfloat16", "mma"),    # W % 8
    (1, 16, 64, 72, 32, "float16", "mma"),      # W < 80: narrower than the box
    (2, 5, 64, 128, 32, "bfloat16", "mma"),     # H < 6
    (2, 7, 24, 100, 40, "bfloat16", "mma"),     # chip_smoke's odd shape
    (2, 7, 64, 88, 32, "bfloat16", "wgmma"),    # H 7: the 4-row tile
    (2, 12, 96, 88, 32, "bfloat16", "wgmma"),   # the 8-row tile, ragged H and W
    (1, 12, 96, 136, 64, "float16", "wgmma"),   # C_out 64: the 4-row tile
]


def _patch_plan(b, h, c, w, co, dtype):
    hw = h * w
    return wp.pixel_plan(b, h, w, c, co, (c * hw, w, hw), dtype, tall=True,
                         out_strides=(co * hw, w, hw))


@pytest.mark.parametrize("shape", ESRGAN)
def test_patch_plan_takes_the_wgmma_form_at_esrgans_shapes(shape):
    """Flat NCHW at batch 8: the wgmma form on blockdot's tile rule, the same
    plan as blockdot's NHCW one but for the strides; default out strides are
    contiguous NHCW, so rowdot's and blockdot's plans are unchanged."""
    b, h, c, w, co = shape
    p = _patch_plan(b, h, c, w, co, "bfloat16")
    assert p.form == "wgmma" and p == wp.pixel_plan(b, h, w, c, co, _strides(b, h, c, w),
                                                    "bfloat16", tall=True)
    assert p.rows == (wp.PC_TALL_R if wp.pixel_tall_takes(c, co) else wp.PC_R)
    assert wp.pixel_plan(b, h, w, c, co, _strides(b, h, c, w), "bfloat16") == wp.pixel_plan(
        b, h, w, c, co, _strides(b, h, c, w), "bfloat16", out_strides=(h * co * w, co * w, w))


@pytest.mark.parametrize("case", PATCH_EDGES)
def test_patch_plan_edges(case):
    b, h, c, w, co, dtype, form = case
    p = _patch_plan(b, h, c, w, co, dtype)
    assert p.form == form and (p.code == 0) == (form == "mma")
    # an out stride TMA cannot take sends even a good shape to form 0
    if form == "wgmma":
        hw = h * w
        assert wp.pixel_plan(b, h, w, c, co, (c * hw, w, hw), dtype, tall=True,
                             out_strides=(co * hw + 4, w, hw)).form == "mma"


@pytest.mark.parametrize("shape", [(2, 128, 64, 128, 32), (1, 128, 160, 128, 64),
                                   (1, 256, 64, 256, 64), (1, 512, 64, 512, 64),
                                   (2, 12, 96, 88, 32), (1, 7, 64, 136, 64)])
def test_patch_stores_every_output_once_at_nchw_strides(shape):
    """The wgmma form's TMA stores replayed at flat NCHW strides: each tile's
    rows leave as boxes of 64 pixels x C_out channels at (pixel, channel,
    row, image), clipped at W and H, each row channel's 128-byte run `hw`
    apart; the persistent CTAs' boxes write every element of (B, C_out,
    H * W) once."""
    B, H, C, W, co = shape
    p = _patch_plan(B, H, C, W, co, "bfloat16")
    assert p.form == "wgmma"
    hw = H * W
    osb, osh, osc = co * hw, W, hw
    written = np.zeros(B * co * hw, np.int32)
    rw = p.rows // wp.CONSUMERS
    row_blocks, pixel_tiles = wp.cdiv(H, p.rows), wp.cdiv(W, wp.PC_PX)
    chans = np.arange(co)[:, None] * osc
    for cta in range(p.grid):
        for tile in range(cta, p.tiles, p.grid):
            pt, rest = tile % pixel_tiles, tile // pixel_tiles
            h0, b = (rest % row_blocks) * p.rows, rest // row_blocks
            px = np.arange(pt * wp.PC_PX, min(W, pt * wp.PC_PX + wp.PC_PX))
            for wgi in range(wp.CONSUMERS):
                for r in range(rw):
                    h = h0 + wgi * rw + r
                    if h < H:
                        np.add.at(written, (b * osb + h * osh + chans + px[None, :]).ravel(), 1)
    assert (written == 1).all()
