"""The shape-to-form choices of `int8_matmul` (`wgmma_plan.int8_plan`) and
of 16-bit `pixel_conv_rowdot` (`wgmma_plan.pixel_plan`), and numpy replays
of what their wgmma forms do with a plan, checked without a card:

- every output tile and K range is taken exactly once, clusters have at
  most 8 CTAs, shared memory fits and the plans' constants are the
  headers' (`csrc/wgmma_gemm.cuh`, `csrc/wgmma_conv.cuh`);
- the int8 tma form's register A fragment, gathered by each consumer thread
  from the TMA-loaded, swizzled W box with 2-byte loads and byte permutes,
  equals the mma.m16n8k32 fragment of W^T (with the kernel's column
  pairing), no load has a bank conflict, and the epilogue's pairs store
  every output once;
- the pixel form's TMA box of an NHCW map (zeros at rows -1 and H, pixels
  -1 and W and channels past C_in) and the producer's K-major copy of it,
  read tap by tap at row offset dx and multiplied out in float64, equal
  `pixel_conv_rowdot_plain` exactly on integer inputs.

A pure-Python replay, so no card is needed."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from smelter_tpu_torch.kernels import wgmma_plan as wp
from smelter_tpu_torch.kernels.pixel_conv import pixel_conv_rowdot_plain

CSRC = Path(__file__).resolve().parents[1] / "smelter_tpu_torch" / "csrc"
GEMM_HEADER = (CSRC / "wgmma_gemm.cuh").read_text()
CONV_HEADER = (CSRC / "wgmma_conv.cuh").read_text()

HEAD, SERVING = (128, 1000, 2048), (8192, 4096, 4096)  # (M, N, K)
INT8_EDGES = [(m, n, k) for m in (1, 17, 128, 129, 8192) for n in (8, 16, 1000, 4096)
              for k in (16, 32, 100, 2048)]
# ESRGAN x4's eight PixelConv shapes at batch 8: (B, H, C_in, W, C_out)
ESRGAN = [(8, 128, 64 + 32 * i, 128, 32 if i < 4 else 64) for i in range(5)] + [
    (8, s, 64, s, 64) for s in (128, 256, 512)]


def _nhcw_strides(b, h, c, w):
    return (h * c * w, c * w, w)


# -- int8_plan -----------------------------------------------------------------

def _walk_int8(p: wp.Plan, M: int, N: int, K: int) -> None:
    """Replays the kernels' indexing: each (tile, K row) summed once."""
    mt, nt = wp.cdiv(M, p.bm), wp.cdiv(N, p.bn)
    if p.form == "tma":
        taken = [t for b in range(p.grid) for t in range(b, mt * nt, p.grid)]
        assert sorted(taken) == list(range(mt * nt))
        assert p.k_chunk == K and p.split == 1 and p.grid <= wp.SMS
        return
    assert p.form == "cluster" and p.grid == mt * nt * p.split
    assert p.k_chunk % wp.S8_BK == 0 and p.k_chunk > 0
    ranges = [(z * p.k_chunk, min(K, (z + 1) * p.k_chunk)) for z in range(p.split)]
    assert [k for lo, hi in ranges for k in range(lo, hi)] == list(range(K))
    assert all(hi > lo for lo, hi in ranges)  # no rank without K rows
    rows = [r for rank in range(p.split)
            for r in range(rank * p.bm // p.split, (rank + 1) * p.bm // p.split)]
    assert rows == list(range(p.bm))


@pytest.mark.parametrize("M,N,K", INT8_EDGES + [HEAD, SERVING])
@pytest.mark.parametrize("aligned", [True, False])
def test_int8_plan_covers_every_tile_and_k_row_once(M, N, K, aligned):
    p = wp.int8_plan(M, N, K, aligned=aligned)
    _walk_int8(p, M, N, K)
    assert 1 <= p.split <= wp.MAX_CLUSTER and p.smem <= wp.SMEM_LIMIT
    if not aligned:
        assert p.form == "cluster"
    if p.form == "tma":
        assert K % 16 == 0 and N % 16 == 0 and min(M, N, K) >= 128
        assert (p.bm, p.bn) == (128, 128) and wp.cdiv(M, 128) * wp.cdiv(N, 128) >= wp.SMS // 2
    else:
        assert (p.bm, p.bn) == (128, 64)


def test_int8_plan_at_the_paths_shapes():
    """The head splits K over clusters of 8 (16 N tiles x 8 = 128 CTAs, two
    K steps of 128 bytes each); the serving GEMM takes the persistent TMA
    kernel, one CTA an SM over 64 x 32 tiles; fewer SMs, a smaller split."""
    head = wp.int8_plan(*HEAD)
    assert (head.form, head.split, head.k_chunk, head.grid, head.code) == (
        "cluster", 8, 256, 128, 2)
    serving = wp.int8_plan(*SERVING)
    assert (serving.form, serving.bm, serving.bn, serving.grid, serving.code) == (
        "tma", 128, 128, 132, 1)
    assert wp.int8_plan(*HEAD, sms=64).split == 4
    assert wp.int8_plan(*SERVING, aligned=False).form == "cluster"
    assert wp.int8_plan(8192, 4104, 4096).form == "cluster"  # N % 16
    assert wp.int8_plan(8192, 4096, 4100).form == "cluster"  # K % 16


def test_int8_plan_constants_are_the_headers():
    assert re.search(r"constexpr int S8_BK = 128;", GEMM_HEADER) and wp.S8_BK == 128
    assert wp.int8_stages() == 7
    assert re.search(rf"int8 tma form: .*: {wp.int8_stages()} stages, {wp.INT8_TMA_SMEM:,}",
                     GEMM_HEADER)
    assert re.search(rf"int8 cluster form: 3 stages of 16,384 \+ 8,192, "
                     rf"{wp.INT8_CLUSTER_SMEM:,}", GEMM_HEADER)
    assert wp.INT8_TMA_SMEM == 1024 + 7 * (2 * 128 * 128 + 16) <= wp.SMEM_LIMIT


# -- the int8 tma form's A fragment -----------------------------------------------

def _byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's __byte_perm(x, y, s) (default mode)."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(s >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _swizzled_box(rows: np.ndarray) -> np.ndarray:
    """A (K rows, 128 bytes) box as TMA lays it out with the 128-byte
    swizzle: row k at k * 128, 16-byte chunk c at (c ^ (k & 7)) * 16."""
    box = np.zeros(rows.size, np.uint8)
    for k in range(rows.shape[0]):
        for c in range(8):
            o = k * 128 + ((c ^ (k & 7)) << 4)
            box[o:o + 16] = rows[k, 16 * c:16 * c + 16]
    return box


def test_int8_register_fragment_is_w_transposed():
    """Every consumer thread of gemm_tma_s8, replayed on one K step of a
    random W box: its a[kk][0..3] are the m16n8k32 A fragment of W^T, A row
    g of warp w's 16 being W column wg * 64 + 16 w + 2g and row g + 8 the
    next column; each 2-byte load instruction's 32 lanes touch 32 distinct
    banks or share a word."""
    rng = np.random.default_rng(0)
    w = rng.integers(-128, 128, (128, 128), dtype=np.int64).astype(np.int8)  # (K step, N tile)
    box = _swizzled_box(w.view(np.uint8))
    for wgi in range(2):
        for warp in range(4):
            loads = {}  # (kk, half, i) -> [byte offsets of the 32 lanes]
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                nb = wgi * 64 + warp * 16 + 2 * g
                rot = sum(((i - t) & 3) << (4 * i) for i in range(4))
                for kk in range(4):
                    for half in range(2):
                        h = []
                        for i in range(4):
                            k = kk * 32 + half * 16 + 4 * t + ((i + t) & 3)
                            o = k * 128 + (((nb >> 4) ^ (k & 7)) << 4) + (nb & 15)
                            loads.setdefault((kk, half, i), []).append(o)
                            h.append(int(box[o]) | int(box[o + 1]) << 8)
                        p01, p23 = _byte_perm(h[0], h[1], 0x5410), _byte_perm(h[2], h[3], 0x5410)
                        lo = _byte_perm(_byte_perm(p01, p23, 0x6420), 0, rot)
                        hi = _byte_perm(_byte_perm(p01, p23, 0x7531), 0, rot)
                        k0 = kk * 32 + 16 * half + 4 * t
                        want_lo = w[k0:k0 + 4, nb].view(np.uint8)  # A row g: column nb
                        want_hi = w[k0:k0 + 4, nb + 1].view(np.uint8)  # A row g + 8
                        assert lo.to_bytes(4, "little") == want_lo.tobytes()
                        assert hi.to_bytes(4, "little") == want_hi.tobytes()
            for offs in loads.values():
                words = {o // 4 for o in offs}
                assert len({wd % 32 for wd in words}) == len(words)  # no bank conflict


def test_int8_tma_epilogue_stores_every_output_once():
    """acc[4j + 2h + e] holds W column n0 + nb + h, x row m0 + 8j + 2t + e:
    the pairs (nb, nb + 1) of the 256 consumer threads cover a 128 x 128
    tile once."""
    stored = np.zeros((128, 128), np.int64)  # (x row, W column)
    for ct in range(256):
        wgi, warp, lane = ct >> 7, (ct >> 5) & 3, ct & 31
        g, t = lane >> 2, lane & 3
        nb = wgi * 64 + warp * 16 + 2 * g
        for j in range(16):
            for e in range(2):
                stored[8 * j + 2 * t + e, nb:nb + 2] += 1
    assert (stored == 1).all()


# -- pixel_plan ------------------------------------------------------------------

@pytest.mark.parametrize("shape", ESRGAN)
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_pixel_plan_takes_the_wgmma_form_at_esrgans_shapes(shape, dtype):
    b, h, c, w, co = shape
    p = wp.pixel_plan(b, h, w, c, co, _nhcw_strides(b, h, c, w), dtype)
    assert (p.form, p.code, p.rows, p.px) == ("wgmma", 2 if p.resident else 1, 4, 64)
    assert p.tiles == b * wp.cdiv(h, 4) * wp.cdiv(w, 64) and p.grid == min(p.tiles, wp.SMS)
    assert p.smem == (wp.pixel_resident_smem(c, co) if p.resident else wp.pixel_smem(co))
    assert p.smem <= wp.SMEM_LIMIT and p.stages >= 3
    # the persistent CTAs take every (image, row block, pixel tile) once
    taken = sorted(t for cta in range(p.grid) for t in range(cta, p.tiles, p.grid))
    assert taken == list(range(p.tiles))


PIXEL_EDGES = [
    # (B, H, C_in, W, C_out, dtype, form)
    (1, 16, 64, 7, 32, "bfloat16", "mma"),      # W 7: no 16-byte rows
    (1, 16, 64, 100, 32, "bfloat16", "mma"),    # W 100: rows of 200 bytes
    (1, 16, 64, 131, 32, "bfloat16", "mma"),
    (1, 16, 64, 64, 32, "bfloat16", "mma"),     # W 64: narrower than x's 80-pixel box
    (1, 16, 64, 80, 32, "bfloat16", "wgmma"),
    (2, 7, 16, 88, 64, "float16", "wgmma"),     # a ragged pixel tile and row block
    (1, 1, 64, 128, 32, "bfloat16", "mma"),     # H 1 and 3: fewer rows than x's box
    (1, 3, 64, 128, 32, "bfloat16", "mma"),
    (1, 6, 64, 128, 32, "bfloat16", "wgmma"),
    (1, 16, 5, 128, 32, "bfloat16", "mma"),     # C_in 5: the weight's rows
    (1, 16, 8, 128, 32, "bfloat16", "mma"),     # C_in 8: one channel group, the box takes 2
    (1, 16, 24, 128, 32, "bfloat16", "wgmma"),  # C_in 24: the box's zeros past it
    (1, 16, 96, 128, 32, "bfloat16", "wgmma"),
    (1, 16, 160, 128, 32, "float16", "wgmma"),
    (1, 16, 64, 128, 3, "bfloat16", "mma"),     # C_out outside {32, 64}
    (1, 16, 64, 128, 8, "bfloat16", "mma"),
    (1, 16, 64, 128, 72, "bfloat16", "mma"),
    (1, 16, 64, 128, 64, "float32", "mma"),     # f32 keeps its FMA kernel
]


@pytest.mark.parametrize("case", PIXEL_EDGES)
def test_pixel_plan_edges(case):
    b, h, c, w, co, dtype, form = case
    p = wp.pixel_plan(b, h, w, c, co, _nhcw_strides(b, h, c, w), dtype)
    assert p.form == form
    if form == "mma":
        assert p.code == 0 and p.smem == 0
        assert (p.rows, p.px) == ((1, 64) if dtype == "float32" else (2, 128))
    else:
        assert p.smem <= wp.SMEM_LIMIT and p.stages >= 3


def test_pixel_plan_strides_and_bases():
    b, h, c, w = 2, 16, 64, 128
    s = _nhcw_strides(b, h, c, w)
    assert wp.pixel_plan(b, h, w, c, 32, s, "bfloat16").form == "wgmma"
    assert wp.pixel_plan(b, h, w, c, 32, s, "bfloat16", aligned=False).form == "mma"
    # a channel stride of W + 4: rows 8 bytes off a 16-byte boundary
    assert wp.pixel_plan(b, h, w, c, 32, (h * c * (w + 4), c * (w + 4), w + 4),
                         "bfloat16").form == "mma"
    # a strided view whose strides are 16-byte multiples is read in place
    assert wp.pixel_plan(b, h, w, c, 32, (2 * h * c * w, 2 * c * w, 2 * w),
                         "bfloat16").form == "wgmma"
    assert wp.pixel_plan(8, 128, 128, 64, 32, _nhcw_strides(8, 128, 64, 128), "bfloat16",
                         sms=64).grid == 64


def test_pixel_plan_constants_are_the_headers():
    nums = dict(re.findall(r"constexpr int (PC_PX|PC_CK|PC_RW|PC_XPX|PC_RAWPX) = (\d+);",
                           CONV_HEADER))
    assert {k: int(v) for k, v in nums.items()} == {
        "PC_PX": wp.PC_PX, "PC_CK": wp.PC_CK, "PC_RW": wp.PC_RW, "PC_XPX": wp.PC_XPX,
        "PC_RAWPX": wp.PC_RAWPX}
    for co, stages in ((64, 4), (32, 5)):
        assert wp.pixel_stages(co) == stages
        assert re.search(rf"C_out {co}: {stages} stages, {wp.pixel_smem(co):,}", CONV_HEADER)
    assert wp.pixel_smem(64) == 1024 + 4 * (15_360 + 14_336 + 9 * 64 * 32 + 24) + 2 * 2 * 64 * 128
    assert wp.pixel_smem(64) <= wp.SMEM_LIMIT
    for c_in, co, stages in ((64, 32, 5), (160, 32, 3), (64, 64, 4)):
        assert wp.pixel_resident_stages(c_in, co) == stages
        assert re.search(rf"resident, C_in {c_in} -> C_out {co}: {stages} stages, "
                         rf"{wp.pixel_resident_smem(c_in, co):,}", CONV_HEADER)
        assert wp.pixel_resident_smem(c_in, co) <= wp.SMEM_LIMIT


def test_pixel_plan_keeps_the_weight_resident_where_it_fits():
    """ESRGAN's C_out 32 convs up to C_in 128 and its 64 -> 64 ones hold the
    whole weight in shared memory, in 64-channel chunks (zeros past C_in),
    with 4 or 5 stages beside it; the 160 -> 32 conv (3 stages would be
    left) and the 192 -> 64 one (221 KB) bring a step's with each stage."""
    plans = [wp.pixel_plan(b, h, w, c, co, _nhcw_strides(b, h, c, w), "bfloat16")
             for b, h, c, w, co in ESRGAN]
    assert [p.resident for p in plans] == [True] * 3 + [False] * 2 + [True] * 3
    assert [p.code for p in plans] == [2] * 3 + [1] * 2 + [2] * 3
    assert all(p.stages >= wp.PC_RES_STAGES for p in plans if p.resident)
    assert wp.pixel_plan(1, 16, 128, 24, 32, _nhcw_strides(1, 16, 24, 128),
                         "bfloat16").resident
    assert wp.pixel_resident(192, 64) == 3 * (9 * 64 * 128 + 8)
    assert wp.pixel_resident_stages(192, 64) == 0


# -- the pixel form's producer and taps -------------------------------------------

def _box(x: np.ndarray, w0: int, c0: int, h0: int, b: int) -> np.ndarray:
    """What the TMA unit writes for a step's x box, (R + 2 rows, 16
    channels, 80 pixels) of the 4-D map (W, C_in, H, B) at (w0 - 8, c0, h0 -
    1, b): zeros at every coordinate outside the map."""
    B, H, C, W = x.shape
    box = np.zeros((wp.PC_XROWS, wp.PC_CK, wp.PC_RAWPX))
    for r in range(wp.PC_XROWS):
        hh = h0 - 1 + r
        for ci in range(wp.PC_CK):
            if 0 <= hh < H and c0 + ci < C:
                lo, hi = max(w0 - 8, 0), min(w0 - 8 + wp.PC_RAWPX, W)
                box[r, ci, lo - (w0 - 8):hi - (w0 - 8)] = x[b, hh, c0 + ci, lo:hi]
    return box


def _copy(box: np.ndarray) -> np.ndarray:
    """The producer's K-major copy of a box: (R + 2 rows, 2 channel groups,
    PC_XPX pixel rows, 8 channels), thread (r, g, p) gathering box pixel
    p + 7 (pixel w0 - 1 + p) of channels 8g .. 8g + 7."""
    cp = np.empty((wp.PC_XROWS, 2, wp.PC_XPX, 8))
    for u in range(wp.PC_XROWS * 2 * wp.PC_XPX):
        p, g, r = u % wp.PC_XPX, (u // wp.PC_XPX) & 1, u // (2 * wp.PC_XPX)
        cp[r, g, p] = box[r, 8 * g:8 * g + 8, p + 7]
    return cp


def _replay_pixel_form(x, wt, p: wp.PixelPlan) -> np.ndarray:
    """The kernel's sums in float64: tile (b, row block, pixel tile), K steps
    of 16 channels, per step the producer's copy and 9 taps x 4 rows of
    A (64 pixel rows from row dx of input row r + dy's copy, 16 channels) @
    B (the tap's weights, 16 x C_out)."""
    B, H, C, W = x.shape
    co = wt.shape[0]
    wpk = np.transpose(wt, (2, 3, 0, 1)).reshape(9, co, C)  # [tap][co][ci]
    out = np.full((B, H, co, W), np.nan)
    rb, pt_n = wp.cdiv(H, p.rows), wp.cdiv(W, p.px)
    for tile in range(p.tiles):
        pt, rest = tile % pt_n, tile // pt_n
        h0, b = (rest % rb) * p.rows, rest // rb
        acc = np.zeros((p.rows, wp.PC_PX, co))
        for kt in range(wp.cdiv(C, wp.PC_CK)):
            cp = _copy(_box(x, pt * wp.PC_PX, kt * wp.PC_CK, h0, b))
            wk = np.zeros((9, co, wp.PC_CK))
            n = min(wp.PC_CK, C - kt * wp.PC_CK)
            wk[:, :, :n] = wpk[:, :, kt * wp.PC_CK:kt * wp.PC_CK + n]
            for r in range(p.rows):
                for tap in range(9):
                    dy, dx = divmod(tap, 3)
                    a = cp[r + dy, :, dx:dx + wp.PC_PX, :]  # (2 groups, 64 pixels, 8)
                    a = a.transpose(1, 0, 2).reshape(wp.PC_PX, wp.PC_CK)
                    acc[r] += a @ wk[tap].T
        for r in range(p.rows):  # the TMA store clips rows past H and pixels past W
            h = h0 + r
            if h < H:
                n = min(wp.PC_PX, W - pt * wp.PC_PX)
                out[b, h, :, pt * wp.PC_PX:pt * wp.PC_PX + n] = acc[r, :n].T
    return out


@pytest.mark.parametrize("shape", [(2, 7, 24, 88, 32), (1, 6, 16, 80, 64), (1, 9, 40, 136, 32)])
def test_pixel_producer_and_taps_equal_the_plain_conv(shape):
    """Integer-valued inputs make every sum exact: the replay (padding and
    channels past C_in from the producer's zeros) equals the plain version
    (bias 0, no LeakyReLU) exactly, and stores each output once."""
    B, H, C, W, co = shape
    rng = np.random.default_rng(3)
    x = rng.integers(-4, 5, (B, H, C, W)).astype(np.float64)
    wt = rng.integers(-3, 4, (co, C, 3, 3)).astype(np.float64)
    p = wp.pixel_plan(B, H, W, C, co, _nhcw_strides(B, H, C, W), "bfloat16")
    assert p.form == "wgmma"
    got = _replay_pixel_form(x, wt, p)
    want = pixel_conv_rowdot_plain(torch.from_numpy(x), torch.from_numpy(wt),
                                   torch.zeros(co, dtype=torch.float64)).numpy()
    assert not np.isnan(got).any() and np.array_equal(got, want)


def test_pixel_producer_units_cover_the_copy_once():
    """The 96 transposing threads' 9 units a stage write every (row, group,
    pixel row) of the copy once, and read box pixels 7 .. 78 only."""
    seen = np.zeros((wp.PC_XROWS, 2, wp.PC_XPX), np.int64)
    for tt in range(96):
        for k in range(9):
            u = tt + 96 * k
            p, g, r = u % wp.PC_XPX, (u // wp.PC_XPX) & 1, u // (2 * wp.PC_XPX)
            seen[r, g, p] += 1
            assert 0 <= p + 7 < wp.PC_RAWPX
    assert (seen == 1).all()
