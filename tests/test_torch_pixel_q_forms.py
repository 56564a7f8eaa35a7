"""The int8 wgmma form of `pixel_conv_rowdot_q` (`csrc/wgmma_conv_s8.cuh`),
replayed in plain PyTorch and numpy, and its plan (`wgmma_plan.pixel_plan`
for int8 x), checked without a card:

- the walk: tiles of 4 output rows x 64 pixels (H not a multiple of 4, W
  past a tile's edge), K steps of 32 channels, each step's 96-pixel TMA box
  from w0 - 16 (zeros outside the map and past C_in), the producer warps'
  copy of it into 16-channel rows (their 4-byte loads, `prmt` selectors and
  rotated stores replayed byte for byte), the taps as row offsets of that
  copy, exact int32 sums, then the epilogue: the emulation equals the
  Pallas `pixel_conv_rowdot_q` in interpret mode exactly, int8 and bf16
  out, and the port's plain version exactly;
- the producer's stores and the int8 staging stores have no bank
  conflicts beyond what 16-byte rows force;
- `pixel_plan` takes the form at ESRGAN's eight shapes (resident or
  streamed weight, stages, shared memory within 227 KB, the header's
  table) and keeps the shapes it cannot take on mma.sync.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smelter_tpu.kernels import pixel_conv as jpc
from smelter_tpu_torch.kernels import pixel_conv as pc
from smelter_tpu_torch.kernels import wgmma_plan as wp

CSRC = Path(__file__).resolve().parents[1] / "smelter_tpu_torch" / "csrc"
HEADER = (CSRC / "wgmma_conv_s8.cuh").read_text()
ESRGAN = [(8, 128, 64 + 32 * i, 128, 32 if i < 4 else 64) for i in range(5)] + [
    (8, s, 64, s, 64) for s in (128, 256, 512)]
QUADS = wp.PC_XPX // 4       # 4-pixel units a copy row
UNITS = wp.PC_XROWS * 2 * QUADS
TRANSPOSERS = 96             # producer warps 1-3


def _strides(b, h, c, w):
    return (h * c * w, c * w, w)


# -- the producer's copy -----------------------------------------------------------

def _byte_perm(x, y, s):
    """CUDA's __byte_perm on uint32 arrays: byte i of the result is byte
    (s >> 4i) & 7 of the 8 bytes {y, x} (x the low four)."""
    src = (np.asarray(y, np.uint64) << np.uint64(32)) | np.asarray(x, np.uint64)
    out = np.zeros(np.broadcast(x, y, s).shape, np.uint64)
    for i in range(4):
        sel = (np.asarray(s, np.uint64) >> np.uint64(4 * i)) & np.uint64(7)
        out |= ((src >> (sel * np.uint64(8))) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def _pair_sel(p, p2):
    return p | ((4 + p) << 4) | (p2 << 8) | ((4 + p2) << 12)


def _box(x: np.ndarray, w0: int, c0: int, h0: int, b: int) -> np.ndarray:
    """The TMA box of a step: (6 rows, 32 channels, 96 pixels) of the 4-D
    map (W, C_in, H, B) from (w0 - 16, c0, h0 - 1, b), zeros outside it."""
    B, H, C, W = x.shape
    box = np.zeros((wp.PC_XROWS, wp.PQ_CK, wp.PQ_RAWPX), np.int8)
    lo, hi = max(w0 - 16, 0), min(w0 - 16 + wp.PQ_RAWPX, W)
    for r in range(wp.PC_XROWS):
        hh = h0 - 1 + r
        if 0 <= hh < H and c0 < C:
            n = min(wp.PQ_CK, C - c0)
            box[r, :n, lo - (w0 - 16):hi - (w0 - 16)] = x[b, hh, c0:c0 + n, lo:hi]
    return box


def _copy(box: np.ndarray, written: np.ndarray | None = None) -> np.ndarray:
    """The producer warps' copy, (6 rows, 2 channel groups, 72 pixel rows,
    16 bytes): unit u takes copy rows 4q .. 4q + 3 (box pixels 4q + 12 ..) of
    group g of row r, 16 4-byte loads (a channel's 4 pixels each), two
    rotated pair selectors and four fixed ones, four 16-byte stores, slot i
    to pixel row 4q + ((i + (u >> 1)) & 3)."""
    raw = box.view(np.uint8).reshape(-1)
    u = np.arange(UNITS)
    q, gr = u % QUADS, u // QUADS
    g, r = gr & 1, gr >> 1
    src = (r * wp.PQ_CK + g * 16) * wp.PQ_RAWPX + 4 * q + 12
    v = np.zeros((UNITS, 16), np.uint32)
    for c in range(16):
        at = src + c * wp.PQ_RAWPX
        assert (at % 4 == 0).all()  # 4-byte loads
        v[:, c] = (raw[at].astype(np.uint32) | raw[at + 1].astype(np.uint32) << 8
                   | raw[at + 2].astype(np.uint32) << 16 | raw[at + 3].astype(np.uint32) << 24)
    rot = (u >> 1) & 3
    s01, s23 = _pair_sel(rot, (rot + 1) & 3), _pair_sel((rot + 2) & 3, (rot + 3) & 3)
    o = np.zeros((UNITS, 4, 4), np.uint32)
    for j in range(4):
        t0 = _byte_perm(v[:, 4 * j], v[:, 4 * j + 1], s01)
        t1 = _byte_perm(v[:, 4 * j], v[:, 4 * j + 1], s23)
        t2 = _byte_perm(v[:, 4 * j + 2], v[:, 4 * j + 3], s01)
        t3 = _byte_perm(v[:, 4 * j + 2], v[:, 4 * j + 3], s23)
        o[:, 0, j] = _byte_perm(t0, t2, 0x5410)
        o[:, 1, j] = _byte_perm(t0, t2, 0x7632)
        o[:, 2, j] = _byte_perm(t1, t3, 0x5410)
        o[:, 3, j] = _byte_perm(t1, t3, 0x7632)
    cp = np.zeros((wp.PC_XROWS, 2, wp.PC_XPX, 16), np.uint8)
    for i in range(4):
        p = 4 * q + ((i + rot) & 3)
        cp[r, g, p] = o[:, i].view(np.uint8).reshape(UNITS, 16)
        if written is not None:
            np.add.at(written, (r, g, p), 1)
    return cp.view(np.int8)


def test_copy_holds_each_pixel_row_once():
    """Every copy row is stored once, and row p of group g holds the 16
    channels 16g .. of box pixel p + 12 (pixel w0 - 4 + p) in order."""
    rng = np.random.default_rng(1)
    box = rng.integers(-128, 128, (wp.PC_XROWS, wp.PQ_CK, wp.PQ_RAWPX), dtype=np.int8)
    written = np.zeros((wp.PC_XROWS, 2, wp.PC_XPX), np.int64)
    cp = _copy(box, written)
    assert (written == 1).all()
    want = box.reshape(wp.PC_XROWS, 2, 16, wp.PQ_RAWPX)[..., 12:12 + wp.PC_XPX]
    assert np.array_equal(cp, want.transpose(0, 1, 3, 2))


def test_producer_stores_spread_over_the_banks():
    """Each warp's 16-byte store of slot i: a wavefront serves 8 lanes of
    distinct 16-byte bank groups, so 32 lanes need at least 4; the rotation
    by (u >> 1) & 3 keeps every store instruction at that (without it, 16)."""
    for it in range(wp.cdiv(UNITS, TRANSPOSERS)):
        for warp in range(TRANSPOSERS // 32):
            u = np.arange(32) + 32 * warp + TRANSPOSERS * it
            u = u[u < UNITS]
            if not len(u):
                continue
            q, gr = u % QUADS, u // QUADS
            for i in range(4):
                addr = ((gr * wp.PC_XPX + 4 * q) + ((i + (u >> 1)) & 3)) * 16
                groups = np.bincount((addr // 16) % 8, minlength=8)
                assert groups.max() <= 4, (it, warp, i, groups)


def test_int8_staging_stores_have_no_bank_conflict():
    """The int8 epilogue's byte stores into [C_out][64 pixels] with the
    64-byte swizzle: per store instruction (j, h, e) the lanes' words lie in
    distinct banks, or share a word."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    for co_n in (32, 64):
        for warp in range(4):
            for j in range(co_n // 8):
                for h in range(2):
                    for e in range(2):
                        co, px = 8 * j + 2 * t + e, 16 * warp + g + 8 * h
                        addr = co * 64 + (((px >> 4) ^ ((co >> 1) & 3)) << 4) + (px & 15)
                        words = np.unique(addr // 4)
                        assert len(np.unique(words % 32)) == len(words)


# -- the walk --------------------------------------------------------------------

def _pixel_q_emulation(x, w_q, scales, bias, *, alpha, inv_sy, requant, out_dtype):
    """pixel_conv_wgmma_s8's walk on numpy int8 x (B, H, C, W) and w_q (C_out,
    C_in, 3, 3): per tile (image, 4-row block, 64-pixel tile) and K step of
    32 channels the box and the producer's copy, each output row rr and tap
    (dy, dx) reading copy row rr + dy from pixel row dx + 3 (64 rows x 2
    groups x 16 channels, K-major), int32 sums; then the epilogue in two f32
    roundings, LeakyReLU, and requant (half to even, clipped) or one
    rounding to out_dtype; the store clips the tile to H and W."""
    B, H, C, W = x.shape
    co = w_q.shape[0]
    kt_n = wp.cdiv(C, wp.PQ_CK)
    wk = np.zeros((co, kt_n * wp.PQ_CK, 3, 3), np.int64)
    wk[:, :C] = w_q
    out = torch.empty(B, H, co, W, dtype=torch.int8 if requant else out_dtype)
    sc, bi = torch.from_numpy(scales).float(), torch.from_numpy(bias).float()
    for b in range(B):
        for h0 in range(0, H, wp.PC_R):
            for w0 in range(0, W, wp.PC_PX):
                acc = np.zeros((wp.PC_R, wp.PC_PX, co), np.int64)
                for kt in range(kt_n):
                    cp = _copy(_box(x, w0, kt * wp.PQ_CK, h0, b)).astype(np.int64)
                    for rr in range(wp.PC_R):
                        for tap in range(9):
                            dy, dx = divmod(tap, 3)
                            a = cp[rr + dy, :, dx + 3:dx + 3 + wp.PC_PX, :]  # (2, 64, 16)
                            a = a.transpose(1, 0, 2).reshape(wp.PC_PX, wp.PQ_CK)
                            bk = wk[:, kt * wp.PQ_CK:(kt + 1) * wp.PQ_CK, dy, dx]
                            acc[rr] += a @ bk.T
                assert np.abs(acc).max(initial=0) < 2 ** 31
                f = torch.from_numpy(acc.astype(np.int32)).float() * sc
                f = f + bi
                if alpha is not None:
                    f = torch.where(f >= 0, f, f * float(alpha))
                if requant:
                    f = torch.clamp(torch.round(f * float(inv_sy)), -127, 127).to(torch.int8)
                else:
                    f = f.to(out_dtype)
                rows, px = min(wp.PC_R, H - h0), min(wp.PC_PX, W - w0)
                out[b, h0:h0 + rows, :, w0:w0 + px] = f[:rows, :px].permute(0, 2, 1)
    return out


def _operands(geom, seed, pow2_scales: bool):
    B, H, C, W, co = geom
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (B, H, C, W), dtype=np.int8)
    wq = rng.integers(-127, 128, (co, C, 3, 3), dtype=np.int8)
    if pow2_scales:
        scales = np.exp2(-rng.integers(12, 16, co)).astype(np.float32)
    else:
        scales = (0.02 * rng.uniform(0.001, 0.01, co)).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    return xq, wq, scales, bias


# (B, H, C_in, W, C_out): H 7, 6 and 9 (not multiples of 4), W past a tile's
# edge, C_in past the last 32-channel step
GEOMS = [(2, 7, 48, 112, 32), (1, 6, 64, 96, 64), (1, 9, 96, 80, 32)]
EPIS = [("int8", dict(requant=True, inv_sy=1 / 0.05)),
        ("bf16", dict(requant=False, out_dtype=torch.bfloat16))]


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("epi", [e[0] for e in EPIS])
@pytest.mark.parametrize("alpha", [None, 0.2])
def test_pixel_q_emulation_equals_pallas(geom, epi, alpha):
    """The emulated walk equals `pixel_conv_rowdot_q` in interpret mode
    exactly, int8 and bf16 out. The scales are powers of two, so acc * scale
    is exact and XLA's contraction of acc * scale + bias into one fused
    multiply-add on the CPU rounds as the kernel's two operations do."""
    ekw = dict(EPIS)[epi]
    xq, wq, scales, bias = _operands(geom, sum(geom), pow2_scales=True)
    got = _pixel_q_emulation(xq, wq, scales, bias, alpha=alpha, inv_sy=ekw.get("inv_sy", 1.0),
                             requant=ekw["requant"],
                             out_dtype=ekw.get("out_dtype", torch.bfloat16))
    want = jpc.pixel_conv_rowdot_q(*(jnp.asarray(a) for a in (xq, wq, scales, bias)),
                                   alpha=alpha, inv_sy=ekw.get("inv_sy", 1.0),
                                   requant=ekw["requant"], out_dtype=jnp.bfloat16,
                                   rows=geom[1], interpret=True)
    want = np.asarray(want if epi == "int8" else want.astype(jnp.float32))
    assert tuple(got.shape) == want.shape
    if epi == "int8":
        assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)
        assert len(np.unique(want)) > 50
    else:
        assert got.dtype == torch.bfloat16 and np.array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("geom", GEOMS[:2])
@pytest.mark.parametrize("out", ["int8", "bfloat16", "float16"])
def test_pixel_q_emulation_equals_the_plain_version(geom, out):
    """With scales of any value the emulated walk equals the plain version
    (the wrapper's CPU path) exactly: both round acc * scale and + bias
    separately."""
    xq, wq, scales, bias = _operands(geom, 7 + sum(geom), pow2_scales=False)
    kw = dict(alpha=0.2, inv_sy=1 / 0.05, requant=out == "int8",
              out_dtype=getattr(torch, out) if out != "int8" else torch.bfloat16)
    got = _pixel_q_emulation(xq, wq, scales, bias, **kw)
    plain = pc.pixel_conv_rowdot_q(*(torch.from_numpy(a) for a in (xq, wq, scales, bias)), **kw)
    assert torch.equal(got, plain) and pc.q_launches == 0


# -- the plan --------------------------------------------------------------------

@pytest.mark.parametrize("shape", ESRGAN)
@pytest.mark.parametrize("out", ["int8", "bfloat16"])
def test_pixel_plan_takes_the_int8_form_at_esrgans_shapes(shape, out):
    """All eight shapes, int8 and bf16 out: the wgmma form, the weight
    resident but at 192 -> 64 (3 stages would be left), at least 3 stages,
    shared memory within the 227 KB a block may have, every tile once."""
    b, h, c, w, co = shape
    p = wp.pixel_plan(b, h, w, c, co, _strides(b, h, c, w), "int8", out_dtype=out)
    ob = 1 if out == "int8" else 2
    assert (p.form, p.code, p.rows, p.px) == ("wgmma", 2 if p.resident else 1, 4, 64)
    assert p.resident == ((c, co) != (192, 64))
    assert p.stages >= (wp.PC_RES_STAGES if p.resident else 3)
    assert p.smem == (wp.pixel_resident_smem(c, co, True, ob) if p.resident
                      else wp.pixel_smem(co, True, ob))
    assert p.smem <= wp.SMEM_LIMIT
    assert p.tiles == b * wp.cdiv(h, 4) * wp.cdiv(w, 64) and p.grid == min(p.tiles, wp.SMS)
    taken = sorted(t for cta in range(p.grid) for t in range(cta, p.tiles, p.grid))
    assert taken == list(range(p.tiles))


Q_EDGES = [
    # (B, H, C_in, W, C_out, out, form, resident)
    (1, 16, 64, 72, 32, "int8", "mma", False),       # W 72: narrower than the 96-pixel box
    (1, 16, 64, 80, 32, "int8", "mma", False),
    (1, 16, 64, 96, 32, "int8", "wgmma", True),
    (1, 16, 64, 104, 32, "int8", "mma", False),      # W 104: rows of 104 bytes
    (2, 7, 48, 112, 32, "int8", "wgmma", False),     # C_in 48: one chunk's box past it
    (1, 5, 64, 128, 64, "int8", "mma", False),       # H 5: fewer rows than the box
    (1, 6, 64, 128, 64, "bfloat16", "wgmma", True),
    (1, 16, 24, 128, 32, "int8", "mma", False),      # C_in 24: no 16-byte weight rows
    (1, 16, 16, 128, 32, "int8", "mma", False),      # C_in 16: narrower than the box
    (1, 16, 32, 128, 32, "float16", "wgmma", False),
    (1, 16, 208, 160, 32, "int8", "wgmma", True),    # 4 chunks, the last half zeros
    (1, 16, 64, 128, 48, "int8", "mma", False),      # C_out outside {32, 64}
    (1, 16, 64, 128, 3, "bfloat16", "mma", False),
    (1, 16, 64, 128, 64, "float32", "mma", False),   # f32 out keeps mma.sync
]


@pytest.mark.parametrize("case", Q_EDGES)
def test_pixel_plan_int8_edges(case):
    b, h, c, w, co, out, form, resident = case
    p = wp.pixel_plan(b, h, w, c, co, _strides(b, h, c, w), "int8", out_dtype=out)
    assert (p.form, p.resident) == (form, resident)
    if form == "mma":
        assert (p.code, p.smem, p.rows, p.px) == (0, 0, 2, 128)
    else:
        assert p.smem <= wp.SMEM_LIMIT and p.stages >= 3


def test_pixel_plan_int8_strides_and_bases(monkeypatch):
    b, h, c, w = 2, 16, 64, 128
    s = _strides(b, h, c, w)
    assert wp.pixel_plan(b, h, w, c, 32, s, "int8", out_dtype="int8").form == "wgmma"
    assert wp.pixel_plan(b, h, w, c, 32, s, "int8", out_dtype="int8",
                         aligned=False).form == "mma"
    # a channel stride of W + 8: rows 8 bytes off a 16-byte boundary
    assert wp.pixel_plan(b, h, w, c, 32, (h * c * (w + 8), c * (w + 8), w + 8), "int8",
                         out_dtype="int8").form == "mma"
    assert wp.pixel_plan(b, h, w, c, 32, (h * c * (w + 16), c * (w + 16), w + 16), "int8",
                         out_dtype="int8").form == "wgmma"
    # a bf16 x never takes the int8 form's sizes, nor an int8 x the 16-bit one's
    bf = wp.pixel_plan(b, h, w, c, 32, s, "bfloat16")
    q8 = wp.pixel_plan(b, h, w, c, 32, s, "int8", out_dtype="int8")
    assert (bf.smem, bf.stages) == (wp.pixel_resident_smem(c, 32), 5)
    assert (q8.smem, q8.stages) == (wp.pixel_resident_smem(c, 32, True, 1), 6)
    # the wrapper's plan reads out's dtype, else out_dtype
    monkeypatch.setattr(pc._build, "sms", lambda device: wp.SMS)
    x = torch.zeros(b, h, c, w, dtype=torch.int8)
    wq = torch.zeros(32, c, 3, 3, dtype=torch.int8)
    assert pc.plan(x, wq, out_dtype=torch.float32).form == "mma"
    assert pc.plan(x, wq, torch.zeros(b, h, 32, w, dtype=torch.bfloat16)).form == "wgmma"


def test_pixel_plan_int8_constants_are_the_headers():
    nums = dict(re.findall(r"constexpr int (PQ_CK|PQ_RAWPX|PQ_XPX|PQ_CHUNK) = (\d+);", HEADER))
    assert {k: int(v) for k, v in nums.items()} == {
        "PQ_CK": wp.PQ_CK, "PQ_RAWPX": wp.PQ_RAWPX, "PQ_XPX": wp.PC_XPX,
        "PQ_CHUNK": wp.PQ_CHUNK}
    for co, q8, b16 in ((64, 4, 3), (32, 5, 5)):
        assert (wp.pixel_stages(co, True, 1), wp.pixel_stages(co, True, 2)) == (q8, b16)
        assert re.search(rf"C_out {co}, int8 out: {q8} stages, {wp.pixel_smem(co, True, 1):,}; "
                         rf"16-bit out: {b16} stages, {wp.pixel_smem(co, True, 2):,}", HEADER)
        assert max(wp.pixel_smem(co, True, 1), wp.pixel_smem(co, True, 2)) <= wp.SMEM_LIMIT
    for c_in, co, stages in ((64, 32, 6), (160, 32, 5), (64, 64, 5)):
        assert wp.pixel_resident_stages(c_in, co, True, 1) == stages
        assert re.search(rf"resident, C_in {c_in} -> C_out {co}, int8 out: {stages} stages, "
                         rf"{wp.pixel_resident_smem(c_in, co, True, 1):,}", HEADER)
    assert wp.pixel_resident(192, 64, True) == 3 * (110_592 // 3 + 8)
    assert wp.pixel_resident_stages(192, 64, True, 1) == 3
