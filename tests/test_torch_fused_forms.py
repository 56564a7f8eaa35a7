"""`dequant_matmul_int8_fused`'s and `_fused2`'s forms (`csrc/
int8_matmul_fused.cu`, `wgmma_plan.fused_plan` and `revisit_plan`: three on
int8 wgmma, and the mma.sync kernel) checked without a card: the plan covers
every (row, K element, column) once, with the cluster's K chunks in rank
order and each output stored by one rank; the plan's constants are the
source's; a replay of each form's schedule (x quantized as it loads, box by
box, with IEEE division and rounding half to even; int32 partial sums a K
chunk, summed in rank order; the two f32 multiplies; one rounding) is
bit-equal to the Pallas `_int8_matmul_fused_impl` in interpret mode; and the
revisit form's bracketed quantizer, replayed in numpy, equals
`quantize_rows` on random rows and on values at and beside every tie."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smelter_tpu.kernels import int8_matmul as jim
from smelter_tpu_torch.kernels import int8_matmul as im
from smelter_tpu_torch.kernels import wgmma_plan as wp
from torch_fused_ties import tie_rows

SOURCE = (Path(__file__).resolve().parents[1] / "smelter_tpu_torch" / "csrc"
          / "int8_matmul_fused.cu").read_text()


def _panel_units(p, M, N, clusters):
    """The panel form's work units (panel, N tile), tiles fastest, split
    evenly over `clusters` persistent clusters as the kernel splits them:
    yields (cluster, m0, n0, fresh), fresh where the cluster quantizes a
    panel (its first unit, or a panel's first)."""
    nt = wp.cdiv(N, wp.TMA_BN)
    units = wp.cdiv(M, wp.BM) * nt
    assert p.grid == units
    for c in range(clusters):
        u0, u1 = units * c // clusters, units * (c + 1) // clusters
        for u in range(u0, u1):
            yield c, u // nt * wp.BM, u % nt * wp.TMA_BN, u == u0 or u % nt == 0


def _units(p, M, N, K, clusters=3):
    """(rows, K range, columns) of each CTA's sums and the rows it stores:
    yields (m0, m1, k0, k1, n0, n1, store_m0, store_m1)."""
    if p.form == "panel":
        for _, m0, n0, _ in _panel_units(p, M, N, clusters):
            for r in range(p.split):
                k0, k1 = r * p.k_chunk, min(K, (r + 1) * p.k_chunk)
                own = (m0 + wp.BM * r // p.split, m0 + wp.BM * (r + 1) // p.split)
                yield m0, min(M, m0 + wp.BM), k0, k1, n0, min(N, n0 + wp.TMA_BN), *own
    elif p.form in ("revisit", "mma"):  # a 128 x cols tile, all of K
        for m0 in range(0, M, wp.BM):
            for n0 in range(0, N, p.cols):
                yield m0, min(M, m0 + wp.BM), 0, K, n0, min(N, n0 + p.cols), m0, m0 + wp.BM
    else:
        for m0 in range(0, M, wp.BM):
            for n0 in range(0, N, wp.CL_BN):
                for r in range(p.split):
                    k0, k1 = r * p.k_chunk, min(K, (r + 1) * p.k_chunk)
                    own = (m0 + wp.BM * r // p.split, m0 + wp.BM * (r + 1) // p.split)
                    yield m0, min(M, m0 + wp.BM), k0, k1, n0, min(N, n0 + wp.CL_BN), *own


# (M, N, K, x bytes, sms, form, split): the plan's choices at small sizes
# (`sms` small so that few units fill "the card"; at 12, 2 units are enough
# for 8 ranks and not for 4), ragged M and N tiles, a last rank's short K chunk,
# N % 16 with tiles enough for the mma.sync kernel, and K the panel's chunks
# do not fit (the revisit form: 256-column tiles, and 128 where N is narrower)
COVER = [(200, 144, 1000, 2, 2, "panel", 4), (256, 272, 1200, 2, 2, "panel", 4),
         (130, 128, 400, 4, 2, "panel", 4), (128, 256, 1000, 2, 12, "panel", 8),
         (200, 144, 520, 2, 132, "cluster", 5), (17, 72, 200, 2, 132, "cluster", 2),
         (128, 1000, 2048, 2, 132, "cluster", 8), (64, 100, 130, 4, 132, "cluster", 2),
         (300, 200, 520, 2, 4, "mma", 1), (130, 272, 4104, 2, 4, "revisit", 1),
         (130, 144, 4104, 2, 4, "revisit", 1)]


@pytest.mark.parametrize("case", COVER)
def test_fused_plan_covers_every_row_k_and_column_once(case):
    M, N, K, xb, sms, form, split = case
    p = wp.fused_plan(M, N, K, xb, sms=sms)
    assert (p.form, p.split) == (form, split)
    assert p.smem <= wp.SMEM_LIMIT and p.split <= wp.MAX_CLUSTER
    assert p.k_chunk % wp.S8_BK == 0 or form in ("revisit", "mma")
    assert (p.split - 1) * p.k_chunk < K <= p.split * p.k_chunk
    seen = np.zeros((M, K, N), np.uint8)
    stored = np.zeros((M, N), np.uint8)
    ranks = {}
    for m0, m1, k0, k1, n0, n1, s0, s1 in _units(p, M, N, K):
        seen[m0:m1, k0:k1, n0:n1] += 1
        stored[s0:min(s1, M), n0:n1] += 1
        ranks.setdefault((m0, n0), []).append(k0)
    assert (seen == 1).all() and (stored == 1).all()
    # a tile's K chunks in rank order, each starting inside K
    assert all(ks == sorted(ks) and ks[-1] < K for ks in ranks.values())
    if form == "cluster":
        assert p.grid == wp.cdiv(M, wp.BM) * p.split * wp.cdiv(N, wp.CL_BN)
        return
    if form == "mma":
        assert p.grid == wp.cdiv(M, wp.BM) * wp.cdiv(N, wp.TMA_BN) and p.code == 0
        return
    if form == "revisit":  # 256 columns where their tiles fill `sms`
        wide = N >= 256 and wp.cdiv(M, wp.BM) * wp.cdiv(N, 256) >= sms
        assert p.cols == (256 if wide else 128) and p.code == 3
        assert p.grid == min(sms, wp.cdiv(M, wp.BM) * wp.cdiv(N, p.cols))
        assert p.stages >= 2 and p.smem == wp.qr_smem(xb, p.cols // 128, p.stages)
        return
    # any number of persistent clusters takes every unit once, in runs that
    # quantize a panel at most once each
    for clusters in (1, 2, 5, p.grid):
        got = list(_panel_units(p, M, N, clusters))
        assert sorted((m0, n0) for _, m0, n0, _ in got) == sorted(
            (m0, n0) for m0 in range(0, M, wp.BM) for n0 in range(0, N, wp.TMA_BN))
        for c in range(clusters):
            panels = [m0 for cc, m0, _, fresh in got if cc == c and fresh]
            assert len(panels) == len(set(panels))


def test_fused_plan_at_the_paths_shapes():
    """The serving GEMM takes the panel form on 4 ranks of K 1,024 (128 KB
    panels, 4 stages, 2,048 units); the head (N 1,000: no TMA stride) the
    cluster form on 16 tiles x 8 ranks. 4 ranks where the units are at
    least the 132 SMs, else 8 (a unit for each of their clusters), and 8
    where K needs them; the serving GEMM's size with what the panel's maps
    cannot read runs the revisit kernel on its 2,048 tiles."""
    p = wp.fused_plan(8192, 4096, 4096, 2)
    assert (p.form, p.split, p.k_chunk, p.stages, p.grid) == ("panel", 4, 1024, 4, 64 * 32)
    assert p.smem == 1024 + 8 * 16384 + 4 * (16384 + 16) + 2 * 16 * 256 * 4 <= wp.SMEM_LIMIT
    p = wp.fused_plan(128, 1000, 2048, 2)
    assert (p.form, p.split, p.k_chunk, p.grid) == ("cluster", 8, 256, 128)
    assert [wp.fused_plan(m, n, k, 2).split for m, n, k in (
        (2048, 2048, 4096), (2048, 1024, 4096), (2048, 512, 4096), (2048, 512, 6144),
        (128, 4096, 4096))] == [4, 8, 8, 8, 8]
    assert wp.fused_plan(128, 2048, 4096, 2).form == "cluster"  # 16 units: too few for 8
    for p in (wp.fused_plan(8192, 4096, 4096, 2, aligned=False),
              wp.fused_plan(8192, 4088, 4096, 2),   # N % 16
              wp.fused_plan(8192, 4096, 4092, 2)):  # K * 2 % 16
        assert (p.form, p.grid, p.code) == ("mma", 64 * 32, 0)
    p = wp.fused_plan(8192, 4096, 4104, 2)  # the panel's chunks do not fit
    assert (p.form, p.cols, p.grid, p.stages, p.code) == ("revisit", 256, 132, 3, 3)
    # `_fused2`: the revisit form at the serving GEMM, 128-column tiles where
    # 256-column ones leave the card idle, the cluster form at the head
    assert [(p.form, p.cols) for p in (
        wp.revisit_plan(8192, 4096, 4096, 2), wp.revisit_plan(2048, 512, 4096, 2),
        wp.revisit_plan(128, 1000, 2048, 2))] == [
        ("revisit", 256), ("revisit", 128), ("cluster", 128)]


def test_fused_plan_k_reach():
    """The panel form on 4 ranks up to K 4,096, on 8 up to K 9,216 (1,152 a
    rank, 4 stages) where every rank's chunk starts inside K (K 4,104 on 8
    ranks of 640 leaves the last one empty); the K it turns down, at the
    serving GEMM's 2,048 tiles, runs the revisit kernel: no K is refused."""
    forms = {K: wp.fused_plan(8192, 4096, K, 2) for K in (4096, 4104, 5952, 8192, 9216,
                                                          9344, 65536)}
    assert [(p.form, p.split) for p in forms.values()] == [
        ("panel", 4), ("revisit", 1), ("panel", 8), ("panel", 8), ("panel", 8),
        ("revisit", 1), ("revisit", 1)]
    assert forms[9216].stages == wp.QP_MIN_STAGES


def test_fused_constants_are_the_sources():
    nums = dict(re.findall(r"constexpr int (QP_SLOT|QP_EX) = (\d+);", SOURCE))
    assert {k: int(v) for k, v in nums.items()} == {"QP_SLOT": wp.QP_SLOT, "QP_EX": wp.QP_EX}
    assert "return 1024 + kb * S8_BOX + stages * (QP_SLOT + 16) + 2 * (64 / S) * QP_EX * 4;" \
        in SOURCE
    # the exchange's bias bounds a rank's sums: |sum| <= 127 * 128 * k_chunk
    bias = int(re.search(r"constexpr int QP_BIAS = 1 << (\d+);", SOURCE).group(1))
    assert 127 * 128 * wp.QP_MAX_CHUNK < 2 ** bias and 7 * 2 ** (bias + 1) < 2 ** 32
    assert f"k_chunk > {wp.QP_MAX_CHUNK}" in SOURCE
    assert wp.qp_box_rows(2) == 64 and wp.qp_box_rows(4) == 32
    assert "static_assert(S == 4 || S == 8" in SOURCE and wp.QP_SPLITS == (4, 8)
    # the revisit form: its bytes, its two tile widths, the bracket's width
    assert ("return 1024 + 2 * S8_BOX + BM * 8 + BM / 8 +\n"
            "         stages * (BM * S8_BK * x_bytes + nb * S8_BOX + 16);") in SOURCE
    assert "if (cols == 128)" in SOURCE and "if (cols == 256)" in SOURCE and wp.QR_COLS == 256
    assert "QR_TINY = 0x1p-96f" in SOURCE and "QR_UP = 0x1p100f" in SOURCE
    assert "QR_MAGIC = 12582912.0f" in SOURCE
    assert [wp.qr_stages(xb, nb) for xb in (2, 4) for nb in (1, 2)] == [4, 3, 2, 2]
    assert all(wp.qr_smem(xb, nb, wp.qr_stages(xb, nb)) <= wp.SMEM_LIMIT
               for xb in (2, 4) for nb in (1, 2))


def _quantize_box(box: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The kernels' quantizer on one landing box: IEEE division (no
    reciprocal), round half to even, clip, as int8."""
    return torch.clamp(torch.round(box.float() / s), -127, 127).to(torch.int8)


def replay(x: torch.Tensor, w: torch.Tensor, scales: torch.Tensor, p, out_dtype):
    """The plan's schedule in plain PyTorch: per unit, x's rows and K chunk
    quantized box by box as they land (zeros past M and K), the unit's
    exact int32 sums, summed over the K chunks in rank order, then
    float(acc) * s_row * s_col, one rounding."""
    M, K = x.shape
    N = w.shape[1]
    s_row = im.quantize_rows_scales(x)
    acc = torch.zeros((M, N), dtype=torch.int64)
    rows = wp.qp_box_rows(x.element_size()) if p.form == "panel" else wp.BM
    for m0, m1, k0, k1, n0, n1, _, _ in _units(p, M, N, K):
        q = torch.zeros((m1 - m0, k1 - k0), dtype=torch.int8)
        for b0 in range(m0, m1, rows):  # landing boxes: rows x 128 elements
            for c0 in range(k0, k1, wp.S8_BK):
                b1, c1 = min(m1, b0 + rows), min(k1, c0 + wp.S8_BK)
                q[b0 - m0:b1 - m0, c0 - k0:c1 - k0] = _quantize_box(x[b0:b1, c0:c1],
                                                                    s_row[b0:b1])
        part = (q.double() @ w[k0:k1, n0:n1].double()).to(torch.int64)
        acc[m0:m1, n0:n1] += part  # chunks arrive in rank order
    acc = acc.to(torch.int32)
    return (acc.float() * s_row * scales.float()[None, :]).to(out_dtype)


# tests/test_torch_kernel_variants.py's GEMMs (the Pallas panel kernel's
# aligned case, the unaligned one), one K past 5,952, and at a small size
# the panel form, the mma.sync kernel (N % 16) and the revisit form on 256-
# and 128-column tiles (K 4,104, which the panel's chunks do not fit)
REPLAY = [((64, 256, 128), dict(block_m=32, block_n=128, block_k=128), 132),
          ((48, 384, 200), dict(block_m=32, block_n=128, block_k=128), 132),
          ((64, 6144, 128), dict(block_m=64, block_n=128, block_k=512), 132),
          ((256, 1024, 256), dict(block_m=128, block_n=128, block_k=256), 2),
          ((200, 256, 136), dict(block_m=32, block_n=128, block_k=128), 2),
          ((256, 4104, 272), dict(block_m=128, block_n=128, block_k=512), 2),
          ((256, 4104, 144), dict(block_m=128, block_n=128, block_k=512), 2)]
REPLAY_FORMS = {"panel": ("panel", 128), "revisit": ("mma", 128),
                "revisit_tma": ("revisit", 256), "revisit_tma128": ("revisit", 128)}


@pytest.mark.parametrize("gemm", REPLAY, ids=["aligned", "unaligned", "k6144", "panel",
                                              "revisit", "revisit_tma", "revisit_tma128"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_replay_equals_pallas_fused(gemm, dtype, request):
    (m, k, n), blocks, sms = gemm
    rng = np.random.default_rng(5)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[3] = 0.0  # the 1e-30 floor
    w = rng.integers(-127, 128, (k, n), dtype=np.int8)
    s = rng.uniform(1e-3, 2e-2, n).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    p = wp.fused_plan(m, n, k, xt.element_size(), sms=sms)
    if sms == 2:
        assert (p.form, p.cols) == REPLAY_FORMS[request.node.callspec.id.split("-")[-1]]
    got = replay(xt, torch.from_numpy(w), torch.from_numpy(s), p, xt.dtype)
    want = jim.dequant_matmul_int8_fused(jnp.asarray(x).astype(dtype), jnp.asarray(w),
                                         jnp.asarray(s), interpret=True, **blocks)
    assert np.array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def _rn32_sum(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """fl32(a + b) for float64 arrays whose terms are exact: the float64 sum
    and its exact error (two-sum), rounded once to float32 (a float64 sum on
    a float32 midpoint is moved by the sign of its error)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    r = s.astype(np.float32)
    up = np.nextafter(r, np.float32(np.inf))
    down = np.nextafter(r, np.float32(-np.inf))
    r = np.where((s == (r.astype(np.float64) + up) / 2) & (err > 0), up, r)
    return np.where((s == (r.astype(np.float64) + down) / 2) & (err < 0), down, r)


def _revisit_quantize(x: torch.Tensor) -> np.ndarray:
    """The revisit form's quantizer (`gemm_revisit_qx`) replayed exactly in
    numpy: a row of s < 2^-96 has v and s scaled by 2^100 (exactly); r =
    fl(1/s); q0 = fl(v r); rem = fma(-q0, s, v) (the product exact in
    float64, one rounding); q1 = fma(rem, r, q0) (`_rn32_sum`); then rint of
    q1, half to even."""
    xf = x.float().numpy()
    s = im.quantize_rows_scales(x.float()).numpy()
    up = np.where(s < 2.0 ** -96, np.float32(2.0 ** 100), np.float32(1.0))
    xf, s = xf * up, s * up
    r = (1.0 / s.astype(np.float64)).astype(np.float32)
    q0 = xf * r
    rem = (xf.astype(np.float64) - q0.astype(np.float64) * s.astype(np.float64)).astype(np.float32)
    q1 = _rn32_sum(q0.astype(np.float64), rem.astype(np.float64) * r.astype(np.float64))
    return np.clip(np.rint(q1), -127, 127).astype(np.int8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_revisit_quantizer_equals_quantize_rows(dtype):
    """The division-free quantizer (Markstein's correction of fl(v r)) equals
    quantize_rows' IEEE division and rounding half to even on every value:
    random rows of many magnitudes (down to rows under the 1e-30 floor and
    scales below 2^-96, scaled by 2^100), a zero row, and ties with their
    neighbours."""
    rng = np.random.default_rng(3)
    span = 3 if dtype == torch.float16 else 30  # decades the dtype holds
    x = rng.standard_normal((64, 512)) * 10.0 ** rng.uniform(-span, span, (64, 1))
    x[5] = 0.0
    x[6] = 1e-35 * rng.standard_normal(512)  # under the 1e-30 floor
    x = torch.from_numpy(x.astype(np.float32)).to(dtype)
    assert np.array_equal(_revisit_quantize(x), im.quantize_rows(x)[0].numpy())
    ties = tie_rows(dtype)
    assert np.array_equal(_revisit_quantize(ties), im.quantize_rows(ties)[0].numpy())
