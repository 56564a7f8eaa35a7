"""`int4_matmul`'s wgmma form (`csrc/int4_matmul.cu`'s `int4_matmul_wgmma`)
replayed without a card, and its plan (`kernels/wgmma_plan.py::int4_plan`):

- the walk in plain PyTorch: each tile of 128 W columns split into the
  plan's K chunks of whole groups; in a chunk, each group's low and high
  f32 dots (one a k16 slice of the 64-row stages, the slices added in
  order) scaled by their scale rows and added, acc + (lo s_lo + hi s_hi);
  the chunks' partials added in chunk order. Held within 1e-5 of the JAX
  package's `int4_matmul` Pallas kernel in interpret mode (as
  tests/test_torch_paged.py runs it) at narrowed llama_1b shapes, each
  split as its full-width shape is, at M 1, 8, 37 and 130;
- a stage's A fragments built as a consumer thread builds them
  (ldmatrix.x4.trans from the 128-byte-swizzled W box, the nibble trick
  into bf16 pairs) equal to W^T's low and high nibbles at every (row, k);
- `int4_plan`: a function of (N, K, group) alone; its chunks cover each
  tile's groups once and in order, in runs that differ by a group at most;
  llama_1b's five shapes take the wgmma form with the split that loads the
  busiest of 132 CTAs least (64, 128, 132, 128 and 250 items: the two
  narrow shapes have only 64 and 128 tile-groups); the other shapes the
  mma.sync kernel; the header's constants.
"""

import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smelter_tpu.kernels import int4_matmul as ji4
from smelter_tpu_torch.kernels import int4_matmul as i4
from smelter_tpu_torch.kernels import wgmma_plan as wp
from smelter_tpu_torch.passes.fuse_dequant import pack_int4_half

SRC = Path(__file__).resolve().parents[1] / "smelter_tpu_torch" / "csrc" / "int4_matmul.cu"
LLAMA = {"q/o": (2048, 2048), "k/v": (1024, 2048), "gate/up": (5632, 2048),
         "down": (2048, 5632), "head": (32000, 2048)}  # (N, K)
GROUP = 128


def _walk(x, pk, s, *, group, chunks):
    """The wgmma form's arithmetic on the CPU: bf16 x; in each group, one
    f32 dot a k16 slice of a 64-row stage and a half, summed over the
    group's stages; the slices added in order, then scaled. Every 128-column
    tile is split alike, so all columns are walked at once."""
    M, K = x.shape
    kh, ngh = K // 2, K // 2 // group
    xf = x.to(torch.bfloat16).float()
    w = i4.unpack_int4_half(pk).float()
    plan = wp.Int4Plan("wgmma", pk.shape[1] // wp.I4_COLS, chunks, 0, 0, 0)
    total = None
    for c in range(chunks):
        acc = torch.zeros(M, pk.shape[1])
        for gi in plan.chunk_groups(ngh, c):
            dots = []
            for half in (0, kh):
                dot = None
                for kk in range(wp.I4_ROWS // 16):
                    rows = torch.tensor([half + gi * group + sg + kk * 16 + r
                                         for sg in range(0, group, wp.I4_ROWS)
                                         for r in range(16)])
                    part = xf[:, rows] @ w[rows]
                    dot = part if dot is None else dot + part
                dots.append(dot)
            acc = acc + (dots[0] * s[gi] + dots[1] * s[ngh + gi])
        total = acc if total is None else total + acc
    return total


# narrowed llama_1b shapes (N cut, K and group kept) split as the full one
NARROW = [("k/v", 256), ("gate/up", 384), ("down", 256), ("head", 384)]


@pytest.mark.parametrize("m", [1, 8, 37, 130])
@pytest.mark.parametrize("name,n", NARROW)
def test_wgmma_walk_matches_pallas(name, n, m):
    N, K = LLAMA[name]
    chunks = wp.int4_plan(N, K, GROUP).chunks
    rng = np.random.default_rng(m + n + K)
    x = rng.standard_normal((m, K)).astype(np.float32)
    pk = pack_int4_half(rng.integers(-8, 8, (K, n), dtype=np.int8))
    s = rng.uniform(1e-3, 2e-2, (K // GROUP, n)).astype(np.float32)
    got = _walk(torch.from_numpy(x), torch.from_numpy(pk), torch.from_numpy(s), group=GROUP,
                chunks=chunks).numpy()
    want = np.asarray(ji4.int4_matmul(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(pk),
                                      jnp.asarray(s), group=GROUP, interpret=True))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # the wrapper's CPU path (the plain version) agrees with the walk
    plain = i4.int4_matmul(torch.from_numpy(x), torch.from_numpy(pk), torch.from_numpy(s),
                           group=GROUP).numpy()
    assert np.abs(plain - got).max() <= 1e-5 * np.abs(got).max()
    assert i4.launches == 0


def _nibbles_bf16x2(v):
    """csrc/int4_matmul.cu's nibbles_bf16x2 on uint32 arrays: the signed
    nibbles at bits 0-3 and 16-19 as the two halves' values."""
    u = (v & 0x000F000F) ^ 0x43084308

    def bf16(h):  # a bf16 bit pattern's value
        return (h.astype(np.uint32) << 16).view(np.float32)

    return (bf16(u & 0xFFFF) - 136.0, bf16(u >> 16) - 136.0)


def test_a_fragments_read_the_swizzled_box():
    """Every consumer thread's A fragments for one stage (64 packed rows x
    128 columns, as TMA lays the box out with the 128-byte swizzle), read
    by two ldmatrix.x4.trans a thread as the kernel addresses them, hold
    W^T: A row 16 w + g of warpgroup q is W column 64 q + 16 w + 2 g, row
    16 w + g + 8 column 64 q + 16 w + 2 g + 1; low nibbles the low half's,
    high nibbles the high half's."""
    rng = np.random.default_rng(0)
    box = rng.integers(-128, 128, (64, 128)).astype(np.int8).view(np.uint8)
    smem = np.zeros(64 * 128, np.uint8)
    for k in range(64):
        for c in range(128):
            smem[k * 128 + (((c >> 4) ^ (k & 7)) << 4) + (c & 15)] = box[k, c]
    lo_w = ((box.view(np.int8).astype(np.int16) << 12) >> 12).astype(np.float32)  # low nibble
    hi_w = (box.view(np.int8).astype(np.int16) >> 4).astype(np.float32)

    def b16(o):
        return int(smem[o]) | int(smem[o + 1]) << 8

    for q in range(2):
        a_lo = np.full((4, 64, 16), np.nan, np.float32)  # [slice, A row, k]
        a_hi = np.full((4, 64, 16), np.nan, np.float32)
        for w in range(4):
            chunk16 = q * 4 + w
            for pr in range(2):
                # the address each lane hands ldmatrix: row r of matrix i
                rows = []
                for lane in range(32):
                    k = pr * 32 + ((lane >> 4) << 4) + (((lane >> 3) & 1) << 3) + (lane & 7)
                    rows.append(k * 128 + ((chunk16 ^ (k & 7)) << 4))
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    for i in range(4):  # .trans: rows 2t and 2t + 1, b16 column g
                        v = np.uint32(b16(rows[8 * i + 2 * t] + 2 * g)
                                      | b16(rows[8 * i + 2 * t + 1] + 2 * g) << 16)
                        kk, h = 2 * pr + (i >> 1), i & 1
                        for row, sh_lo, sh_hi in ((g, 0, 4), (g + 8, 8, 12)):
                            for dst, sh in ((a_lo, sh_lo), (a_hi, sh_hi)):
                                e0, e1 = _nibbles_bf16x2(np.array([v >> sh], np.uint32))
                                dst[kk, 16 * w + row, 2 * t + 8 * h] = e0[0]
                                dst[kk, 16 * w + row, 2 * t + 8 * h + 1] = e1[0]
        cols = [q * 64 + 16 * (r // 16) + 2 * (r % 8) + (r % 16) // 8 for r in range(64)]
        for kk in range(4):
            ks = slice(kk * 16, kk * 16 + 16)
            assert np.array_equal(a_lo[kk], lo_w[ks, cols].T)
            assert np.array_equal(a_hi[kk], hi_w[ks, cols].T)


def test_int4_plan_is_a_function_of_the_shape():
    assert list(inspect.signature(wp.int4_plan.__wrapped__).parameters) == ["N", "K", "group"]
    for name, (N, K) in LLAMA.items():
        p = wp.int4_plan(N, K, GROUP)
        ngh = K // 2 // GROUP
        assert p.form == "wgmma" and p.code == 1, name
        assert p.tiles == N // 128 and p.items == p.tiles * p.chunks
        # at most two CTAs an SM
        assert p.grid == min(p.items, wp.I4_CTAS * wp.SMS)
        assert wp.I4_CTAS * p.smem <= 228 * 1024
        # the busiest CTA takes the fewest groups any whole-group split gives
        cost = [wp.cdiv(p.tiles * c, wp.SMS) * wp.cdiv(ngh, c) for c in range(1, ngh + 1)]
        assert cost[p.chunks - 1] == min(cost), name
        groups = [gi for c in range(p.chunks) for gi in p.chunk_groups(ngh, c)]
        assert groups == list(range(ngh)), name  # each group once, in order
        sizes = [len(p.chunk_groups(ngh, c)) for c in range(p.chunks)]
        assert max(sizes) - min(sizes) <= 1, name  # equal bytes, to a group
    # 8 and 16 tiles of 8 groups give at most 64 and 128 items; gate/up 132
    # items of 2-3 groups; down 128 of 2-3 (352 of 1 group load no SM less)
    assert [wp.int4_plan(*LLAMA[n], GROUP).items for n in LLAMA] == [128, 64, 132, 128, 250]
    # narrow or fine-grouped weights keep the mma.sync kernel
    for N, K, group in [(32, 64, 32), (96, 512, 64), (128, 256, 32), (1000, 2048, 128)]:
        assert wp.int4_plan(N, K, group).form == "mma"
    assert wp.int4_plan(128, 256, 64).chunks == 2  # the reduction at a test shape
    # decode splits every chunked tile over CTAs; a prefill walks them whole
    # where (tile, slab) pairs fill the card: the same sums either way
    for name, (N, K) in LLAMA.items():
        p = wp.int4_plan(N, K, GROUP)
        assert not p.whole(1) and not p.whole(8), name
        assert p.whole(256) == (p.chunks > 1), name
        assert p.whole(64) == (p.chunks > 1 and p.tiles * 8 >= 3 * wp.SMS // 4), name
    with pytest.raises(ValueError):
        wp.int4_plan(128, 200, 64)


def test_plan_mirrors_the_header():
    src = SRC.read_text()
    consts = {m[0]: m[1] for m in re.findall(r"constexpr int (Q_\w+) = (\d+);", src)}
    assert (int(consts["Q_ROWS"]), int(consts["Q_COLS"]), int(consts["Q_MT"]),
            int(consts["Q_STAGES"]), int(consts["Q_CTAS"]), int(consts["Q_SMS"])) == (
        wp.I4_ROWS, wp.I4_COLS, wp.I4_MT, wp.I4_STAGES, wp.I4_CTAS, wp.SMS)
    assert f"// {wp.I4_SMEM:,}" in src and f"// {wp.I4_STAGE:,}" in src
    # at least 48 KB of W in flight an SM
    assert wp.I4_CTAS * wp.I4_STAGES * wp.I4_ROWS * wp.I4_COLS >= 48 * 1024
