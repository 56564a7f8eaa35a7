"""Which form of `csrc/wgmma_gemm.cuh` a GEMM takes, from its shape alone.

A pure function of (M, N, K) and a few flags, so the CPU tests can check it.
The header's two forms (its comment gives the same numbers):

- "tma": the persistent warp-specialised kernel; tiles of 128 x 128, K
  steps of BK through TMA, one CTA an SM (an int8 B, W, takes
  `gemm_tma_ra`: W^T as wgmma's register operand). It needs 16-byte
  global strides (K % 8 == 0; N % 8 for a bf16/f16 B, N % 16 for int8)
  and 16-byte aligned bases (`aligned`), no TMA box larger than its matrix
  (M >= BM, K >= BK, N >= BN), and enough tiles to fill half the card.
- "cluster": 128 x 64 tiles, K split over a cluster of S <= 8 CTAs (the
  portable cluster size), S = min(8, SMs / tiles, K steps), each CTA a
  `k_chunk` (a multiple of BK) of K; any shape and alignment.

`block_plan` picks each projection of `vit_attention_block` the same way:
"tma" (`gemm_tma` with the block epilogue: bias, residual, one rounding;
the packed QKV weight through a 3-D map) where its maps can describe the
GEMM, else "mma" (`csrc/gemm.cuh`); `layer_scale_plan` picks
`convnext_block`'s FC2 alike, down to N 64.

`conv_plan` picks `dequant_conv`'s kernel for a 16-bit stride-1 conv the
same way: "wgmma" (`gemm_tma_ra` with an im2col map of x) where the TMA
maps can describe it, else "mma" (`csrc/dequant_conv.cu`'s mma.sync
implicit GEMM, any shape).

`int8_plan` picks `int8_matmul`'s form among the header's int8 forms:
"tma" (`gemm_tma_s8`, W^T the register operand of wgmma s8) for aligned
shapes with tiles enough, else "cluster" (`gemm_cluster_s8`, a K split).

`fused_plan` picks `dequant_matmul_int8_fused`'s (`csrc/
int8_matmul_fused.cu`): "panel" (x quantized once into a resident panel
whose K is split over a cluster, W by TMA) where its maps can read both,
else `revisit_plan`'s form, which `dequant_matmul_int8_fused2` takes:
"cluster" (a K split, x quantized as each tile loads it) for few tiles,
else "revisit" (a persistent TMA-fed int8 wgmma kernel whose output tiles
quantize the x boxes they stage) where its maps can read both, else "mma"
(the mma.sync quantize-on-revisit kernel, any shape).

`qconv_plan` picks `qlinear_conv`'s kernel: "gemm" (a 1x1 stride-1 conv
on 2-D TMA maps) or "im2col" (any kernel and stride on an im2col map), the
wgmma forms of `csrc/wgmma_qconv.cuh`, where the maps can read the conv,
else "mma" (`csrc/qlinear_conv.cu`'s mma.sync kernel, any shape).

`int4_plan` picks `int4_matmul`'s kernel (`csrc/int4_matmul.cu`) from
(N, K, group) alone: "wgmma" (the TMA-fed weight stream, W^T the register
operand of wgmma m64n8k16) where its maps can read the weight (N % 128,
group % 64), with the K split into whole groups that fills the card; else
"mma" (the mma.sync kernel, any shape the wrapper takes).

`pixel_plan` picks 16-bit `pixel_conv_rowdot`'s kernel: "wgmma"
(`csrc/wgmma_conv.cuh`, the weight resident in shared memory where it
fits) where its TMA boxes can read the maps, else "mma" (the mma.sync or
f32 kernel of `csrc/pixel_conv.cu`). With `tall` it picks
`pixel_conv_blockdot`'s: the same core on a tile of 8 output rows
(`pixel_tall_plan`) where that fits and the rule below takes it, else the
4-row tile, else the 4-row mma.sync (f32: FMA) blocks.
"""

from __future__ import annotations

import dataclasses
import functools

BM, BK, ATOM = 128, 64, 64
CONSUMERS = 2
SMEM_BUDGET = 225 * 1024
SMEM_LIMIT = 232_448      # 227 KB, what one block may have on an H100
MAX_CLUSTER = 8           # the portable cluster size
SMS = 132                 # streaming multiprocessors of an H100 SXM
TMA_BN = 128
CL_BN, CL_STAGES = 64, 3


@dataclasses.dataclass(frozen=True)
class Plan:
    form: str        # "tma" or "cluster"
    bm: int
    bn: int
    split: int       # CTAs along K (the cluster's size); 1 for "tma"
    k_chunk: int     # K rows a CTA sums
    grid: int        # CTAs launched
    smem: int        # dynamic shared memory a CTA, bytes

    @property
    def code(self) -> int:
        """The form's code in the header's `Form` enum."""
        return {"mma": 0, "tma": 1, "cluster": 2}[self.form]


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


EPI = CONSUMERS * 64 * 64 * 4  # gemm_tma's epilogue sub-tiles, one a warpgroup


def tma_stages(bn: int, int8_b: bool, recv: bool = False) -> int:
    """Stages of the tma form: as many as fit the budget, at most 8. An
    int8 B takes gemm_tma_ra (`ra_stages`); `recv`: gemm_tma's f32 recv
    tile (BM x bn) in place of the epilogue's sub-tiles."""
    if int8_b:
        return ra_stages(bn)
    epi = BM * bn * 4 if recv else EPI
    return min(8, (SMEM_BUDGET - 1024 - epi) // (BM * BK * 2 + BK * bn * 2))


def tma_smem(bn: int, int8_b: bool, recv: bool = False) -> int:
    """Bytes: alignment, the stages and their two mbarriers each, the
    epilogue, and with recv its two mbarriers."""
    if int8_b:
        return ra_smem(bn)
    epi = BM * bn * 4 + 16 if recv else EPI
    return 1024 + tma_stages(bn, False, recv) * (BM * BK * 2 + BK * bn * 2 + 16) + epi


CLUSTER_SMEM = 1024 + CL_STAGES * (BM * BK * 2 + BK * CL_BN * 2)


def plan(M: int, N: int, K: int, *, int8_b: bool, aligned: bool = True,
         sms: int = SMS) -> Plan:
    """The form, tile and split for out (M, N) = [recv +] A (M, K) @ B (K,
    N), A 16-bit, B int8 (`int8_b`) or 16-bit. `aligned`: every base
    16-byte aligned. (With recv, collective_matmul_rs's f32 sum, gemm_tma
    takes `tma_smem(bn, False, recv=True)`: the same bytes, one stage
    fewer.)"""
    mt = cdiv(M, BM)
    strides_ok = K % 8 == 0 and N % (16 if int8_b else 8) == 0
    tiles = mt * cdiv(N, TMA_BN)
    # no TMA box larger than the matrix it reads
    if aligned and strides_ok and M >= BM and K >= BK and N >= TMA_BN and tiles >= sms // 2:
        return Plan("tma", BM, TMA_BN, 1, K, min(tiles, sms), tma_smem(TMA_BN, int8_b))
    tiles = mt * cdiv(N, CL_BN)
    steps = cdiv(K, BK)
    split = max(1, min(MAX_CLUSTER, sms // max(tiles, 1), steps))
    per = cdiv(steps, split) if steps else 1
    split = cdiv(steps, per) if steps else 1
    return Plan("cluster", BM, CL_BN, split, per * BK, tiles * split, CLUSTER_SMEM)


S8_BK = 128                   # K bytes a step of the int8 forms
S8_BOX = BM * S8_BK           # an x box or a W box of the int8 tma form


def int8_stages() -> int:
    """Stages of the int8 tma form: an x box and a W box each, as many as
    fit the budget, at most 8 (its epilogue stores from the accumulators)."""
    return min(8, (SMEM_BUDGET - 1024) // (2 * S8_BOX))


INT8_TMA_SMEM = 1024 + int8_stages() * (2 * S8_BOX + 16)
INT8_CLUSTER_SMEM = 1024 + CL_STAGES * (BM * S8_BK + CL_BN * S8_BK)


def int8_plan(M: int, N: int, K: int, *, aligned: bool = True, sms: int = SMS) -> Plan:
    """The form, tile and split of `int8_matmul`'s out (M, N) = x (M, K) @ W
    (K, N), both int8. "tma" (`gemm_tma_s8`: 128 W columns x 128 x rows a
    tile, W^T wgmma's register operand) where TMA can read both operands:
    16-byte aligned bases (`aligned`) and row strides (K % 16, N % 16), no
    box larger than its matrix (M, K, N >= 128), and tiles enough to fill
    half the card; else "cluster" (`gemm_cluster_s8`, any shape: 128 x 64
    tiles, K split over S <= 8 CTAs in steps of 128 bytes)."""
    tiles = cdiv(M, BM) * cdiv(N, TMA_BN)
    if (aligned and K % 16 == 0 and N % 16 == 0 and min(M, K, N) >= BM
            and tiles >= sms // 2):
        return Plan("tma", BM, TMA_BN, 1, K, min(tiles, sms), INT8_TMA_SMEM)
    tiles = cdiv(M, BM) * cdiv(N, CL_BN)
    steps = cdiv(K, S8_BK)
    split = max(1, min(MAX_CLUSTER, sms // max(tiles, 1), steps))
    per = cdiv(steps, split) if steps else 1
    split = cdiv(steps, per) if steps else 1
    return Plan("cluster", BM, CL_BN, split, per * S8_BK, tiles * split, INT8_CLUSTER_SMEM)


# -- dequant_matmul_int8_fused (csrc/int8_matmul_fused.cu) ---------------------

QP_SLOT = 16384           # a ring slot of the panel form: an x float box or a W box
QP_EX = 256               # consumer threads of a CTA, each a row of the exchange
QP_SPLITS = (4, 8)        # the panel form's cluster sizes (ranks of the K split)
QP_MIN_STAGES = 4         # ring stages the panel form needs beside its panel
QP_MAX_CHUNK = 1152       # K a rank at most: its exchanged sums stay below 2^25


def qp_box_rows(x_bytes: int) -> int:
    """Rows of the panel form's x landing box: 128 elements a row, 16 KB."""
    return QP_SLOT // (S8_BK * x_bytes)


def qp_smem(split: int, kb: int, stages: int) -> int:
    """Bytes of the panel form: alignment, the panel (kb K blocks of 128 rows
    x 128 bytes), the ring and its two mbarriers a stage, and the two
    exchange buffers of 64 / split int32 sums a consumer thread (as 64-bit
    pairs)."""
    return 1024 + kb * S8_BOX + stages * (QP_SLOT + 16) + 2 * (64 // split) * QP_EX * 4


def qp_stages(split: int, kb: int) -> int:
    """Ring stages that fit beside a panel of kb K blocks, at most 8."""
    return min(8, (SMEM_LIMIT - qp_smem(split, kb, 0)) // (QP_SLOT + 16))


QR_COLS = 256             # W columns of the revisit form's tile: two W boxes


def qr_smem(x_bytes: int, nb: int, stages: int) -> int:
    """Bytes of the revisit form: alignment, two quantized x boxes, the row
    table (two floats and a bit a row), and `stages` ring stages of an x
    float box (128 rows x 128 elements) and nb W boxes, with two mbarriers
    each."""
    return (1024 + 2 * S8_BOX + BM * 8 + BM // 8
            + stages * (BM * S8_BK * x_bytes + nb * S8_BOX + 16))


def qr_stages(x_bytes: int, nb: int) -> int:
    """Ring stages of the revisit form that fit a block, at most 8."""
    return min(8, (SMEM_LIMIT - qr_smem(x_bytes, nb, 0)) // (BM * S8_BK * x_bytes
                                                              + nb * S8_BOX + 16))


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    form: str        # "panel" (gemm_panel_qx), "cluster" (gemm_cluster_s8 on float x),
                     # "revisit" (gemm_revisit_qx) or "mma" (int8_matmul_qx, mma.sync)
    split: int       # CTAs a cluster, each a K chunk (revisit, mma: 1)
    k_chunk: int     # K elements a CTA sums (panel, cluster: a multiple of S8_BK)
    stages: int      # panel, revisit: ring stages; cluster: CL_STAGES; mma: 0
    grid: int        # panel: work units (128-row panel, N tile), split evenly over
                     # the clusters that fit the card at once; else CTAs launched
    smem: int        # dynamic shared memory a CTA, bytes (mma: static, 0)
    cols: int = TMA_BN  # W columns of an output tile (revisit: 128 or 256)

    @property
    def code(self) -> int:
        """The form's code at the entry point."""
        return {"mma": 0, "panel": 1, "cluster": 2, "revisit": 3}[self.form]


def mma_plan(M: int, N: int, K: int) -> FusedPlan:
    """The mma.sync quantize-on-revisit kernel (`int8_matmul_qx`): 128 x
    128 output tiles, each quantizing the x tiles it stages, all of K; any
    shape and alignment."""
    return FusedPlan("mma", 1, K, 0, cdiv(M, BM) * cdiv(N, TMA_BN), 0)


def revisit_form(M: int, N: int, K: int, x_bytes: int, *, cols: int = QR_COLS,
                 sms: int = SMS) -> FusedPlan:
    """The revisit form (`gemm_revisit_qx`) on tiles of 128 x rows x `cols`
    (128 or 256) W columns: min(tiles, sms) persistent CTAs, the stages that
    fit. The caller checks that its maps can read the operands."""
    nb = cols // TMA_BN
    stages = qr_stages(x_bytes, nb)
    return FusedPlan("revisit", 1, K, stages, min(cdiv(M, BM) * cdiv(N, cols), sms),
                     qr_smem(x_bytes, nb, stages), cols)


@functools.lru_cache(maxsize=256)
def revisit_plan(M: int, N: int, K: int, x_bytes: int, *, aligned: bool = True,
                 sms: int = SMS) -> FusedPlan:
    """Quantize-on-revisit, `dequant_matmul_int8_fused2`'s form (and
    `fused_plan`'s where the panel form turns a shape down): every output
    tile quantizes the x boxes it stages, all of K. "cluster" where 128 x
    64 tiles are too few to fill the card (`2 * tiles <= sms`: the ResNet-50
    head, whose N 1,000 no TMA stride can take; it quantizes each x tile as
    it loads it, K split over up to 8 CTAs); else "revisit" where TMA can
    read both operands (16-byte aligned bases, K x_bytes % 16, N % 16, no
    box past its matrix: M, N, K >= 128): tiles of 128 x rows x QR_COLS W
    columns (256, two W boxes: x is quantized and read once every 256
    columns, where 128-column tiles do it twice as often) where they fill
    the card, else 128-column tiles (the serving GEMM's 1,024 tiles of 256:
    0.586 ms against 0.776 on 128; 2,048 x 4,096 x 512's 32: 0.0970
    against 0.0731; NVIDIA H100 80GB HBM3, 700 W,
    experiments/torch_patch_fused_timing.py); else "mma", the mma.sync
    kernel (N % 16, an unaligned base at a large shape)."""
    if 2 * cdiv(M, BM) * cdiv(N, CL_BN) <= sms:
        return _cluster_form(M, N, K, sms)
    if aligned and K * x_bytes % 16 == 0 and N % 16 == 0 and min(M, N, K) >= BM:
        wide = N >= QR_COLS and cdiv(M, BM) * cdiv(N, QR_COLS) >= sms
        return revisit_form(M, N, K, x_bytes, cols=QR_COLS if wide else TMA_BN, sms=sms)
    return mma_plan(M, N, K)


def _panel_form(M: int, N: int, K: int, split: int) -> FusedPlan | None:
    """The panel form on `split` ranks, or None where its chunks do not fit:
    every rank's chunk must start inside K, hold at most QP_MAX_CHUNK and
    leave room for QP_MIN_STAGES ring stages."""
    kc = cdiv(cdiv(K, split), S8_BK) * S8_BK
    kb = kc // S8_BK
    stages = qp_stages(split, kb)
    if (split - 1) * kc >= K or kc > QP_MAX_CHUNK or stages < QP_MIN_STAGES:
        return None
    return FusedPlan("panel", split, kc, stages, cdiv(M, BM) * cdiv(N, TMA_BN),
                     qp_smem(split, kb, stages))


def _cluster_form(M: int, N: int, K: int, sms: int) -> FusedPlan:
    """The cluster form: 128 x 64 tiles, K split over S <= 8 CTAs as
    `int8_plan`'s cluster form splits it."""
    tiles = cdiv(M, BM) * cdiv(N, CL_BN)
    steps = cdiv(K, S8_BK)
    split = max(1, min(MAX_CLUSTER, sms // max(tiles, 1), steps))
    per = cdiv(steps, split) if steps else 1
    split = cdiv(steps, per) if steps else 1
    return FusedPlan("cluster", split, per * S8_BK, CL_STAGES, tiles * split,
                     INT8_CLUSTER_SMEM)


@functools.lru_cache(maxsize=256)
def fused_plan(M: int, N: int, K: int, x_bytes: int, *, aligned: bool = True,
               sms: int = SMS) -> FusedPlan:
    """`dequant_matmul_int8_fused`'s form for x (M, K) of `x_bytes` a
    value (2: bf16/f16, 4: f32) and W (K, N) int8.

    "panel" where TMA can read both (16-byte aligned bases, K x_bytes % 16,
    N % 16, no box past its matrix: M, N, K >= 128) and the first split of
    QP_SPLITS whose chunks fit (`_panel_form`: K up to 4,096 on 4 ranks,
    9,216 on 8) has units enough. The clusters persist and take the (panel,
    N tile) units in even runs; at most sms / split of them fit the card at
    once (30 of 4 on an H100 SXM). A unit on 4 ranks does twice the tensor
    work of one on 8 for about the same exchange, so 4 ranks win where the
    units come in several waves (units >= sms: the serving GEMM's 2,048,
    0.743 ms against 1.119 on 8) and lose where few waves leave the last
    one half idle (2,048 x 4,096 x 512's 64: 0.111 against 0.101; NVIDIA
    H100 80GB HBM3, 700 W, experiments/torch_patch_fused_timing.py); 8 ranks
    need a unit for each cluster (units x 8 >= sms). Else `revisit_plan`'s
    form: "cluster" where 128 x 64 tiles are too few to fill the card (the
    head), "revisit" where the maps can read the shape (a K the panel form
    turns down: 4,097-4,480, past 9,216), else "mma" (N % 16, an unaligned
    base at a large shape: the cluster form on one rank there runs at a
    third of its speed)."""
    if aligned and K * x_bytes % 16 == 0 and N % 16 == 0 and min(M, N, K) >= BM:
        units = cdiv(M, BM) * cdiv(N, TMA_BN)
        for s, least in zip(QP_SPLITS, (sms, cdiv(sms, QP_SPLITS[1]))):
            p = _panel_form(M, N, K, s)
            if p is not None and units >= least:
                return p
    return revisit_plan(M, N, K, x_bytes, aligned=aligned, sms=sms)


def block_plan(M: int, N: int, K: int, *, group: int = 0, gelu: bool = False,
               aligned: bool = True, sms: int = SMS) -> Plan:
    """`vit_attention_block`'s projections and `mlp_block`'s FC1 and FC2:
    out (M, N) = A (M, K) @ B + bias [+ residual, or GELU (`gelu`)], A and B
    16-bit: B a (K, N) matrix, or (`group` > 0) the packed QKV weight (N /
    group, K, group). "tma" on min(tiles, sms) CTAs where TMA can read it:
    16-byte aligned bases and strides (K % 8, N % 8), no box larger than its
    matrix (M >= BM, K >= BK, N >= 128) and group % 64 == 0 (an atom of 64
    columns inside one block); the GELU epilogue's hand-off tile takes the
    recv tile's bytes. Unlike `plan` it needs no number of tiles: the
    alternative, "mma" (`csrc/gemm.cuh`), tiles the same 128 x 128."""
    tiles = cdiv(M, BM) * cdiv(N, TMA_BN)
    if (aligned and K % 8 == 0 and N % 8 == 0 and M >= BM and K >= BK and N >= TMA_BN
            and group % ATOM == 0):
        return Plan("tma", BM, TMA_BN, 1, K, min(tiles, sms),
                    tma_smem(TMA_BN, False, recv=gelu))
    return Plan("mma", BM, TMA_BN, 1, K, tiles, 0)


def layer_scale_plan(M: int, N: int, K: int, *, aligned: bool = True, sms: int = SMS) -> Plan:
    """`convnext_block`'s FC2: out (M, N) = x + gamma (A (M, K) @ B (K, N) +
    bias), A and B 16-bit (`gemm_tma` with kEpiBiasScaleRes). As
    `block_plan`, but N from one 64-column box (ConvNeXt-T's C 96): a
    128-column tile's second box lies partly or wholly past N, TMA fills it
    with zeros and the stores stop at N, where 64-column tiles would read A
    twice; else "mma" (`csrc/gemm.cuh`)."""
    tiles = cdiv(M, BM) * cdiv(N, TMA_BN)
    if aligned and K % 8 == 0 and N % 8 == 0 and M >= BM and K >= BK and N >= ATOM:
        return Plan("tma", BM, TMA_BN, 1, K, min(tiles, sms), tma_smem(TMA_BN, False))
    return Plan("mma", BM, TMA_BN, 1, K, tiles, 0)


RA_EPI = CONSUMERS * BM * 64 * 2  # gemm_tma_ra's staged 16-bit output, a warpgroup's each


# gemm_tma_ra's tiles a W width (WC): x rows a tile, and stages of an x box
# (or two) and a W box.
def ra_rows(wc: int) -> int:
    return BM if wc == 128 else 2 * BM


def ra_stages(wc: int) -> int:
    stage = ra_rows(wc) * BK * 2 + BK * wc
    return min(8, (SMEM_BUDGET - 1024 - RA_EPI) // stage)


def ra_smem(wc: int) -> int:
    stage = ra_rows(wc) * BK * 2 + BK * wc
    return 1024 + ra_stages(wc) * (stage + 16) + RA_EPI


IM2COL_CORNER = (-128, 127)  # the corner offsets a 4-D im2col map can hold


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    form: str        # "wgmma" (gemm_tma_ra on an im2col map) or "mma"
    bm: int          # output pixels a tile
    bn: int          # output channels a tile
    tiles: int
    split: int       # CTAs along K; 1 (no form splits a conv's K)
    grid: int        # CTAs launched
    smem: int        # dynamic shared memory a CTA, bytes

    @property
    def code(self) -> int:
        """The form's code in `csrc/dequant_conv.cu`'s entry point."""
        return {"mma": 0, "wgmma": 1}[self.form]


def conv_plan(n: int, h: int, w: int, c_in: int, c_out: int, kh: int, kw: int, pads, *,
              aligned: bool = True, sms: int = SMS) -> ConvPlan:
    """`dequant_conv`'s kernel for 16-bit x (N, H, W, C_in), an int8 HWIO
    weight (kh, kw, C_in, C_out), stride 1, pads ((top, bottom), (left,
    right)); `aligned`: x's and w's bases 16-byte aligned. The wgmma form
    needs C_in % 64 == 0 (a K step inside one tap, 128-byte pixel rows),
    C_out % 16 == 0 (the int8 W map's row stride), C_out >= 64, at least
    one tile of pixels, pads >= 0 and corner offsets the im2col map can
    hold; it takes BN 128 where C_out % 128 == 0, else 64 (C_out 64:
    256-pixel tiles, not half-empty 128-column ones)."""
    (pt, pb), (pl, pr) = pads
    ho, wo = h + pt + pb - kh + 1, w + pl + pr - kw + 1
    M = n * ho * wo
    lo, hi = IM2COL_CORNER
    corners = (-pl, -pt, wo - w - pl, ho - h - pt)
    bn = 128 if c_out % 128 == 0 else 64
    if (aligned and c_in % 64 == 0 and c_out % 16 == 0 and c_out >= 64 and M >= ra_rows(bn)
            and min(pt, pb, pl, pr) >= 0 and all(lo <= c <= hi for c in corners)):
        tiles = cdiv(M, ra_rows(bn)) * cdiv(c_out, bn)
        return ConvPlan("wgmma", ra_rows(bn), bn, tiles, 1, min(tiles, sms), ra_smem(bn))
    tiles = cdiv(M, 128) * cdiv(c_out, 128)
    return ConvPlan("mma", 128, 128, tiles, 1, tiles, 0)


# qlinear_conv's wgmma forms (csrc/wgmma_qconv.cuh): tiles of 128 output
# pixels x QC_BN channels (64 where C_out < 128), K steps of the largest of
# 128, 64, 32 bytes that divides C_in, as many stages as fit (at most 16)
# beside the epilogue's tiles. An input of fewer than QC_PAD_BELOW channels
# (an RGB stem) is read unfolded: a copy whose pixel (i, j) holds the kw
# input pixels of output column j's window side by side, kw x C_in
# channels zero-padded to a multiple of QC_PAD_TO, so the conv becomes a
# kh x 1 conv (stride (sh, 1)) over that copy by a weight laid out alike.
QC_BN = 128
QC_MAX_STAGES = 16
QC_PAD_BELOW = 16
QC_PAD_TO = 32


@dataclasses.dataclass(frozen=True)
class QconvPlan:
    form: str        # "gemm", "im2col" (csrc/wgmma_qconv.cuh) or "mma" (qlinear_conv.cu's)
    c_in: int        # the channels the kernel reads: C_in, or the unfolded copy's
    bk: int          # K bytes a step (wgmma forms)
    bn: int          # output channels a tile
    tiles: int
    grid: int        # CTAs launched
    stages: int      # (wgmma forms; 0 for mma)
    smem: int        # dynamic shared memory a CTA, bytes (mma: 0, static)
    unfold: bool = False  # read the unfolded copy (a kh x 1 conv over it)

    @property
    def code(self) -> int:
        """The form's code in `csrc/qlinear_conv.cu`'s entry point."""
        return {"mma": 0, "gemm": 1, "im2col": 2}[self.form]


def qconv_epi(bn: int) -> int:
    """The epilogue's bytes: the int8 staging tiles (a warpgroup's 64 rows
    of bn bytes) and each warpgroup's f32 multipliers and addends."""
    return CONSUMERS * 64 * bn + CONSUMERS * 2 * bn * 4


def qconv_stages(bk: int, bn: int) -> int:
    return min(QC_MAX_STAGES, (SMEM_BUDGET - 1024 - qconv_epi(bn)) // (BM * bk + bn * bk + 16))


def qconv_smem(bk: int, bn: int) -> int:
    return 1024 + qconv_stages(bk, bn) * (BM * bk + bn * bk + 16) + qconv_epi(bn)


def _qconv_wgmma(n, h, w, c_in, c_out, kh, kw, sh, sw, pads, sms) -> QconvPlan | None:
    """A wgmma form for the conv as the kernel reads it, or None."""
    (pt, pb), (pl, pr) = pads
    ho, wo = (h + pt + pb - kh) // sh + 1, (w + pl + pr - kw) // sw + 1
    lo, hi = IM2COL_CORNER
    corners = (-pl, -pt, (wo - 1) * sw - pl - (w - 1), (ho - 1) * sh - pt - (h - 1))
    gemm = kh == kw == 1 and sh == sw == 1 and pt == pb == pl == pr == 0
    im2col = (min(pt, pb, pl, pr) >= 0 and 1 <= sh <= 8 and 1 <= sw <= 8
              and kh <= 256 and kw <= 256 and all(lo <= c <= hi for c in corners))
    if not (c_in % 32 == 0 and c_out % 16 == 0 and c_out >= 64 and ho >= 1 and wo >= 1
            and n * ho * wo >= BM and (gemm or im2col)):
        return None
    bk = 128 if c_in % 128 == 0 else 64 if c_in % 64 == 0 else 32
    bn = QC_BN if c_out >= QC_BN else 64
    tiles = cdiv(n * ho * wo, BM) * cdiv(c_out, bn)
    return QconvPlan("gemm" if gemm else "im2col", c_in, bk, bn, tiles, min(tiles, sms),
                     qconv_stages(bk, bn), qconv_smem(bk, bn))


# Cached: the wrapper plans every call (53 a ResNet-50 forward).
@functools.lru_cache(maxsize=1024)
def qconv_plan(n: int, h: int, w: int, c_in: int, c_out: int, kh: int, kw: int, sh: int,
               sw: int, pads, *, aligned: bool = True, sms: int = SMS) -> QconvPlan:
    """`qlinear_conv`'s kernel for int8 x (N, H, W, C_in) channels-last, an
    OHWI int8 weight (C_out, kh, kw, C_in), strides (sh, sw), pads ((top,
    bottom), (left, right)); `aligned`: x's and w's bases 16-byte aligned.

    The wgmma forms take C_in % 32 == 0, C_out % 16 == 0 and >= 64
    (16-byte output rows; no weight box past C_out), at least 128 output
    pixels (no pixel box larger than the map), and: "gemm" a 1x1 stride-1
    conv without pads; "im2col" pads >= 0, strides 1-8, taps up to 256 a
    side and window corners the im2col map can hold. C_in < 16 (an RGB
    stem) is read unfolded (`unfold`: a kh x 1 conv with stride (sh, 1) and
    no side pads over Wo columns of kw x C_in channels padded to a multiple
    of 32, fresh copies that need no alignment). The rest, and bases that
    are not 16-byte aligned, keep the mma.sync kernel."""
    (pt, pb), (pl, pr) = pads
    if c_in < QC_PAD_BELOW:
        wo = (w + pl + pr - kw) // sw + 1
        c_unf = cdiv(kw * c_in, QC_PAD_TO) * QC_PAD_TO
        plan = _qconv_wgmma(n, h, wo, c_unf, c_out, kh, 1, sh, 1, ((pt, pb), (0, 0)), sms)
        if plan is not None:
            return dataclasses.replace(plan, unfold=True)
    elif aligned:
        plan = _qconv_wgmma(n, h, w, c_in, c_out, kh, kw, sh, sw, pads, sms)
        if plan is not None:
            return plan
    ho, wo = (h + pt + pb - kh) // sh + 1, (w + pl + pr - kw) // sw + 1
    tiles = cdiv(n * ho * wo, 128) * cdiv(c_out, 128)
    return QconvPlan("mma", c_in, 64, 128, tiles, tiles, 0, 0)


# pixel_conv_rowdot's wgmma form (csrc/wgmma_conv.cuh): tiles of PC_R output
# rows x PC_PX pixels, K steps of PC_CK channels; a stage holds the x box of
# the step's PC_R + 2 input rows (PC_RAWPX pixels), the producer's K-major
# copy of it (PC_XPX pixel rows of 8 channels, two channel groups; padded to
# 1 KB) and, unless the weight is resident, the 9 taps' weights, behind
# three mbarriers. The int8 form of pixel_conv_rowdot_q
# (csrc/wgmma_conv_s8.cuh) has the same tiles and stages on 8-bit operands:
# K steps of PQ_CK channels, an x box of PQ_RAWPX pixels, a copy of PC_XPX
# rows of 16 channels, the resident weight in chunks of PQ_CHUNK channels,
# and int8 (or 16-bit) staging.
# blockdot's taller tile (PC_TALL_RW rows a consumer warpgroup) stages
# PC_TALL_R + 2 input rows a step, lands its x boxes in a ring of
# PC_RAW_SLOTS of their own (a stage: the copy and the weights), and stores
# its rows PC_EPI_RW at a time through the same staging tiles.
PC_PX, PC_CK, PC_RW, PC_XPX, PC_RAWPX = 64, 16, 2, 72, 80
PC_TALL_RW, PC_EPI_RW, PC_TRANSPOSERS, PC_RAW_SLOTS = 4, 2, 96, 2
PQ_CK, PQ_RAWPX, PQ_CHUNK = 32, 96, 64
PC_R = CONSUMERS * PC_RW
PC_XROWS = PC_R + 2
PC_TALL_R = CONSUMERS * PC_TALL_RW
PC_COUT = (32, 64)        # the form's C_out (wgmma's N)
PC_RES_STAGES = 4         # stages the resident weight must leave room for
PC_TALL_MIN_STAGES = 2    # the taller tile's: two stages of twice the work
_MAX_STRIDE = 1 << 40     # TMA's largest global stride, bytes


def pixel_box(rows: int = PC_R, int8: bool = False) -> int:
    """A step's x box for a tile of `rows` output rows: rows + 2 input
    rows of the step's channels."""
    return (rows + 2) * (PQ_CK * PQ_RAWPX if int8 else PC_CK * PC_RAWPX * 2)


def pixel_ring(rows: int = PC_R) -> int:
    """The taller tile's ring of x boxes and its two mbarriers a slot (the
    4-row tile keeps its box in each stage: 0)."""
    return 0 if rows == PC_R else PC_RAW_SLOTS * (pixel_box(rows) + 16)


def pixel_stage(c_out: int, resident: bool = False, int8: bool = False,
                rows: int = PC_R) -> int:
    """A stage's bytes for a tile of `rows` output rows: the x box (the
    4-row tile's; the taller tile's lie in `pixel_ring`), its copy (padded
    to 1 KB) and, unless the weight is resident, the step's weights."""
    ck = PQ_CK if int8 else PC_CK * 2
    copy = cdiv((rows + 2) * 2 * PC_XPX * 16, 1024) * 1024
    raw = pixel_box(rows, int8) if rows == PC_R else 0
    return raw + copy + (0 if resident else 9 * c_out * ck)


def pixel_epi(c_out: int, out_bytes: int = 2) -> int:
    """The staging tiles: 2 warpgroups x 2 rows x C_out rows of 64 pixels
    (the taller tile stores its rows through them in turns)."""
    return CONSUMERS * PC_EPI_RW * c_out * 64 * out_bytes


def pixel_stages(c_out: int, int8: bool = False, out_bytes: int = 2, rows: int = PC_R) -> int:
    ring = pixel_box(rows) * PC_RAW_SLOTS if rows != PC_R else 0
    return min(8, (SMEM_BUDGET - 1024 - pixel_epi(c_out, out_bytes) - ring)
               // pixel_stage(c_out, False, int8, rows))


def pixel_smem(c_out: int, int8: bool = False, out_bytes: int = 2, rows: int = PC_R) -> int:
    return (1024 + pixel_ring(rows) + pixel_stages(c_out, int8, out_bytes, rows)
            * (pixel_stage(c_out, False, int8, rows) + 24) + pixel_epi(c_out, out_bytes))


def pixel_resident(c_in: int, c_out: int, int8: bool = False) -> int:
    """The resident weight's bytes: [chunk][tap][C_out][128 bytes of
    channels] (int8: 64 bytes), and a chunk's mbarrier."""
    row = PQ_CHUNK if int8 else 128
    return cdiv(c_in, row // (1 if int8 else 2)) * (9 * c_out * row + 8)


def pixel_resident_stages(c_in: int, c_out: int, int8: bool = False,
                          out_bytes: int = 2, rows: int = PC_R) -> int:
    """Stages of x alone beside the resident weight, at most 8."""
    free = (SMEM_BUDGET - 1024 - pixel_epi(c_out, out_bytes)
            - pixel_resident(c_in, c_out, int8) - pixel_ring(rows))
    return max(0, min(8, free // (pixel_stage(c_out, True, int8, rows) + 24)))


def pixel_resident_smem(c_in: int, c_out: int, int8: bool = False, out_bytes: int = 2,
                        rows: int = PC_R) -> int:
    return (1024 + pixel_ring(rows) + pixel_resident_stages(c_in, c_out, int8, out_bytes, rows)
            * (pixel_stage(c_out, True, int8, rows) + 24) + pixel_epi(c_out, out_bytes)
            + pixel_resident(c_in, c_out, int8))


@dataclasses.dataclass(frozen=True)
class PixelPlan:
    form: str        # "wgmma" (csrc/wgmma_conv{,_s8}.cuh) or "mma" (pixel_conv.cu's own)
    rows: int        # output rows a tile
    px: int          # output pixels a tile
    stages: int
    tiles: int
    grid: int        # CTAs launched (mma: one a block of its own tiling; not read)
    smem: int        # dynamic shared memory a CTA, bytes (mma: 0, its own)
    resident: bool = False  # wgmma: the whole weight kept in shared memory

    @property
    def code(self) -> int:
        """The form's code in `csrc/pixel_conv.cu`'s entry point: 0 mma, 1
        wgmma with the weights a stage, 2 wgmma with the weight resident."""
        return 0 if self.form == "mma" else 2 if self.resident else 1


_OUT_BYTES = {"int8": 1, "bfloat16": 2, "float16": 2, "float32": 4}


def pixel_tall_plan(b: int, h: int, w: int, c_in: int, c_out: int,
                    sms: int = SMS) -> PixelPlan | None:
    """The 16-bit wgmma form on blockdot's tile of PC_TALL_R = 8 output rows
    (10 staged input rows, 1.25 an output row against the 4-row tile's
    1.5) for a shape `pixel_plan` takes in its 4-row form; None where it
    does not fit: H below its 10-row box, or fewer than two stages. The
    weight stays resident where that leaves as many stages as bringing it
    a step at a time would."""
    if h < PC_TALL_R + 2:
        return None
    tiles = b * cdiv(h, PC_TALL_R) * cdiv(w, PC_PX)
    streamed = pixel_stages(c_out, rows=PC_TALL_R)
    resident = pixel_resident_stages(c_in, c_out, rows=PC_TALL_R)
    if resident >= max(streamed, PC_TALL_MIN_STAGES):
        return PixelPlan("wgmma", PC_TALL_R, PC_PX, resident, tiles, min(tiles, sms),
                         pixel_resident_smem(c_in, c_out, rows=PC_TALL_R), True)
    if streamed >= PC_TALL_MIN_STAGES:
        return PixelPlan("wgmma", PC_TALL_R, PC_PX, streamed, tiles, min(tiles, sms),
                         pixel_smem(c_out, rows=PC_TALL_R))
    return None


def pixel_tall_takes(c_in: int, c_out: int) -> bool:
    """Whether blockdot takes its 8-row tile (where it fits): C_out 32 with
    C_in >= 96, six K steps a tile or more. Both tiles timed at ESRGAN x4's
    eight shapes on an H100 (`experiments/torch_xattn_blockdot_timing.py`,
    `chip_smoke.py`): the 8-row tile 3-7 % faster at 96, 128 and 160 -> 32;
    within 2 % at 64 -> 32 (four K steps a tile, where its epilogue's two
    turns weigh); 5-24 % slower at C_out 64 (3 stages against 4, and 128
    accumulators a thread)."""
    return c_out == 32 and c_in >= 96


# Cached: the wrappers plan every call (349 an ESRGAN forward), and the
# pure-Python plan held the int8-pixel forward's host walk.
@functools.lru_cache(maxsize=1024)
def pixel_plan(b: int, h: int, w: int, c_in: int, c_out: int, x_strides, dtype: str, *,
               out_dtype: str | None = None, aligned: bool = True, sms: int = SMS,
               tall: bool = False, out_strides=None) -> PixelPlan:
    """`pixel_conv_rowdot`'s (and `pixel_conv_rowdot_q`'s) kernel for x (B,
    H, C_in, W) at element strides `x_strides` (batch, row, channel; W
    contiguous) in `dtype` ("bfloat16", "float16", "float32" or, for
    rowdot_q, "int8"), out (B, H, C_out, W) at element strides
    `out_strides` (default: contiguous NHCW) in `out_dtype` (default x's;
    rowdot_q: "int8" under requant, else its float type); `aligned`: x's,
    the packed weight's and out's bases 16-byte aligned. `pixel_conv_patch`
    passes flat NCHW's strides for both, (C hw, W, hw) and (C_out hw, W,
    hw): the kernels read and store through 4-D maps at any strides.

    16-bit x: the wgmma form takes C_out 32 or 64, strides TMA can take
    (x's and out's strides and W multiples of 8 elements; the weight's rows
    read in groups of 8 channels: C_in % 8 == 0), and no box larger than
    its tensor (x's box: W >= 80 pixels, H >= PC_R + 2 rows, C_in >= 16
    channels); f32 keeps its full-f32 FMA kernel and the rest the mma.sync
    kernel.

    int8 x: the int8 wgmma form takes int8 or 16-bit out, C_out 32 or 64,
    16-byte strides (x's and out's strides, W and C_in multiples of 16) and
    boxes inside their tensors (W >= 96 pixels, H >= 6 rows, C_in >= 32);
    f32 out and the rest keep the mma.sync kernel.

    The weight stays resident where it leaves room for 4 stages of x (with
    3, ESRGAN's 160 -> 32 conv ran slower than with its weights brought a
    stage at a time); int8 also needs C_in >= 64 (the chunk's box).

    tall (`pixel_conv_blockdot`, 16-bit x): `pixel_tall_plan`'s 8-row tile
    where it fits and `pixel_tall_takes` the shape, else the 4-row plan above;
    the rest takes the mma.sync kernel's 4-row blocks (f32: its FMA
    kernel's 4-row blocks)."""
    out_dtype = out_dtype or dtype
    int8 = dtype == "int8"
    ob = _OUT_BYTES[out_dtype]
    if out_strides is None:
        out_strides = (h * c_out * w, c_out * w, w)
    if int8:
        strides_ok = (all(s % 16 == 0 and 0 < s < _MAX_STRIDE for s in x_strides)
                      and all(s % 16 == 0 and 0 < s * ob < _MAX_STRIDE for s in out_strides)
                      and w % 16 == 0 and c_in % 16 == 0)
        ok = (out_dtype in ("int8", "bfloat16", "float16") and strides_ok
              and w >= PQ_RAWPX and c_in >= PQ_CK)
        res_ok = c_in >= PQ_CHUNK
    else:
        strides_ok = (all(s % 8 == 0 and 0 < 2 * s < _MAX_STRIDE
                          for s in tuple(x_strides) + tuple(out_strides))
                      and w % 8 == 0 and c_in % 8 == 0)
        ok = (dtype in ("bfloat16", "float16") and out_dtype == dtype and strides_ok
              and w >= PC_RAWPX and c_in >= PC_CK)
        res_ok = True
    if ok and c_out in PC_COUT and aligned and h >= PC_XROWS and b >= 1:
        if tall and not int8 and pixel_tall_takes(c_in, c_out):
            p = pixel_tall_plan(b, h, w, c_in, c_out, sms)
            if p is not None:
                return p
        tiles = b * cdiv(h, PC_R) * cdiv(w, PC_PX)
        res_stages = pixel_resident_stages(c_in, c_out, int8, ob)
        if res_ok and res_stages >= PC_RES_STAGES:
            return PixelPlan("wgmma", PC_R, PC_PX, res_stages, tiles, min(tiles, sms),
                             pixel_resident_smem(c_in, c_out, int8, ob), True)
        return PixelPlan("wgmma", PC_R, PC_PX, pixel_stages(c_out, int8, ob), tiles,
                         min(tiles, sms), pixel_smem(c_out, int8, ob))
    rows, px = (1, 64) if dtype == "float32" else (2, 128)  # pixel_conv.cu's blocks
    if tall:
        rows = 4
    tiles = b * cdiv(h, rows) * cdiv(w, px)
    return PixelPlan("mma", rows, px, 0, tiles, tiles * cdiv(c_out, 64), 0)


# -- int4_matmul (csrc/int4_matmul.cu's wgmma form) ---------------------------

I4_ROWS = 64     # packed rows a stage: the W box's rows
I4_COLS = 128    # W columns a tile: the W box's columns
I4_MT = 8        # x rows a slab: the wgmma's n
I4_STAGE = I4_ROWS * I4_COLS + 2 * I4_MT * I4_ROWS * 2 + 2 * I4_COLS * 4
I4_STAGES = 8
I4_CTAS = 2      # CTAs an SM
I4_SMEM = 1024 + I4_STAGES * (I4_STAGE + 16) + 16


@dataclasses.dataclass(frozen=True)
class Int4Plan:
    form: str     # "wgmma" or "mma"
    tiles: int    # tiles of I4_COLS W columns (wgmma); of 32 (mma)
    chunks: int   # K chunks a tile, each of whole groups (wgmma); 1 (mma)
    items: int    # tiles x chunks (the work units at M <= 8; one a slab of 8 rows at more)
    grid: int     # CTAs of the persistent wgmma kernel at M <= 8 (I4_CTAS an SM); tiles (mma)
    smem: int     # dynamic shared memory a CTA, bytes

    @property
    def code(self) -> int:
        """The form's code at the entry point (`form`)."""
        return {"mma": 0, "wgmma": 1}[self.form]

    def chunk_groups(self, ngh: int, chunk: int) -> range:
        """The packed-row groups of K chunk `chunk` of a tile, in order."""
        return range(chunk * ngh // self.chunks, (chunk + 1) * ngh // self.chunks)

    def whole(self, M: int) -> bool:
        """Whether a work unit walks a tile's K chunks itself, folding their
        partials in chunk order (where the (tile, 8-row slab) pairs cover
        three quarters of the card: at llama_1b's shapes q/o and down at M
        64, not k/v at 64 or gate/up at 16), rather than one chunk a unit
        summed by the last behind a counter. Either way a row's arithmetic
        is the same: this picks who adds, not the order."""
        return (self.form == "wgmma" and self.chunks > 1
                and self.tiles * cdiv(M, I4_MT) >= 3 * SMS // 4)


@functools.lru_cache(maxsize=256)
def int4_plan(N: int, K: int, group: int) -> Int4Plan:
    """`int4_matmul`'s kernel for a (K/2, N) packed weight in groups of
    `group` rows a half, whatever M: "wgmma" where the TMA maps can read
    the weight in 64-row x 128-column boxes (N % 128, group % 64, K %
    (2 group)), else "mma". The wgmma form splits each tile's ngh = K / 2 /
    group groups into `chunks` runs of whole groups; it takes the split
    with the fewest groups on the busiest of SMS CTAs (waves x groups an
    item), the fewest chunks among equals (each chunk beyond one costs a
    partial's store and sum)."""
    if N <= 0 or K <= 0 or group <= 0 or K % (2 * group):
        raise ValueError(f"int4_plan: K {K} is not a whole number of groups of {group} a half")
    if N % I4_COLS or group % I4_ROWS:
        tiles = cdiv(N, 32)
        return Int4Plan("mma", tiles, 1, tiles, tiles, 0)
    tiles, ngh = N // I4_COLS, K // 2 // group
    chunks = min(range(1, ngh + 1),
                 key=lambda c: (cdiv(tiles * c, SMS) * cdiv(ngh, c), c))
    items = tiles * chunks
    return Int4Plan("wgmma", tiles, chunks, items, min(items, I4_CTAS * SMS), I4_SMEM)
