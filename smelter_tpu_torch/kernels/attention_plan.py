"""Which form of `csrc/wgmma_attention.cuh` an attention call takes, from its
shape and stated conditions alone.

Pure functions of the shape, the strides and a few flags, so the CPU tests
can check them; the header's constants (`StreamCfg`, `NormCfg`) give the
same sizes. Both forms run CTAs of two consumer warpgroups (64 query rows
each, 128 a CTA) and a producer warpgroup, one CTA an SM, at most 227 KB of
shared memory, and tiles of 128 keys (the scores of a tile, 64 registers a
thread, beside P and the output in a thread's 168):

- "streaming" (`ring_attention_rdma`'s bf16/f16 step, `flash_attention`'s
  bf16/f16 call; hd 32, 64, 128): K and V stream through a ring of
  `stages` stages of 128-key tiles, as many as fit beside Q, at most 4; a
  CTA takes 128 query rows of one (batch, head).
- "one_pass" and "resident" (`vit_attention_block`'s attention and
  `short_attention`'s bf16/f16 call; hd 16, 32, 64, 128): a work item (128
  query rows of one image and head) takes Q and all its keys' K and V into
  one buffer at once, in `tiles` tiles of `key_tile` keys. Up to two tiles
  (N <= 256): one pass over K, the first tile's exps staged in shared
  memory (64 KB a CTA) while the second's scores take the registers. More:
  K and V resident, a second pass recomputes the scores from shared memory.
  `stages` buffers (two where they fit) let the producer fill the next
  item's while the consumers work; the grid is persistent.
- "mma": what the new forms do not take keeps the earlier kernels: f32 (the
  warp-per-row kernels), head dims outside the form's set, operands whose
  strides or bases a TMA map cannot take, and K and V past shared memory
  (hd 64 past 768 keys, hd 128 past 384): `csrc/vit_block.cu`'s,
  `csrc/attention_short.cu`'s and `csrc/flash_attention.cu`'s own kernels.

`cross_plan` picks `cross_attn_block`'s kernel (`csrc/cross_attn_block.cu`):
"wgmma" for 16-bit x with D a multiple of 64 (a CTA a 64-row tile x a group
of 64 / hd heads, the D / 64 groups of a row tile one cluster sharing their
attention outputs through distributed shared memory, each CTA then the
output columns of its group), "mma" (one block of 4 warps a 64-row tile on
mma.sync) for the other 16-bit shapes, "f32" (the CUDA-core kernel) for
f32, "none" for what no kernel takes (the wrapper raises).

`short_attention` and `flash_attention` read q, k and v through 4-D maps
(hd, N, H, B) of their element strides, so the (B, H, N, hd) views of (B, N,
H, hd) tensors a graph hands over are read in place. A map needs its base
16-byte aligned and each stride a positive 16-byte multiple below 2^40
(`views_ok`). The choice is made by shape and these conditions, never by
catching a failure.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

WG_ROWS, CONSUMERS = 64, 2
Q_ROWS = WG_ROWS * CONSUMERS   # query rows a CTA
SMEM_LIMIT = 232_448           # 227 KB, what one block may have on an H100
SMS = 132                      # streaming multiprocessors of an H100 SXM
KEY_TILE = 128
STREAM_HEAD_DIMS = (32, 64, 128)
HEAD_DIMS = (16, 32, 64, 128)
MAX_GRID_Y = 65_535            # a launch's grid.y: the streaming form's B H


@dataclasses.dataclass(frozen=True)
class AttnPlan:
    form: str        # "streaming", "one_pass", "resident" or "mma"
    consumers: int   # consumer warpgroups a CTA (0 for "mma")
    key_tile: int    # keys a tile: the scores' wgmma N
    tiles: int       # key tiles an item holds at once (one_pass / resident)
    stages: int      # ring stages (streaming) or item buffers (one_pass / resident)
    grid: int        # CTAs launched (0: the launch computes it)
    smem: int        # dynamic shared memory a CTA, bytes

    @property
    def code(self) -> int:
        """The form's code in the entry points of `csrc/vit_block.cu`,
        `attention_short.cu` and `flash_attention.cu` (1: the new core's
        form, 0: the file's earlier kernels)."""
        return 0 if self.form == "mma" else 1


MMA = AttnPlan("mma", 0, 0, 0, 0, 0, 0)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def stream_stages(hd: int) -> int:
    """attn_stream's stages: as many as fit beside Q and its barrier, at
    most 4 (StreamCfg::STAGES)."""
    fixed = 1024 + Q_ROWS * hd * 2 + 8
    return min(4, (SMEM_LIMIT - fixed) // (2 * KEY_TILE * hd * 2 + 16))


def stream_smem(hd: int) -> int:
    return 1024 + Q_ROWS * hd * 2 + 8 + stream_stages(hd) * (2 * KEY_TILE * hd * 2 + 16)


def norm_buffer(hd: int, tiles: int) -> int:
    """One work item's bytes: Q, then its K tiles, then its V tiles."""
    return Q_ROWS * hd * 2 + 2 * tiles * KEY_TILE * hd * 2


STAGED = CONSUMERS * WG_ROWS * KEY_TILE * 4  # two tiles: the first's f32 exps


def norm_smem(hd: int, tiles: int, buffers: int) -> int:
    """NormCfg::smem: alignment, the buffers and two mbarriers each, and
    with two tiles the staged exps."""
    return 1024 + buffers * (norm_buffer(hd, tiles) + 16) + (STAGED if tiles == 2 else 0)


def ring_plan(Nq: int, BH: int, hd: int, *, sixteen_bit: bool) -> AttnPlan:
    """A ring step of q (BH, Nq, hd): "streaming" for a 16-bit type at hd
    32, 64 or 128, else "mma" (the f32 kernel, or the wrapper raises)."""
    if not sixteen_bit or hd not in STREAM_HEAD_DIMS:
        return MMA
    return AttnPlan("streaming", CONSUMERS, KEY_TILE, 1, stream_stages(hd),
                    cdiv(Nq, Q_ROWS) * BH, stream_smem(hd))


def views_ok(strides, *, aligned: bool = True) -> bool:
    """Whether 4-D TMA maps take 16-bit operands of these (batch, head, row)
    element strides (one triple an operand): bases 16-byte aligned, each
    stride a positive 16-byte multiple below 2^40 bytes."""
    return aligned and all(0 < 2 * s < 2 ** 40 and 2 * s % 16 == 0
                           for triple in strides for s in triple)


def _norm_plan(B: int, N: int, heads: int, hd: int, sms: int) -> AttnPlan:
    """The normalised form for B images of N tokens, `heads` heads of hd
    (16-bit): one pass or resident tiles, buffers, the persistent grid; MMA
    where K and V do not fit."""
    if hd not in HEAD_DIMS or N < 1:
        return MMA
    tiles = cdiv(N, KEY_TILE)
    staged = STAGED if tiles == 2 else 0
    buffers = min(2, (SMEM_LIMIT - 1024 - staged) // (norm_buffer(hd, tiles) + 16))
    if buffers < 1:
        return MMA
    items = B * heads * cdiv(N, Q_ROWS)
    return AttnPlan("one_pass" if tiles <= 2 else "resident", CONSUMERS, KEY_TILE, tiles, buffers,
                    min(items, sms), norm_smem(hd, tiles, buffers))


def vit_plan(B: int, N: int, heads: int, hd: int, *, sixteen_bit: bool,
             sms: int = SMS) -> AttnPlan:
    """`vit_attention_block`'s attention at B images of N tokens, `heads`
    heads of hd: the form, its tiles and buffers, the persistent grid. The
    operands' strides (3 D and D elements a row) are 16-byte multiples
    whenever hd % 8 == 0, which the wrapper requires."""
    return _norm_plan(B, N, heads, hd, sms) if sixteen_bit else MMA


def short_plan(B: int, H: int, N: int, hd: int, strides, dtype, *, aligned: bool = True,
               sms: int = SMS) -> AttnPlan:
    """`short_attention` over q, k, v and out (B, H, N, hd) of `dtype` at
    `strides` (their (batch, head, row) element strides, in that order;
    `aligned`: every base 16-byte aligned): the normalised form for bf16/f16
    at hd 16, 32, 64, 128 where TMA takes the strides and K and V fit
    shared memory (N <= 512 everywhere but hd 128, to 384), else "mma"."""
    if dtype not in (torch.bfloat16, torch.float16) or not views_ok(strides, aligned=aligned):
        return MMA
    return _norm_plan(B, N, H, hd, sms)


def flash_plan(B: int, H: int, Nq: int, Nk: int, hd: int, strides, dtype, *,
               aligned: bool = True) -> AttnPlan:
    """`flash_attention` over q, out (B, H, Nq, hd) and k, v (B, H, Nk, hd)
    of `dtype` at `strides` (q, k, v, out, as `short_plan`'s): the streaming
    form, one CTA a (128 query rows, batch, head), for bf16/f16 at hd 32, 64,
    128 where TMA takes the strides (and B H fits the grid's y), else
    "mma"."""
    if dtype not in (torch.bfloat16, torch.float16) or not views_ok(strides, aligned=aligned) \
            or Nq < 1 or Nk < 1 or B * H > MAX_GRID_Y:
        return MMA
    return ring_plan(Nq, B * H, hd, sixteen_bit=True)


# -- cross_attn_block (csrc/cross_attn_block.cu) ------------------------------

XG_COLS = 64               # a head group's columns of Wq, Wp and the output
XG_ROWS = 64               # query rows a CTA (the wgmma form's M; the mma form's block)
XF_ROWS = 16               # query rows a block of the f32 kernel
CROSS_HEAD_DIMS = (16, 32, 64)
CROSS_MAX_D, CROSS_MAX_S = 256, 64


@dataclasses.dataclass(frozen=True)
class CrossPlan:
    form: str        # "wgmma", "mma", "f32" or "none"
    groups: int      # head groups a row tile (wgmma: the cluster's CTAs), else 1
    heads: int       # heads a group (wgmma: 64 / hd), else all
    grid: tuple      # the launch's grid (x, y, z)
    cluster: int     # CTAs a cluster (1: none)
    smem: int        # dynamic shared memory a CTA, bytes (f32: 0, static)

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def code(self) -> int:
        """The form's code in `smelter_cross_attn_block`: 1 wgmma, else 0."""
        return 1 if self.form == "wgmma" else 0


def cross_keys(S: int) -> int:
    """SP: the keys a head's tile holds, S rounded up to 16, 32 or 64."""
    return 16 if S <= 16 else 32 if S <= 32 else 64


def cross_smem(D: int, S: int) -> int:
    """xg_smem: alignment, x, Wq's and Wp's group columns (128 D bytes each;
    the row tile's attention output takes x's once q is made), the group's k
    and v (128 SP each), three mbarriers."""
    return 1024 + 3 * 128 * D + 2 * 128 * cross_keys(S) + 3 * 8


def cross_mma_smem(D: int, heads: int, S: int) -> int:
    """xattn_smem_bytes: x and q tiles (64 rows of D + 8), a weight pass (D
    rows of 72) and every head's k and v (SP rows of hd + 8), 16-bit."""
    hd = D // heads
    return (2 * XG_ROWS * (D + 8) + D * 72 + 2 * heads * cross_keys(S) * (hd + 8)) * 2


# Cached: five calls an SD-UNet forward plan the same two shapes.
@functools.lru_cache(maxsize=256)
def cross_plan(B: int, N: int, D: int, heads: int, S: int, dtype) -> CrossPlan:
    """`cross_attn_block`'s kernel for x (B, N, D) of `dtype`, `heads` heads
    and S keys: the wgmma form for bf16/f16 at D % 64 == 0 (grid (D / 64,
    N / 64, B), clusters of D / 64), the mma.sync form for other 16-bit
    shapes, the f32 kernel for f32; "none" past what the kernels take (hd
    16, 32 or 64, D <= 256, 1 <= S <= 64)."""
    hd = D // heads if heads > 0 and D % heads == 0 else 0
    if hd not in CROSS_HEAD_DIMS or D > CROSS_MAX_D or not 1 <= S <= CROSS_MAX_S:
        return CrossPlan("none", 0, 0, (0, 0, 0), 1, 0)
    if dtype == torch.float32:
        return CrossPlan("f32", 1, heads, (cdiv(N, XF_ROWS), B, 1), 1, 0)
    tiles = cdiv(N, XG_ROWS)
    if D % XG_COLS == 0 and tiles <= MAX_GRID_Y and B <= MAX_GRID_Y:
        groups = D // XG_COLS
        return CrossPlan("wgmma", groups, XG_COLS // hd, (groups, tiles, B), groups,
                         cross_smem(D, S))
    return CrossPlan("mma", 1, heads, (tiles, B, 1), 1, cross_mma_smem(D, heads, S))
