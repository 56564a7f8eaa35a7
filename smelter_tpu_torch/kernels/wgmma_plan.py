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
"""

from __future__ import annotations

import dataclasses

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
        return {"tma": 1, "cluster": 2}[self.form]


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


EPI = CONSUMERS * 64 * 64 * 4  # gemm_tma's epilogue sub-tiles, one a warpgroup


def tma_stages(bn: int, int8_b: bool) -> int:
    """Stages of the tma form: as many as fit the budget, at most 8."""
    stage = BM * BK * 2 + BK * bn * (1 if int8_b else 2)
    return min(8, (SMEM_BUDGET - 1024 - (0 if int8_b else EPI)) // stage)


def tma_smem(bn: int, int8_b: bool) -> int:
    stage = BM * BK * 2 + BK * bn * (1 if int8_b else 2)
    return 1024 + tma_stages(bn, int8_b) * (stage + 16) + (0 if int8_b else EPI)


CLUSTER_SMEM = 1024 + CL_STAGES * (BM * BK * 2 + BK * CL_BN * 2)


def plan(M: int, N: int, K: int, *, int8_b: bool, aligned: bool = True,
         sms: int = SMS) -> Plan:
    """The form, tile and split for out (M, N) = A (M, K) @ B (K, N), A
    16-bit, B int8 (`int8_b`) or 16-bit. `aligned`: both bases 16-byte
    aligned."""
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
