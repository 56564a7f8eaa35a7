"""The shape-to-form choice of the wgmma/TMA GEMM core
(`smelter_tpu_torch/kernels/wgmma_plan.py`), which `dequant_matmul`,
`collective_matmul_ag` and `collective_matmul_rs` call before each launch, checked as the kernels of
`csrc/wgmma_gemm.cuh` walk a plan: every output tile and every K range is
taken exactly once, a cluster has at most 8 CTAs, each form's shared memory
fits the 227 KB a block may have, and the plan's constants are the header's.
A pure function, so no card is needed."""

import re
from pathlib import Path

import pytest

from smelter_tpu_torch.kernels import wgmma_plan as wp

HEADER = (Path(__file__).resolve().parents[1] / "smelter_tpu_torch" / "csrc"
          / "wgmma_gemm.cuh").read_text()

# dequant_matmul's card-test shapes (M x N x K), the ResNet-50 head, the
# serving GEMM; collective_matmul_ag's step shapes (M/P x N/P x K) at
# ViT-B/16 b128 and llama_1b over 4 ranks and phase 13's odd ones.
DEQUANT = [(m, n, k) for m in (1, 7, 128, 129, 8192) for n in (8, 1000, 1001, 4096)
           for k in (8, 72, 2048, 2056, 4096)]
AG = [(6304, 768, 768), (1024, 1408, 2048), (37, 33, 70), (37, 33, 200), (300, 200, 256),
      (1000, 64, 512), (3, 5, 20), (25216, 3072, 768)]
# collective_matmul_rs's step shapes (M/P x N x K/P): ViT-B/16 b128's MLP
# down and llama_1b's FFN down over 4 ranks, the same over 8 and 1, the card
# tests' odd shards and their recv-aliasing step.
RS = [(6304, 768, 768), (1024, 2048, 1408), (3152, 768, 384), (512, 2048, 704),
      (25216, 768, 3072), (4096, 2048, 5632), (37, 33, 70), (1024, 1152, 768)]


def _walk(p: wp.Plan, M: int, N: int, K: int) -> None:
    """Replays the kernel's indexing and asserts each (tile, K row) is
    summed exactly once and each output element stored exactly once."""
    mt, nt = wp.cdiv(M, p.bm), wp.cdiv(N, p.bn)
    if p.form == "tma":
        taken = [t for b in range(p.grid) for t in range(b, mt * nt, p.grid)]
        assert sorted(taken) == list(range(mt * nt))
        assert p.k_chunk == K and p.split == 1 and p.grid <= wp.SMS
        return
    assert p.grid == mt * nt * p.split
    assert p.k_chunk % wp.BK == 0 and p.k_chunk > 0
    ranges = [(z * p.k_chunk, min(K, (z + 1) * p.k_chunk)) for z in range(p.split)]
    covered = [k for lo, hi in ranges for k in range(lo, hi)]
    assert covered == list(range(K))  # disjoint, in order, all of K
    assert all(hi > lo for lo, hi in ranges) or K == 0  # no rank without K rows
    rows = [r for rank in range(p.split)
            for r in range(rank * p.bm // p.split, (rank + 1) * p.bm // p.split)]
    assert rows == list(range(p.bm))  # the ranks' slices of the partial sum


@pytest.mark.parametrize("M,N,K", DEQUANT)
def test_dequant_plan_covers_every_tile_and_k_row_once(M, N, K):
    p = wp.plan(M, N, K, int8_b=True)
    _walk(p, M, N, K)
    assert 1 <= p.split <= wp.MAX_CLUSTER and p.smem <= wp.SMEM_LIMIT
    if p.form == "tma":
        assert K % 8 == 0 and N % 16 == 0 and p.bn == 128
        assert M >= 128 and K >= 64 and N >= p.bn
        assert wp.cdiv(M, 128) * wp.cdiv(N, 128) >= wp.SMS // 2


@pytest.mark.parametrize("M,N,K", AG)
@pytest.mark.parametrize("aligned", [True, False])
def test_ag_plan_covers_every_tile_and_k_row_once(M, N, K, aligned):
    p = wp.plan(M, N, K, int8_b=False, aligned=aligned)
    _walk(p, M, N, K)
    assert 1 <= p.split <= wp.MAX_CLUSTER and p.smem <= wp.SMEM_LIMIT
    if not aligned:
        assert p.form == "cluster"
    if p.form == "tma":
        assert K % 8 == 0 and N % 8 == 0 and p.bn == 128
        assert M >= 128 and K >= 64 and N >= p.bn


@pytest.mark.parametrize("M,N,K", RS)
@pytest.mark.parametrize("aligned", [True, False])
def test_rs_plan_covers_every_tile_and_k_row_once(M, N, K, aligned):
    """`aligned` covers a, b, recv and out: the tma form's rs epilogue
    moves recv and out in 16-byte chunks."""
    p = wp.plan(M, N, K, int8_b=False, aligned=aligned)
    _walk(p, M, N, K)
    assert 1 <= p.split <= wp.MAX_CLUSTER and p.smem <= wp.SMEM_LIMIT
    if not aligned:
        assert p.form == "cluster"
    if p.form == "tma":
        assert K % 8 == 0 and N % 8 == 0 and p.bn == 128
        assert M >= 128 and K >= 64 and N >= p.bn
        assert wp.tma_smem(p.bn, False, recv=True) <= wp.SMEM_LIMIT


def test_the_shapes_that_ranked_the_kernels():
    """The head splits K over clusters of 8 (16 N tiles x 8 = 128 CTAs,
    4 K steps each); the serving GEMM and both ag steps take the
    persistent TMA kernel on 128 x 128 tiles: ViT-B/16's step 300 tiles,
    llama_1b's 88 (one wave, 132 CTAs would leave 44 idle)."""
    head = wp.plan(128, 1000, 2048, int8_b=True)
    assert (head.form, head.split, head.k_chunk, head.grid) == ("cluster", 8, 256, 128)
    serving = wp.plan(8192, 4096, 4096, int8_b=True)
    assert (serving.form, serving.bn, serving.grid) == ("tma", 128, 132)
    vit = wp.plan(6304, 768, 768, int8_b=False)
    assert (vit.form, vit.bn, vit.grid) == ("tma", 128, 132)
    llama = wp.plan(1024, 1408, 2048, int8_b=False)
    assert (llama.form, llama.bn, llama.grid) == ("tma", 128, 88)
    # rs's steps: ViT-B/16's the same 300 tiles as ag's, llama_1b's 128; the
    # card tests' odd shards take the cluster form
    assert (wp.plan(6304, 768, 768, int8_b=False).form, wp.plan(1024, 2048, 1408, int8_b=False)
            .grid) == ("tma", 128)
    assert wp.plan(37, 33, 70, int8_b=False).form == "cluster"
    # fewer SMs: the split shrinks with the card
    assert wp.plan(128, 1000, 2048, int8_b=True, sms=64).split == 4


def test_plan_constants_are_the_headers():
    nums = dict(re.findall(r"\b(BM|BK|ATOM|CONSUMERS|CL_BN|CL_STAGES|CL_THREADS)\s*=\s*(\d+)",
                           HEADER))
    assert {k: int(v) for k, v in nums.items()} == {
        "BM": wp.BM, "BK": wp.BK, "ATOM": wp.ATOM, "CONSUMERS": wp.CONSUMERS,
        "CL_BN": wp.CL_BN, "CL_STAGES": wp.CL_STAGES, "CL_THREADS": 128 * wp.CONSUMERS}
    assert re.search(r"SMEM_BUDGET = 225 \* 1024;", HEADER) and wp.SMEM_BUDGET == 225 * 1024
    assert "232448" in HEADER and wp.SMEM_LIMIT == 232_448
    # the sizes the header's comment states
    for bn, int8_b, stages in ((128, False, 6), (128, True, 8)):
        assert wp.tma_stages(bn, int8_b) == stages
        kind = "int8" if int8_b else "bf16"
        assert re.search(rf"BN {bn} {kind}( \(.*\))?: {stages} stages, "
                         rf"{wp.tma_smem(bn, int8_b):,}", HEADER)
    assert f"{wp.CLUSTER_SMEM:,}" in HEADER
    # rs's recv tile takes the sub-tiles' place and one stage's
    assert wp.tma_stages(128, False, recv=True) == 5
    assert re.search(rf"BN 128 bf16 with recv .*\n//\s+5 stages, {wp.tma_smem(128, False, True):,}",
                     HEADER)
    assert wp.plan(8192, 4096, 4096, int8_b=True).code == 1
    assert wp.plan(128, 1000, 2048, int8_b=True).code == 2
