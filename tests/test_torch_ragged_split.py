"""The split-KV walk of `ragged_decode_attention`'s Hopper kernel
(`csrc/decode_attention.cuh`'s `split_chunk` and `split_combine`), replayed
in plain PyTorch and held to the JAX package's Pallas kernel in interpret
mode (`smelter_tpu/kernels/ragged_decode_attention.py`, as
tests/test_torch_decode.py runs it), and its plan, checked without a card:

- the walk: row blocks of `rows` cache rows; in each, warp w of 4 takes the
  row pairs 2w + 8t, t = 0, 1, ..., whatever g*c, with a streaming softmax
  in f32 advanced a pair at a time (running max, sum, f32 sums over hd),
  merged in warp order into the block's partial; a block wholly past the frontier is the neutral
  partial (-inf, 0, 0); a slot's partials merged in block order. Held within
  1e-5 in f32 with blocks forced small enough to split: frontiers on a
  block's first and last row, blocks wholly past the frontier, pos + c - 1
  past the cache, c 5, g*c 10 (llama_1b's chunk-5 verify), 16 and 20 (two
  row groups), head dim 32 (the tiny draft's), int8 and float caches,
  stale rows past every frontier filled with large values (never read);
- the wrappers' operand checks (both kernels) take g*c 10, 16 and 20 and
  head dim 32, which the kernels now run;
- `split_plan`: a function of (B, kvh, L) alone, whole blocks of 32 rows
  covering the cache, at most 256 of them a slot, and at least 128 CUDA
  blocks for one llama_1b slot at L 512.
"""

import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smelter_tpu.kernels import ragged_decode_attention as jrda
from smelter_tpu_torch.kernels import ragged_decode_attention as rda

WARPS = 4
NEG = float("-inf")


def _merge(states):
    """(m, l, acc) states merged in order, as split_chunk merges its warps
    and split_combine a slot's blocks: weights exp(m - max), 0 for -inf."""
    M = torch.stack([m for m, _, _ in states]).amax(0)
    l_sum = torch.zeros_like(M)
    acc = torch.zeros_like(states[0][2])
    for m, l_, a in states:
        f = torch.where(m == NEG, torch.zeros_like(m), torch.exp(m - M))
        acc = acc + a * f[:, None]
        l_sum = l_sum + l_ * f
    return M, l_sum, acc


def _split_emulation(q, k, v, pos, ks, vs, *, c, scale, rows):
    """The two passes on f32 tensors: q (B, kvh, gc, hd), caches (B, L,
    kvh*hd), scales (B, L, 1) or None."""
    B, kvh, gc, hd = q.shape
    L = k.shape[1]
    nblk = math.ceil(L / rows)
    out = torch.empty(B, kvh, gc, hd)
    for b in range(B):
        p = int(pos[b])
        last = p + c - 1
        live_blocks = min(last, L - 1) // rows + 1
        for h in range(kvh):
            qh = q[b, h].float()
            partials = []
            for j in range(nblk):
                if j >= live_blocks:  # wholly past the frontier
                    partials.append((torch.full((gc,), NEG), torch.zeros(gc),
                                     torch.zeros(gc, hd)))
                    continue
                lo = j * rows
                live = min(rows, last - lo + 1, L - lo)
                warps = []
                for w in range(WARPS):
                    m, l_, acc = torch.full((gc,), NEG), torch.zeros(gc), torch.zeros(gc, hd)
                    for r0 in range(2 * w, live, 2 * WARPS):  # its row pairs
                        rr = torch.arange(r0, min(r0 + 2, live))
                        kk = k[b, lo + rr, h * hd:(h + 1) * hd].float()
                        vv = v[b, lo + rr, h * hd:(h + 1) * hd].float()
                        ksr = ks[b, lo + rr, 0].float() if ks is not None else torch.ones(len(rr))
                        vsr = vs[b, lo + rr, 0].float() if vs is not None else torch.ones(len(rr))
                        s = (qh @ kk.T) * ksr * scale  # (gc, rows of the pair)
                        ok = (lo + rr)[None] <= p + torch.arange(gc)[:, None] % c
                        s = torch.where(ok, s, NEG)
                        m_new = torch.maximum(m, s.amax(1))
                        pr = torch.where(ok, torch.exp(s - m_new[:, None]), 0.0)
                        alpha = torch.where(m_new == NEG, torch.ones_like(m),
                                            torch.exp(m - m_new))
                        l_ = alpha * l_ + pr.sum(1)
                        acc = acc * alpha[:, None] + (pr * vsr) @ vv
                        m = m_new
                    warps.append((m, l_, acc))
                partials.append(_merge(warps))
            _, l_, acc = _merge(partials)
            out[b, h] = acc / l_[:, None]
    return out.to(q.dtype)


def _case(B, kvh, g, c, hd, L, pos, quant, seed):
    """Operands with every row past each slot's frontier filled with large
    values (1e6, or int8 rows with scales of 1e6)."""
    rng = np.random.default_rng(seed)
    kvd = kvh * hd
    q = rng.standard_normal((B, kvh, g * c, hd)).astype(np.float32)
    pos = np.asarray(pos, np.int64)
    stale = np.arange(L)[None] > (pos + c - 1)[:, None]  # (B, L)
    if quant:
        k, v = (rng.integers(-127, 128, (B, L, kvd)).astype(np.int8) for _ in range(2))
        ks, vs = (np.where(stale[..., None], np.float32(1e6),
                           rng.uniform(1e-3, 2e-2, (B, L, 1)).astype(np.float32))
                  for _ in range(2))
    else:
        k, v = (np.where(stale[..., None], np.float32(1e6),
                         rng.standard_normal((B, L, kvd)).astype(np.float32)) for _ in range(2))
        ks = vs = None
    return q, k, v, pos, ks, vs


# (B, kvh, g, c, L, pos, rows[, hd]): the frontier on a block's first row
# (32, rows 32) and last (63); blocks wholly past the frontier; pos + c - 1
# past the cache (c 5 at pos L - 2); a single slot split into blocks of 8
# rows; g*c 8; llama_1b's verify (g 2, c 5: g*c 10) with its frontier past
# the cache; g*c 16 and 20 (two row groups); the tiny draft's head dim 32
CASES = [
    (3, 2, 2, 1, 96, [32, 63, 0], 32),
    (2, 2, 1, 5, 64, [62, 17], 16),
    (1, 2, 2, 1, 48, [40], 8),
    (2, 1, 4, 2, 80, [5, 78], 32),
    (2, 2, 2, 5, 96, [33, 93], 32),
    (2, 1, 4, 4, 64, [7, 61], 32),
    (1, 2, 4, 5, 64, [30], 32),
    (3, 4, 2, 1, 80, [0, 31, 79], 32, 32),
]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("quant", [False, True])
def test_split_emulation_matches_pallas(case, quant):
    B, kvh, g, c, L, pos, rows = case[:7]
    hd = case[7] if len(case) > 7 else 128
    q, k, v, pos, ks, vs = _case(B, kvh, g, c, hd, L, pos, quant, seed=B * 10 + c)
    kw = dict(c=c, kv_heads=kvh, scale=hd ** -0.5)
    t = (lambda a: None if a is None else torch.from_numpy(a.copy()))
    got = _split_emulation(t(q), t(k), t(v), t(pos), t(ks), t(vs), c=c, scale=hd ** -0.5,
                           rows=rows).numpy()
    assert np.isfinite(got).all()
    j = (lambda a: None if a is None else jnp.asarray(a))
    for b in range(B):
        want = np.asarray(jrda.ragged_decode_attention(
            j(q[b]), j(k[b]), j(v[b]), int(pos[b]), j(None if ks is None else ks[b]),
            j(None if vs is None else vs[b]), interpret=True, **kw))
        assert np.abs(got[b] - want).max() <= 1e-5 * np.abs(want).max()
    # the wrapper's CPU path (the plain version) agrees with the walk
    plain = rda.ragged_decode_attention(t(q), t(k), t(v), t(pos), t(ks), t(vs), **kw).numpy()
    assert np.abs(plain - got).max() <= 1e-5 * np.abs(got).max()
    assert rda.launches == 0


def test_split_plan_is_a_function_of_the_shape():
    assert list(inspect.signature(rda.split_plan).parameters) == ["B", "kvh", "L"]
    for B, kvh, L in [(1, 8, 512), (8, 8, 512), (8, 8, 4096), (3, 2, 64), (1, 1, 1),
                      (64, 8, 512), (2, 4, 100), (1, 1, 1 << 16)]:
        rows, nblk = rda.split_plan(B, kvh, L)
        assert rows % 32 == 0 and rows >= 32 and nblk <= 256
        assert nblk == math.ceil(L / rows) and (nblk - 1) * rows < L <= nblk * rows
        assert rda.split_plan(B, kvh, L) == (rows, nblk)
    rows, nblk = rda.split_plan(1, 8, 512)  # FusedGenerator's slot at llama_1b
    assert 8 * nblk >= 128
    rows, nblk = rda.split_plan(8, 8, 512)  # the DecodeServer's 8 slots
    assert 64 * nblk >= 2 * 132


WIDE = [(8, 4, 2, 5, 128), (8, 4, 4, 4, 128), (2, 1, 4, 5, 64), (8, 4, 2, 1, 32),
        (8, 4, 2, 5, 32), (2, 2, 2, 1, 256), (2, 2, 4, 5, 256)]


@pytest.mark.parametrize("shape", WIDE, ids=[f"b{b}_kvh{h}_g{g}_c{c}_hd{d}"
                                             for b, h, g, c, d in WIDE])
def test_wrappers_take_wide_groups_and_hd32(shape):
    """Both wrappers' operand checks pass at g*c 10 (llama_1b's chunk-5
    verify), 16 and 20 and at head dim 32 (the tiny draft's): the kernels
    run those shapes (in groups of 16 query rows, 8 at hd 256), so a CUDA
    tensor of them launches and does not raise."""
    from smelter_tpu_torch.kernels import paged_decode_attention as pda

    B, kvh, g, c, hd = shape
    L, ps = 64, 32
    q = torch.zeros(B, kvh, g * c, hd, dtype=torch.bfloat16)
    k = torch.zeros(B, L, kvh * hd, dtype=torch.int8)
    sc = torch.ones(B, L, 1, dtype=torch.bfloat16)
    pos = torch.zeros(B, dtype=torch.int64)
    rda._check(q, k, k.clone(), pos, sc, sc.clone(), c, kvh)
    pool = torch.zeros(1 + B * L // ps, ps, kvh * hd, dtype=torch.bfloat16)
    table = torch.arange(1, 1 + B * L // ps, dtype=torch.int32).reshape(B, L // ps)
    pda._check(q, pool, pool.clone(), table, pos, None, None, c, kvh)
    with pytest.raises(ValueError):  # c must divide g*c
        rda._check(q, k, k.clone(), pos, sc, sc.clone(), 3, kvh)
    with pytest.raises(ValueError):
        pda._check(q, pool, pool.clone(), table, pos, None, None, 3, kvh)
