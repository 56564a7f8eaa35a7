"""The sub-page split-KV walk of `paged_decode_attention`'s Hopper kernels
(`csrc/decode_attention.cuh`'s `split_chunk` and `split_combine` over
`PagedRows`), replayed in plain PyTorch and held to the JAX package's
Pallas kernel in interpret mode (`smelter_tpu/kernels/
paged_decode_attention.py`, as tests/test_torch_paged.py runs it), and its
plan, checked without a card:

- the walk: each page cut into `split` blocks of ps / split rows; block j
  of slot b is run j % split of page table[b, j // split], clamped into the
  pool; in a block, warp w of 4 takes the row pairs 2w + 8t, t = 0, 1, ...,
  whatever g*c, with a streaming softmax in f32 advanced a pair at a time
  (running max, sum, f32 sums over hd), merged in warp order into the
  block's partial; a
  block wholly past the frontier is the neutral partial (-inf, 0, 0); a
  slot's partials merged in block order. Held within 1e-5 in f32 with
  permuted and shared pages, table entries past the pool, frontiers on a
  block's first and last row, pos + c - 1 past npg * ps, c 5, g*c 10
  (llama_1b's verify) and 20, head dim 32, int8 and float pools, and every row no slot reads filled with large values;
- the wrapper's CPU path (the plain version, which clamps table entries
  into the pool as the kernels do) against the same walk;
- `paged_split_plan`: a function of (B, kvh, npg, ps) alone, blocks of a
  multiple of 32 rows that divide the page (or the whole page), at least
  1,000 CUDA blocks at llama_1b's decode shape and 128 at one slot.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smelter_tpu.kernels import paged_decode_attention as jpda
from smelter_tpu_torch.kernels import paged_decode_attention as pda

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


def _paged_split_emulation(q, k, v, table, pos, ks, vs, *, c, scale, split):
    """Both passes on f32 tensors: q (B, kvh, gc, hd), pools (P, ps,
    kvh*hd), scale pools (P, ps, 1) or None, table (B, npg)."""
    B, kvh, gc, hd = q.shape
    P, ps, _ = k.shape
    npg = table.shape[1]
    br = ps // split
    nblk = npg * split
    out = torch.empty(B, kvh, gc, hd)
    for b in range(B):
        p = int(pos[b])
        last = p + c - 1
        live_blocks = min(last // br, nblk - 1) + 1
        for h in range(kvh):
            qh = q[b, h].float()
            partials = []
            for j in range(nblk):
                if j >= live_blocks:  # wholly past the frontier
                    partials.append((torch.full((gc,), NEG), torch.zeros(gc),
                                     torch.zeros(gc, hd)))
                    continue
                page = min(max(int(table[b, j // split]), 0), P - 1)
                r0b = (j % split) * br  # the block's first row in its page
                lo = j * br             # and in the slot's sequence
                live = min(br, last - lo + 1)
                warps = []
                for w in range(WARPS):
                    m, l_, acc = torch.full((gc,), NEG), torch.zeros(gc), torch.zeros(gc, hd)
                    for r0 in range(2 * w, live, 2 * WARPS):  # its row pairs
                        rr = torch.arange(r0, min(r0 + 2, live))
                        kk = k[page, r0b + rr, h * hd:(h + 1) * hd].float()
                        vv = v[page, r0b + rr, h * hd:(h + 1) * hd].float()
                        ksr = ks[page, r0b + rr, 0].float() if ks is not None \
                            else torch.ones(len(rr))
                        vsr = vs[page, r0b + rr, 0].float() if vs is not None \
                            else torch.ones(len(rr))
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


def _case(B, kvh, g, c, hd, P, ps, npg, pos, table, quant, seed):
    """Pools of P pages (an entry past the pool is read as the last page)
    with every (page, row) that no slot reads
    filled with large values (1e6, or int8 rows with scales of 1e6)."""
    rng = np.random.default_rng(seed)
    table = np.asarray(table, np.int32)
    kvd = kvh * hd
    q = rng.standard_normal((B, kvh, g * c, hd)).astype(np.float32)
    pos = np.asarray(pos, np.int64)
    read = np.zeros((P, ps), bool)
    for b in range(B):
        for r in range(min(int(pos[b]) + c, npg * ps)):
            read[min(max(int(table[b, r // ps]), 0), P - 1), r % ps] = True
    stale = ~read[..., None]
    if quant:
        k, v = (rng.integers(-127, 128, (P, ps, kvd)).astype(np.int8) for _ in range(2))
        ks, vs = (np.where(stale, np.float32(1e6),
                           rng.uniform(1e-3, 2e-2, (P, ps, 1)).astype(np.float32))
                  for _ in range(2))
    else:
        k, v = (np.where(stale, np.float32(1e6),
                         rng.standard_normal((P, ps, kvd)).astype(np.float32)) for _ in range(2))
        ks = vs = None
    return q, k, v, table, pos, ks, vs


# (B, kvh, g, c, P, ps, npg, pos, table, split). Slot 0's frontier on a
# block's first row (32, blocks of 32), slot 1's on a block's last (63),
# slot 2 at row 0; pages permuted, slots 1 and 2 sharing page 4, and
# entries past the pool (9 of 8 pages, 12 of 6: read as the last page); c 5
# with pos + c - 1 past npg * ps (blocks of 8 rows);
# g*c 8; whole pages of 16 rows; llama_1b's verify (g 2, c 5: g*c 10) over
# 32-row blocks of 128-row pages; g*c 20 (two row groups) at head dim 32.
CASES = [
    (3, 2, 2, 1, 8, 128, 2, [32, 63, 0], [[5, 1], [4, 7], [4, 9]], 4),
    (2, 2, 1, 5, 6, 32, 2, [62, 17], [[2, 12], [0, 1]], 4),
    (2, 1, 4, 2, 7, 64, 3, [5, 190], [[3, 0, 6], [1, 2, 5]], 2),
    (2, 2, 2, 1, 5, 16, 3, [20, 47], [[4, 2, 1], [0, 3, 4]], 1),
    (2, 2, 2, 5, 5, 128, 2, [31, 252], [[3, 1], [4, 2]], 4),
    (2, 1, 4, 5, 7, 32, 3, [40, 93], [[6, 0, 2], [1, 5, 3]], 1, 32),
]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("quant", [False, True])
def test_paged_split_emulation_matches_pallas(case, quant):
    B, kvh, g, c, P, ps, npg, pos, table, split = case[:10]
    hd = case[10] if len(case) > 10 else 128
    q, k, v, table, pos, ks, vs = _case(B, kvh, g, c, hd, P, ps, npg, pos, table, quant,
                                        seed=B * 10 + c + ps)
    kw = dict(c=c, kv_heads=kvh, scale=hd ** -0.5)
    t = (lambda a: None if a is None else torch.from_numpy(a.copy()))
    got = _paged_split_emulation(t(q), t(k), t(v), t(table), t(pos), t(ks), t(vs), c=c,
                                 scale=hd ** -0.5, split=split).numpy()
    assert np.isfinite(got).all()
    j = (lambda a: None if a is None else jnp.asarray(a))
    want = np.asarray(jpda.paged_decode_attention(
        j(q), j(k), j(v), j(table), j(pos.astype(np.int32)), j(ks), j(vs), interpret=True,
        **kw))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # the wrapper's CPU path (the plain version) agrees with the walk
    plain = pda.paged_decode_attention(t(q), t(k), t(v), t(table), t(pos), t(ks), t(vs),
                                       **kw).numpy()
    assert np.abs(plain - got).max() <= 1e-5 * np.abs(got).max()
    assert pda.launches == 0


def test_paged_split_plan_is_a_function_of_the_shape():
    assert list(inspect.signature(pda.paged_split_plan).parameters) == [
        "B", "kvh", "npg", "ps"]
    for B, kvh, npg, ps in [(8, 8, 4, 128), (1, 8, 4, 128), (64, 8, 4, 128), (3, 2, 2, 16),
                            (2, 4, 5, 96), (1, 1, 1, 1), (8, 8, 8, 1024), (4, 2, 3, 48)]:
        rows, split, nblk = pda.paged_split_plan(B, kvh, npg, ps)
        assert rows * split == ps and nblk == npg * split
        assert rows % 32 == 0 or (ps % 32 and rows == ps)
        assert pda.paged_split_plan(B, kvh, npg, ps) == (rows, split, nblk)
    rows, split, nblk = pda.paged_split_plan(8, 8, 4, 128)  # the paged step at llama_1b
    assert (rows, nblk) == (32, 16) and 8 * 8 * nblk >= 1000
    rows, split, nblk = pda.paged_split_plan(1, 8, 4, 128)  # one slot
    assert 8 * nblk >= 128
    assert pda.paged_split_plan(64, 8, 4, 128) == (128, 1, 4)  # many slots: whole pages
