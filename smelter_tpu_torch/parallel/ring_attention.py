"""Ring attention: sequence-parallel attention over a mesh axis.

The port's counterpart of `smelter_tpu/parallel/ring_attention.py`, the
plain SPMD form: each rank holds a sequence shard of q, k and v; the k and
v shards travel round the ring (`parallel/ring.py`, where the JAX package
uses `lax.ppermute`) while each rank folds every visiting shard into its
queries' streaming-softmax state, all in f32. Plain PyTorch: it reaches no
kernel (the hand-scheduled form with a Hopper kernel is
`kernels/ring_attention_rdma.py`).

q, k, v per rank: (B, H, N_local, D), non-causal, no mask.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .mesh import Mesh, ShardedTensor
from .ring import Ring


def _merge(m, l, acc, s, v):
    """Fold one block of logits s (..., Nq, Nk) and values v into the
    streaming-softmax state (m: running max, l: running sum, acc:
    output), as the JAX `_merge` spells it."""
    m_cur = s.amax(dim=-1, keepdim=True)
    m_new = torch.maximum(m, m_cur)
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l_new = alpha * l + p.sum(dim=-1, keepdim=True)
    acc_new = acc * alpha + p @ v
    return m_new, l_new, acc_new


def ring_attention(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                   vs: Sequence[torch.Tensor], ring: Ring, *,
                   scale: float = 1.0) -> list[torch.Tensor]:
    """Non-causal ring attention over the ranks of `ring` (shards in ring
    order); returns each rank's output for its query shard, in q's dtype."""
    W = ring.size
    if not (len(qs) == len(ks) == len(vs) == W):
        raise ValueError(f"ring of {W} ranks given {len(qs)}, {len(ks)}, {len(vs)} shards")
    state = []
    for q in qs:
        qf = q.float()
        state.append([qf, torch.full_like(qf[..., :1], -float("inf")),
                      torch.zeros_like(qf[..., :1]), torch.zeros_like(qf)])

    def step(s, i, held):
        qf, m, l, acc = state[i]
        k_cur, v_cur = held
        logits = (qf @ k_cur.float().transpose(-1, -2)) * scale
        state[i][1:] = _merge(m, l, acc, logits, v_cur.float())

    ring.rotate([(k, v) for k, v in zip(ks, vs)], step)
    return [(acc / l).to(q.dtype) for q, (_, _, l, acc) in zip(qs, state)]


def sequence_sharded_attention(q, k, v, mesh: Mesh, *, axis: str = "sp",
                               scale: float = 1.0) -> ShardedTensor:
    """Full (B, H, N, D) tensors or arrays in, ring attention over `axis` of
    `mesh`, the output back sharded along N."""
    spec = (None, None, axis, None)
    out = mesh.run_rings(axis, ring_attention, *(mesh.shard(t, spec) for t in (q, k, v)),
                         scale=scale)
    return ShardedTensor(out, mesh, spec, tuple(q.shape))
