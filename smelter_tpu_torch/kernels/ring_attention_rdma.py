"""Sequence-parallel ring attention with the K/V rotation scheduled by hand.

Rank i holds q_i, k_i, v_i (B, H, Nl, D), a shard of the sequence. K and V
travel round the ring in two slots a rank while each rank folds every
visiting shard into its queries' f32 streaming-softmax state; the output is
acc / l in q's dtype. Non-causal, no mask, scale defaults to 1.0.

Replaces the Pallas kernel `smelter_tpu/kernels/ring_attention_rdma.py::
ring_attention_rdma`, which keeps a rank's whole shard and state in VMEM
and rotates K and V with `make_async_remote_copy` inside the kernel. The
port's ring is `parallel/ring.py` (slot copies on a comm stream, ordered by
CUDA events); a merge step of a rank is one launch of
`csrc/ring_attention.cu`, tiled over (B H, query rows), with the f32 state
(m, l, acc) in device memory between the steps:

- What bounds it on an H100: the tensor cores, 4 B H N^2 D operations (8.8
  TFLOP at llama_1b's 16 heads of 128, N 32,768: 8.9 ms at 989 TFLOP/s
  dense bf16), and close behind them the exponentials (one a score).
- What the design does: 16-bit types take `csrc/wgmma_attention.cuh`'s
  streaming form (`attention_plan.ring_plan`): a CTA takes 128 query rows of
  a (b, h), a producer thread brings Q once and K and V in 128-key tiles by
  TMA into a ring of stages behind mbarriers, two consumer warpgroups run
  S = Q K^T and P V on wgmma (P rounded to q's type before P V, as in
  `flash_attention`; bound 1e-2 of the largest output) and hide each
  other's softmax; f32 takes full f32 on the FMA units; head dims 32, 64 and
  128, others raise.

`ring_attention_rdma_plain` is the same merge in plain PyTorch: the plain
SPMD ring of `parallel/ring_attention.py`, whose algebra the Pallas kernel
spells step for step. On CPU or `meta` shards the entry takes it; on CUDA
shards it launches the kernel or raises. `launches` counts kernel launches:
W x W a call of W ranks.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..parallel.mesh import Mesh, ShardedTensor
from ..parallel.ring import Ring
from ..parallel.ring_attention import ring_attention
from . import _build

launches = 0

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
HEAD_DIMS = (32, 64, 128)


def _check_shapes(qs, ks, vs, ring: Ring) -> None:
    if not (len(qs) == len(ks) == len(vs) == ring.size):
        raise ValueError(f"ring_attention_rdma: ring of {ring.size} ranks given {len(qs)}, "
                         f"{len(ks)}, {len(vs)} shards")
    for i, ts in enumerate(zip(qs, ks, vs)):
        if any(t.dim() != 4 or t.shape != qs[0].shape for t in ts):
            raise ValueError("ring_attention_rdma: q, k and v shards must all be one "
                             f"(B, H, Nl, D) shape; rank {i} has "
                             f"{[tuple(t.shape) for t in ts]}")
        if any(t.device != ring.devices[i] for t in ts):
            raise ValueError(f"ring_attention_rdma: rank {i}'s shards are not all on its "
                             f"device {ring.devices[i]}")


def ring_attention_rdma_plain(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                              vs: Sequence[torch.Tensor], ring: Ring, *,
                              scale: float = 1.0) -> list[torch.Tensor]:
    """The kernel's schedule and arithmetic in plain PyTorch: a step merges
    the whole visiting shard in f32."""
    _check_shapes(qs, ks, vs, ring)
    return ring_attention(qs, ks, vs, ring, scale=scale)


def ring_attention_rdma(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                        vs: Sequence[torch.Tensor], ring: Ring, *,
                        scale: float = 1.0) -> list[torch.Tensor]:
    """Per-shard entry: each rank's q, k, v (B, H, Nl, D) in ring order ->
    its (B, H, Nl, D) output in q's dtype."""
    kind = qs[0].device.type if len(qs) else ring.devices[0].type
    if kind in ("cpu", "meta"):
        return ring_attention_rdma_plain(qs, ks, vs, ring, scale=scale)
    if kind != "cuda":
        raise ValueError(f"ring_attention_rdma: no kernel for device {qs[0].device}")
    _check_shapes(qs, ks, vs, ring)
    B, H, Nl, D = qs[0].shape
    dt = qs[0].dtype
    ops = (*qs, *ks, *vs)
    if dt not in _DTYPES or any(t.dtype != dt for t in ops):
        raise TypeError(f"ring_attention_rdma: q, k, v must share one of {_DTYPES}")
    if D not in HEAD_DIMS:
        raise ValueError(f"ring_attention_rdma: head dim {D} not taken (one of {HEAD_DIMS})")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ops):
        raise ValueError("ring_attention_rdma: shards must be contiguous and 16-byte aligned")
    W, BH = ring.size, B * H
    state = [(torch.empty((BH, Nl), dtype=torch.float32, device=q.device),
              torch.empty((BH, Nl), dtype=torch.float32, device=q.device),
              torch.empty((BH, Nl, D), dtype=torch.float32, device=q.device)) for q in qs]
    outs = [torch.empty_like(q) for q in qs]
    lib = _build.library("ring_attention")

    def step(s, i, held):
        global launches
        k, v = held
        m, l, acc = state[i]
        with torch.cuda.device(k.device):
            rc = lib.smelter_ring_attention_step(
                qs[i].data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(), l.data_ptr(),
                acc.data_ptr(), outs[i].data_ptr(), BH, Nl, Nl, D, float(scale),
                int(s == 0), int(s == W - 1), _build.DTYPE_CODES[dt], _build.stream_of(k))
        _build.check(lib, rc, "ring_attention_rdma")
        launches += 1

    ring.rotate([(k, v) for k, v in zip(ks, vs)], step)
    return outs


def sequence_sharded_attention_rdma(q, k, v, mesh: Mesh, *, axis: str = "sp",
                                    scale: float = 1.0) -> ShardedTensor:
    """Full (B, H, N, D) tensors or arrays in, the ring kernel over `axis`
    of `mesh`, the output back sharded along N."""
    spec = (None, None, axis, None)
    out = mesh.run_rings(axis, ring_attention_rdma,
                         *(mesh.shard(t, spec) for t in (q, k, v)), scale=scale)
    return ShardedTensor(out, mesh, spec, tuple(q.shape))
