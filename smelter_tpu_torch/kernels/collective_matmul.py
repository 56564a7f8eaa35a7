"""Collective matmuls over a ring of ranks: all-gather -> GEMM and GEMM ->
reduce-scatter, the two halves of a Megatron tensor-parallel MLP.

- `collective_matmul_ag`: the column-parallel linear with M-sharded
  activations. Rank i holds x_i (M/P, K) and w_i (K, N/P) and returns its
  (M, N/P) output columns. At step s it dots the x shard in hand, which
  started on rank src = (i - s) mod P, into output rows [src M/P, (src + 1)
  M/P), while the shard moves on to rank i + 1. The sum is f32 (int32 for
  int8 x) and each output chunk is rounded once to x's dtype; for int8 the
  int32 sum is cast to int8, which wraps.
- `collective_matmul_rs`: the row-parallel linear. Rank i holds x_i (M,
  K/P) and w_i (K/P, N) and returns chunk i (M/P rows) of the sum over
  ranks of x_i @ w_i. At step s rank i adds its f32 partial for chunk c =
  (i - s - 1) mod P to the f32 travelling sum it received and sends the
  sum on (f32 on the wire), so chunk c's partials are added in ring order
  from rank c + 1, and rank i ends holding chunk i, rounded once to x's
  dtype (int8: clamped, as the JAX kernel's `astype` of its f32 sum). M
  must split evenly over the ranks.

Replaces the Pallas kernels `smelter_tpu/kernels/collective_matmul.py::
collective_matmul_ag` and `::collective_matmul_rs`, whose ring transfers
are `make_async_remote_copy` inside the kernel. The port's ring is
`parallel/ring.py` (slot copies on a comm stream, ordered by CUDA events)
and a step of a rank is one launch of `csrc/collective_matmul.cu`:

- What bounds it on an H100: the tensor cores for `ag`; at ViT-B/16's MLP
  at batch 128 over 4 ranks the pair does 238 GFLOP (241 us at 989
  TFLOP/s dense bf16) against 86 MB of operands. An `rs` step there is
  bound by its epilogue's bytes instead: the f32 travelling sum read and
  written (38.7 MB a step, 11.6 us at 3.35 TB/s) outweighs its 7.5 us of
  tensor-core work, and at llama_1b nearly so.
- What the design does: a bf16/f16 step of either runs on the wgmma/TMA
  core (`csrc/wgmma_gemm.cuh`), in the form `wgmma_plan.plan` picks from
  the step's shape (the persistent TMA kernel, or a K split over a
  cluster); `rs`'s epilogue adds the received f32 sum to the f32 product
  and rounds once, each tile's recv brought into shared memory by TMA
  while its K loop runs; int8 steps run csrc/int8_gemm.cuh's m16n8k32
  tiles (`ag` wraps, `rs` adds its int32 sum to the f32 travelling sum and
  saturates at the last step); the copy of a step runs on its own stream
  beside the other ranks' launches.

The per-shard entries take each rank's shards (in ring order) and the
`Ring`; `tp_allgather_matmul` and `tp_reducescatter_matmul` take full
tensors or numpy arrays and a `Mesh`, shard them as the JAX wrappers do
(x over M and w over N; x and w over K), and return a `ShardedTensor`
(N-sharded; M-sharded). On CPU or `meta` shards the entries take the plain
versions, which run the same ring schedule and arithmetic in PyTorch; on
CUDA shards they launch the kernel or raise. `ag_launches` and
`rs_launches` count kernel launches: W x W a call of W ranks.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..parallel.mesh import Mesh, ShardedTensor
from ..parallel.ring import Ring
from ..utils.dtypes import saturating_cast
from . import _build, wgmma_plan

ag_launches = 0
rs_launches = 0

_FLOATS = (torch.float32, torch.bfloat16, torch.float16)


def _product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w summed in f32, rounded once to x's dtype; for int8 the exact
    integer sum (in float64, exact below 2**53, and on every device) cast to
    int8, which keeps its low 8 bits as the int32 sum's cast does."""
    if x.dtype == torch.int8:
        return (x.double() @ w.double()).to(torch.int64).to(torch.int8)
    return (x.float() @ w.float()).to(x.dtype)


def _partial(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A rank's f32 partial of the reduce-scatter GEMM; for int8 the exact
    integer sum rounded once to f32, as the kernel converts its int32 sum."""
    if x.dtype == torch.int8:
        return (x.double() @ w.double()).float()
    return x.float() @ w.float()


def _shapes(xs, ws, ring: Ring, what: str) -> None:
    if not (len(xs) == len(ws) == ring.size):
        raise ValueError(f"{what}: ring of {ring.size} ranks given {len(xs)} x and "
                         f"{len(ws)} w shards")
    for i, (x, w) in enumerate(zip(xs, ws)):
        if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
            raise ValueError(f"{what}: rank {i}: x {tuple(x.shape)} and w {tuple(w.shape)} "
                             "do not chain")
        if x.shape != xs[0].shape or w.shape != ws[0].shape:
            raise ValueError(f"{what}: the ranks' shards differ in shape")
        if x.device != ring.devices[i] or w.device != ring.devices[i]:
            raise ValueError(f"{what}: rank {i}'s shards lie on {x.device} and {w.device}, "
                             f"the rank on {ring.devices[i]}")


def collective_matmul_ag_plain(xs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
                               ring: Ring) -> list[torch.Tensor]:
    """The all-gather GEMM's schedule and arithmetic in plain PyTorch."""
    _shapes(xs, ws, ring, "collective_matmul_ag")
    W, (ml, _), nl = ring.size, xs[0].shape, ws[0].shape[1]
    outs = [torch.empty((W * ml, nl), dtype=x.dtype, device=x.device) for x in xs]

    def step(s, i, held):
        src = (i - s) % W
        outs[i][src * ml:(src + 1) * ml] = _product(held[0], ws[i])

    ring.rotate([(x,) for x in xs], step)
    return outs


def collective_matmul_rs_plain(xs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
                               ring: Ring) -> list[torch.Tensor]:
    """The reduce-scatter GEMM's schedule and arithmetic in plain PyTorch:
    each chunk's f32 partials added in ring order, one rounding at the
    end (for int8 a saturating cast, as the JAX kernel's `astype`)."""
    _shapes(xs, ws, ring, "collective_matmul_rs")
    W, (M, _), N = ring.size, xs[0].shape, ws[0].shape[1]
    if M % W:
        raise ValueError(f"collective_matmul_rs: M {M} does not split over {W} ranks")
    mc = M // W
    outs: list = [None] * W

    def step(s, i, held):
        c = (i - s - 1) % W
        part = _partial(xs[i][c * mc:(c + 1) * mc], ws[i])
        if s == 0:
            held[0].copy_(part)
        else:
            held[0].add_(part)  # the received sum + this rank's partial
        if s == W - 1:
            outs[i] = (saturating_cast(held[0], torch.int8) if xs[i].dtype == torch.int8
                       else held[0].to(xs[i].dtype, copy=True))

    ring.rotate([(torch.empty((mc, N), dtype=torch.float32, device=x.device),) for x in xs],
                step, writes=True)
    return outs


def _kernel_checks(xs, ws, dtypes, what: str) -> None:
    x = xs[0]
    if x.dtype not in dtypes or ws[0].dtype != x.dtype:
        raise TypeError(f"{what}: x {x.dtype} and w {ws[0].dtype} not taken (one of "
                        f"{dtypes}, both alike)")
    if not all(t.is_contiguous() for t in (*xs, *ws)):
        raise ValueError(f"{what}: shards must be contiguous")


_NO_PLAN = wgmma_plan.Plan("tma", 0, 0, 0, 0, 0, 0)  # what the f32 and int8 kernels ignore


def _launch(lib, a, b, recv, out, reduce: bool, what: str) -> None:
    """One step: ag (`reduce` False: recv None, out in a's dtype) or rs
    (out = [recv +] a @ b); a 16-bit step on its `wgmma_plan` plan, whose
    tma form needs a and b aligned, and for rs recv and out too (its
    epilogue moves them in 16-byte chunks)."""
    M, K = a.shape
    N = b.shape[1]
    ops = (a, b) if not reduce else tuple(t for t in (a, b, recv, out) if t is not None)
    p = (wgmma_plan.plan(M, N, K, int8_b=False, aligned=_build.aligned16(*ops),
                         sms=_build.sms(a.device))
         if a.dtype in (torch.bfloat16, torch.float16) else _NO_PLAN)
    with torch.cuda.device(a.device):
        rc = lib.smelter_collective_matmul(
            a.data_ptr(), b.data_ptr(), None if recv is None else recv.data_ptr(),
            out.data_ptr(), M, N, K, _build.DTYPE_CODES[a.dtype], _build.DTYPE_CODES[out.dtype],
            int(reduce), p.code, p.bn, p.split, p.k_chunk, p.grid, _build.stream_of(a))
    _build.check(lib, rc, what)


def _on_card(xs, ring: Ring, what: str) -> bool:
    """Whether the shards take the kernel (CUDA) or the plain version (CPU,
    `meta`); raises for any other device."""
    kind = xs[0].device.type if len(xs) else ring.devices[0].type
    if kind in ("cpu", "meta"):
        return False
    if kind != "cuda":
        raise ValueError(f"{what}: no kernel for device {xs[0].device}")
    return True


def collective_matmul_ag(xs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
                         ring: Ring) -> list[torch.Tensor]:
    """Per-shard entry: rank i's x_i (M/P, K) and w_i (K, N/P) -> its (M,
    N/P) output in x's dtype (f32, bf16, f16, int8)."""
    if not _on_card(xs, ring, "collective_matmul_ag"):
        return collective_matmul_ag_plain(xs, ws, ring)
    _shapes(xs, ws, ring, "collective_matmul_ag")
    _kernel_checks(xs, ws, _FLOATS + (torch.int8,), "collective_matmul_ag")
    W, (ml, _), nl = ring.size, xs[0].shape, ws[0].shape[1]
    outs = [torch.empty((W * ml, nl), dtype=x.dtype, device=x.device) for x in xs]
    lib = _build.library("collective_matmul")

    def step(s, i, held):
        global ag_launches
        src = (i - s) % W
        _launch(lib, held[0], ws[i], None, outs[i][src * ml:(src + 1) * ml], False,
                "collective_matmul_ag")
        ag_launches += 1

    ring.rotate([(x,) for x in xs], step)
    return outs


def collective_matmul_rs(xs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
                         ring: Ring) -> list[torch.Tensor]:
    """Per-shard entry: rank i's x_i (M, K/P) and w_i (K/P, N) -> chunk i
    (M/P, N) of the reduced product in x's dtype (f32, bf16, f16, int8)."""
    if not _on_card(xs, ring, "collective_matmul_rs"):
        return collective_matmul_rs_plain(xs, ws, ring)
    _shapes(xs, ws, ring, "collective_matmul_rs")
    _kernel_checks(xs, ws, _FLOATS + (torch.int8,), "collective_matmul_rs")
    W, (M, _), N = ring.size, xs[0].shape, ws[0].shape[1]
    if M % W:
        raise ValueError(f"collective_matmul_rs: M {M} does not split over {W} ranks")
    mc = M // W
    outs = [torch.empty((mc, N), dtype=x.dtype, device=x.device) for x in xs]
    lib = _build.library("collective_matmul")

    def step(s, i, held):
        global rs_launches
        c = (i - s - 1) % W
        last = s == W - 1
        _launch(lib, xs[i][c * mc:(c + 1) * mc], ws[i], None if s == 0 else held[0],
                outs[i] if last else held[0], True, "collective_matmul_rs")
        rs_launches += 1

    ring.rotate([(torch.empty((mc, N), dtype=torch.float32, device=x.device),) for x in xs],
                step, writes=True)
    return outs


def tp_allgather_matmul(x, w, mesh: Mesh, *, axis: str = "tp") -> ShardedTensor:
    """x (M, K) sharded over M on `axis`, w (K, N) over N; returns the (M,
    N) product sharded over N: the column-parallel TP linear on the ring."""
    xs, ws = mesh.shard(x, (axis, None)), mesh.shard(w, (None, axis))
    out = mesh.run_rings(axis, collective_matmul_ag, xs, ws)
    return ShardedTensor(out, mesh, (None, axis), (x.shape[0], w.shape[1]))


def tp_reducescatter_matmul(x, w, mesh: Mesh, *, axis: str = "tp") -> ShardedTensor:
    """x (M, K) sharded over K on `axis`, w (K, N) over K; returns the (M,
    N) product sharded over M: the row-parallel TP linear on the ring."""
    xs, ws = mesh.shard(x, (None, axis)), mesh.shard(w, (axis, None))
    out = mesh.run_rings(axis, collective_matmul_rs, xs, ws)
    return ShardedTensor(out, mesh, (axis, None), (x.shape[0], w.shape[1]))
