"""The ring of ranks along one mesh axis: two slots a rank, a transfer a
step to the right-hand neighbour's other slot, and the ordering between
steps.

The port's counterpart of what the JAX ring kernels
(`smelter_tpu/kernels/collective_matmul.py`, `ring_attention_rdma.py`) build
from `pltpu.make_async_remote_copy`, their DMA semaphores and
`_neighbor_barrier`: there a kernel copies its slot into the neighbour's
other slot from inside the kernel, waits on semaphores for the copy, and
trades tokens with both neighbours before a slot is reused. Here the
transfers are outside the kernels: at step s each rank's step kernel runs
on its device's compute stream (PyTorch's current stream) while the slot
it reads is copied (`copy_`) into the right-hand neighbour's other slot on
a comm stream of that device. CUDA events order the two:

- a rank's step s waits for the copy that filled its slot (the semaphore
  wait);
- the copy into a neighbour's slot waits until the neighbour's step s - 1
  (its kernel and its own copy, both of which read that slot) is done (the
  neighbour barrier);
- where the step writes the slot it then sends (a travelling sum), the
  copy waits for that step.

No kernel ever waits inside a launch for another launch, so W ranks on one
card cannot deadlock however the launches fill the SMs. Each step launches
its ranks starting from rank s mod W, whose slot was filled first. On the
CPU (and the `meta` device) the same steps run in order and the copies are
plain copies.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch


class Ring:
    """`devices[i]` is the device of the ring's rank i (flat mesh rank
    `ranks[i]`); rank i sends to rank (i + 1) mod W. `comm_streams` is the
    mesh's cache of one comm stream a card."""

    def __init__(self, devices: Sequence[torch.device], ranks: Sequence[int],
                 comm_streams: dict):
        self.devices = [torch.device(d) for d in devices]
        self.ranks = list(ranks)
        self.size = len(self.devices)
        self._comm_streams = comm_streams
        kinds = {d.type for d in self.devices}
        if len(kinds) != 1 or not kinds <= {"cuda", "cpu", "meta"}:
            raise ValueError(f"a ring runs on CUDA cards, the CPU or `meta`, one kind at a "
                             f"time: {self.devices}")
        self.on_cuda = kinds == {"cuda"}

    def _comm(self, dev: torch.device):
        if dev not in self._comm_streams:
            self._comm_streams[dev] = torch.cuda.Stream(dev)
        return self._comm_streams[dev]

    def rotate(self, first: Sequence[tuple], step: Callable[[int, int, tuple], None], *,
               writes: bool = False) -> None:
        """Run the W steps of a ring. `first[i]` is rank i's tuple of
        tensors for step 0; at step s rank i holds the tuple that started on
        rank (i - s) mod W and `step(s, i, held)` runs its step on it (on
        its device, launching on the current stream). Between steps each
        held tuple moves one rank to the right. Without `writes` the steps
        only read the held tensors, the move runs beside the step, and
        `first`'s tensors are never written. With `writes` a step writes
        them (a travelling sum): the move waits for the step, and `first`'s
        tensors, scratch the step fills, serve as slot 0 throughout."""
        W = self.size
        for i, held in enumerate(first):
            for t in held:
                if t.device != self.devices[i]:
                    raise ValueError(f"ring rank {i}: a tensor on {t.device}, the rank is on "
                                     f"{self.devices[i]}")
        # Every slot is allocated before the comm streams wait for the compute
        # streams: a block the allocator hands out may have served the compute
        # stream's work still in flight, and only that wait orders a copy into
        # it after that work.
        slots = [[tuple(f) if writes or W < 3 else tuple(torch.empty_like(t) for t in f),
                  tuple(torch.empty_like(t) for t in f) if W > 1 else ()] for f in first]
        held = [tuple(f) for f in first]
        arrived: list = [None] * W
        prev_done: list = [None] * W  # each rank's (step, copy) events of step s - 1
        if self.on_cuda:
            for dev in set(self.devices):  # the inputs are ready before any copy reads them
                self._comm(dev).wait_stream(torch.cuda.current_stream(dev))
        for s in range(W):
            last = s == W - 1
            done: list = [None] * W
            nxt_arrived: list = [None] * W
            nxt_held: list = [None] * W
            for i in [(s + j) % W for j in range(W)]:
                dev = self.devices[i]
                ctx = torch.cuda.device(dev) if self.on_cuda else contextlib.nullcontext()
                with ctx:
                    if self.on_cuda and arrived[i] is not None:
                        torch.cuda.current_stream(dev).wait_event(arrived[i])
                    step(s, i, held[i])
                    computed = (torch.cuda.current_stream(dev).record_event()
                                if self.on_cuda else None)
                if last:
                    continue
                dst = (i + 1) % W
                target = slots[dst][(s + 1) % 2]
                sent = self._send(held[i], target, dev, self.devices[dst],
                                  waits=[computed if writes else arrived[i],
                                         *(prev_done[dst] or ())])
                done[i] = (computed, sent[0]) if self.on_cuda else None
                nxt_arrived[dst] = sent[1]
                nxt_held[dst] = target
            prev_done, arrived, held = done, nxt_arrived, nxt_held
        if self.on_cuda:
            for dev in set(self.devices):
                torch.cuda.current_stream(dev).wait_stream(self._comm(dev))

    def _send(self, src: tuple, dst: tuple, src_dev, dst_dev, waits) -> tuple:
        """Copy the slot `src` into `dst` on the sender's comm stream after
        `waits`; returns the events (sent, arrived), or Nones off the card."""
        if not self.on_cuda:
            for d, t in zip(dst, src):
                d.copy_(t)
            return None, None
        comm, comm_dst = self._comm(src_dev), self._comm(dst_dev)
        for e in waits:
            if e is not None:
                comm.wait_event(e)
        with torch.cuda.stream(comm), (torch.cuda.stream(comm_dst) if comm_dst is not comm
                                       else contextlib.nullcontext()):
            for d, t in zip(dst, src):
                d.copy_(t, non_blocking=True)
        return comm.record_event(), comm_dst.record_event()
