"""Host-side KV page-pool bookkeeping for paged decode serving.

The port's copy of `smelter_tpu/serving/kv_pool.py` (numpy only). The
device side is kernels/paged_decode_attention.py (pool reads via
page-table indirection) + paged_cache_update (row writes). This module
owns the HOST side: which pool pages are free, which belong to which
slot, and when a growing sequence needs its next page. Pure Python and
O(pages) — it runs on the serving thread between device dispatches, so
it must never touch the device.

Design: a single free list (LIFO — recently freed pages are re-used
first, which keeps the working set of pool pages dense) plus a per-slot
page list. `ensure(slot, length)` is the one call the serving loop
needs per tick: it appends pages until the slot can hold `length`
logical rows, raising PoolExhausted (a clean admission-control signal,
not an OOM) when the pool is empty.

"""

from __future__ import annotations

import numpy as np


class PoolExhausted(RuntimeError):
    """No free pages — the caller should defer admission (backpressure),
    not crash: in-flight sequences keep their pages."""


class PagePool:
    """Allocator over ``n_pages`` pool pages of ``page_size`` rows.

    ``table(npg)`` renders the current allocation as the (B, npg) int32
    page-table array the kernel reads; freed/unassigned entries
    keep their last value (the kernel clamps to the live prefix, so
    stale ids are never dereferenced) — but they stay VALID pool indices
    (< n_pages) so a mis-clamped read could never fault.
    """

    def __init__(self, n_pages: int, page_size: int, slots: int,
                 scratch: bool = False):
        if n_pages < 1 + int(scratch) or page_size < 1 or slots < 1:
            raise ValueError((n_pages, page_size, slots))
        self.n_pages = n_pages
        self.page_size = page_size
        self.slots = slots
        self.scratch = scratch
        # scratch=True reserves page 0 as the dead-slot sink: it is
        # never allocated, and table()'s zero-fill means an inactive
        # slot's row points at it — the batched paged step's writes for
        # dead slots land there instead of corrupting re-assigned pages
        # (the in-graph alternative would be an active-mask input)
        lo = 1 if scratch else 0
        self._free: list[int] = list(range(n_pages - 1, lo - 1, -1))
        self._owned: list[list[int]] = [[] for _ in range(slots)]

    # -- queries ---------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_of(self, slot: int) -> list[int]:
        return list(self._owned[slot])

    def pages_for(self, length: int) -> int:
        """Pages needed to hold `length` logical rows."""
        return -(-max(length, 0) // self.page_size)

    def capacity(self, slot: int) -> int:
        """Logical rows slot can hold with its current pages."""
        return len(self._owned[slot]) * self.page_size

    def can_admit(self, length: int) -> bool:
        return self.pages_for(length) <= len(self._free)

    # -- mutation --------------------------------------------------------

    def ensure(self, slot: int, length: int) -> list[int]:
        """Grow slot's page list until it holds `length` rows; returns
        the newly assigned page ids (possibly empty). All-or-nothing:
        on PoolExhausted the slot keeps exactly its previous pages."""
        need = self.pages_for(length) - len(self._owned[slot])
        if need <= 0:
            return []
        if need > len(self._free):
            raise PoolExhausted(
                f"slot {slot} needs {need} pages, {len(self._free)} free")
        new = [self._free.pop() for _ in range(need)]
        self._owned[slot].extend(new)
        return new

    def release(self, slot: int) -> None:
        """Return all of slot's pages to the free list (sequence done).
        No device-side scrub is needed: the kernel reads only rows the
        NEXT occupant has written (write-before-read, the same argument
        as DecodeServer slot reuse)."""
        self._free.extend(reversed(self._owned[slot]))
        self._owned[slot] = []

    def table(self, npg: int | None = None,
              out: np.ndarray | None = None) -> np.ndarray:
        """(slots, npg) int32 page table for the kernel. Pass the
        previous table as `out` to update in place (stale entries stay
        valid indices)."""
        if npg is None:
            npg = self.n_pages
        if out is None:
            out = np.zeros((self.slots, npg), np.int32)
        for s, pages in enumerate(self._owned):
            if len(pages) > npg:
                raise ValueError(
                    f"slot {s} holds {len(pages)} pages > table width "
                    f"{npg}")
            out[s, :len(pages)] = pages
            if self.scratch:
                # entries past the owned prefix MUST point at the
                # scratch page (a freed slot's stale ids may now belong
                # to another sequence, and the batched step writes
                # through table[slot, pos // ps] unconditionally)
                out[s, len(pages):] = 0
        return out
