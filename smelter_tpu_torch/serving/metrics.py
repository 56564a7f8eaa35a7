"""Serving metrics: counters + latency percentiles + batch occupancy.

The reference has no observability beyond prints (SURVEY.md §5.5); serving
on TPU pods needs at least the numbers BASELINE tracks: requests, images/s,
batch occupancy, p50/p95 end-to-end latency."""

from __future__ import annotations

import threading
import time


class Metrics:
    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self._window = window
        self._latencies_ms: list[float] = []
        self.requests = 0
        self.batches = 0
        self.padded_slots = 0
        self.occupied_slots = 0
        self.errors = 0
        self.deadline_misses = 0
        self.reinits = 0
        self._t0 = time.monotonic()

    def record_deadline_miss(self, n: int = 1) -> None:
        with self._lock:
            self.deadline_misses += n

    def record_reinit(self) -> None:
        with self._lock:
            self.reinits += 1

    def record_batch(self, n_real: int, n_padded: int, latencies_ms: list[float]) -> None:
        with self._lock:
            self.requests += n_real
            self.batches += 1
            self.occupied_slots += n_real
            self.padded_slots += n_padded - n_real
            self._latencies_ms.extend(latencies_ms)
            if len(self._latencies_ms) > self._window:
                self._latencies_ms = self._latencies_ms[-self._window:]

    def record_error(self, n: int = 1) -> None:
        with self._lock:
            self.errors += n

    def _pct(self, sorted_lat: list[float], p: float) -> float:
        if not sorted_lat:
            return 0.0
        idx = min(len(sorted_lat) - 1, int(p / 100.0 * len(sorted_lat)))
        return sorted_lat[idx]

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._latencies_ms)
            elapsed = max(time.monotonic() - self._t0, 1e-9)
            total_slots = self.occupied_slots + self.padded_slots
            return {
                "requests": self.requests,
                "batches": self.batches,
                "errors": self.errors,
                "deadline_misses": self.deadline_misses,
                "reinits": self.reinits,
                "throughput_rps": self.requests / elapsed,
                "occupancy": (self.occupied_slots / total_slots) if total_slots else 0.0,
                "latency_ms_p50": self._pct(lat, 50),
                "latency_ms_p95": self._pct(lat, 95),
                "latency_ms_max": lat[-1] if lat else 0.0,
            }
