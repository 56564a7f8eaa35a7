"""Continuous-batching inference server.

The port's counterpart of `smelter_tpu/serving/server.py`:

- requests enter a queue; a batcher thread drains up to max_batch of them,
  waiting at most max_wait_ms for stragglers;
- batch sizes are bucketed (powers of two up to max_batch), one executor
  per bucket, and short batches are padded to the bucket, so every batch
  the device sees has one of a few shapes;
- a warmer thread runs each bucket once off the request path (on the card
  the first run of a shape selects the convolution algorithms and builds
  the kernels);
- results fan back out through per-request futures;
- the host readback synchronizes the device, so measured latency is true
  end to end. PyTorch launches asynchronously, so batch i+1 is collected
  while batch i runs.

The JAX package's host-health and membership loop waits for the port's
multi-device slice.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future

import numpy as np

from ..ir.graph import Graph
from ..runtime.config import Config
from ..runtime.executor import Executor, resolve_device, to_numpy
from .metrics import Metrics


class _Request:
    __slots__ = ("inputs", "future", "t_enqueue", "deadline")

    def __init__(self, inputs, timeout_ms: float | None = None):
        self.inputs = inputs
        self.future: Future = Future()
        self.t_enqueue = time.monotonic()
        self.deadline = (self.t_enqueue + timeout_ms / 1e3
                         if timeout_ms is not None else None)

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline


class InferenceServer:
    def __init__(
        self,
        graph: Graph,
        config: Config | None = None,
        max_batch: int = 8,
        max_wait_ms: float = 2.0,
        buckets: tuple[int, ...] | None = None,
        eager_compile: bool = True,
        max_queue: int = 4096,
    ):
        config = config or Config()
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        if buckets is None:
            buckets, b = [], 1
            while b < max_batch:
                buckets.append(b)
                b *= 2
            buckets.append(max_batch)
        self.buckets = tuple(sorted(set(buckets)))
        self.metrics = Metrics()

        # One executor per bucket: same graph, batch dim pinned per bucket.
        self._executors: dict[int, tuple[Executor, object, dict]] = {}
        self._shared_params: dict | None = None
        self._graph = graph
        self._config = config
        self._device = resolve_device(config.device)
        self._exec_lock = threading.Lock()

        # Bounded queue: overload sheds with a fast error instead of
        # unbounded latency growth (backpressure).
        self._queue: queue.Queue[_Request | None] = queue.Queue(maxsize=max_queue)
        self._running = True
        self._thread = threading.Thread(target=self._batch_loop, daemon=True)
        self._thread.start()
        # Warm every bucket off the request path (default). A request
        # arriving before its bucket is warm still builds it inline under
        # the executor lock (correct, just slower).
        self._warmer: threading.Thread | None = None
        if eager_compile:
            self._warmer = threading.Thread(target=self._warm_buckets,
                                            daemon=True)
            self._warmer.start()

    def _warm_buckets(self) -> None:
        for b in self.buckets:
            if not self._running:
                return
            try:
                ex, fn, params = self._get_executor(b)
                zeros = [np.zeros(t.shape, t.np_dtype)
                         for t in (ex.input_types[v.name] for v in ex.graph.inputs)]
                with self._exec_lock:
                    fn(params, *zeros)
            except Exception:  # noqa: BLE001 — surface on first real use
                return

    # -- compile ---------------------------------------------------------

    def _get_executor(self, bucket: int):
        with self._exec_lock:
            if bucket not in self._executors:
                import dataclasses

                cfg = dataclasses.replace(self._config, batch_size=bucket)
                ex = Executor(self._graph, cfg)
                if self._shared_params is None:
                    # Weights don't depend on the bucket: upload once and
                    # share the device tensors across buckets.
                    self._shared_params = ex.cast_params(ex.init_params())
                self._executors[bucket] = (ex, ex.build_fn(device=self._device),
                                           self._shared_params)
            return self._executors[bucket]

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    # -- public API ------------------------------------------------------

    def submit(self, *inputs: np.ndarray, timeout_ms: float | None = None) -> Future:
        """Enqueue one request (unbatched inputs, no leading batch dim).
        timeout_ms: end-to-end deadline — the future gets TimeoutError if
        the request is still queued at the deadline OR if its batch
        resolves after it (post-dispatch misses are counted in
        stats()['deadline_misses'])."""
        if not self._running:
            raise RuntimeError("server is shut down")
        req = _Request(inputs, timeout_ms)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            self.metrics.record_error()
            raise RuntimeError(
                f"server overloaded: queue depth {self._queue.maxsize} reached")
        return req.future

    def infer(self, *inputs: np.ndarray, timeout_ms: float | None = None):
        return self.submit(*inputs, timeout_ms=timeout_ms).result()

    def wait_ready(self, timeout: float | None = None) -> bool:
        """Wait until every bucket has been warmed (at once without a
        warmer); True if it finished within `timeout` seconds."""
        if self._warmer is not None:
            self._warmer.join(timeout)
            return not self._warmer.is_alive()
        return True

    def stats(self) -> dict:
        return self.metrics.snapshot()

    def shutdown(self, timeout: float = 10.0) -> None:
        """Stop the batcher and the warmer; both threads have exited when
        this returns (within `timeout` seconds each)."""
        self._running = False
        self._queue.put(None)
        self._thread.join(timeout)
        if self._warmer is not None:
            self._warmer.join(timeout)

    # -- batcher ---------------------------------------------------------

    def _collect(self, block: bool = True) -> list[_Request]:
        """Get the next batch. block=True waits for the first request;
        block=False returns [] almost immediately when the queue is idle
        (pipelined mode: the caller has a batch in flight to resolve)."""
        try:
            first = self._queue.get(timeout=None if block else 0.0005)
        except queue.Empty:
            return []
        if first is None:
            return []
        reqs = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(reqs) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                self._queue.put(None)
                break
            reqs.append(nxt)
        return reqs

    def _batch_loop(self) -> None:
        # Software pipeline: dispatch batch i, then collect batch i+1 while
        # the device executes i; resolve i's futures (host readback) only
        # after i+1 is dispatched. Asynchronous CUDA launches make the
        # device and the host batcher overlap.
        pending: tuple[list[_Request], int, tuple] | None = None
        while self._running:
            # While a batch is in flight, don't block on the queue — an idle
            # queue must not delay resolving the in-flight batch's futures.
            reqs = self._collect(block=pending is None)
            if not reqs and not self._running:
                if pending is not None:
                    self._resolve(*pending)
                return
            now = time.monotonic()
            for r in [r for r in reqs if r.expired(now)]:
                self.metrics.record_error()
                r.future.set_exception(TimeoutError("request deadline exceeded"))
            reqs = [r for r in reqs if not r.expired(now)]
            dispatched = None
            if reqs:
                try:
                    dispatched = self._dispatch(reqs)
                except Exception as e:  # noqa: BLE001 — fail requests, not the loop
                    self.metrics.record_error(len(reqs))
                    for r in reqs:
                        if not r.future.done():
                            r.future.set_exception(e)
            if pending is not None:
                self._resolve(*pending)
            pending = dispatched
        # Shutdown: resolve the in-flight batch and fail anything queued.
        if pending is not None:
            self._resolve(*pending)
        while True:
            try:
                left = self._queue.get_nowait()
            except queue.Empty:
                break
            if left is not None and not left.future.done():
                left.future.set_exception(RuntimeError("server is shut down"))

    def _dispatch(self, reqs: list[_Request]):
        n = len(reqs)
        bucket = self._bucket_for(n)
        ex, fn, params = self._get_executor(bucket)
        n_inputs = len(reqs[0].inputs)
        batch_inputs = []
        for i in range(n_inputs):
            stacked = np.stack([r.inputs[i] for r in reqs])
            if bucket > n:
                pad = np.zeros((bucket - n,) + stacked.shape[1:], stacked.dtype)
                stacked = np.concatenate([stacked, pad])
            batch_inputs.append(stacked)
        with self._exec_lock:
            outs = fn(params, *batch_inputs)  # async launches on the card
        return reqs, bucket, outs

    def _resolve(self, reqs: list[_Request], bucket: int, outs) -> None:
        try:
            host_outs = [to_numpy(o) for o in outs]  # sync point
        except Exception as e:  # noqa: BLE001 — device-side failure
            self.metrics.record_error(len(reqs))
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e)
            return
        t_done = time.monotonic()
        lat = [(t_done - r.t_enqueue) * 1e3 for r in reqs]
        self.metrics.record_batch(len(reqs), bucket, lat)
        for i, r in enumerate(reqs):
            if r.expired(t_done):
                # post-dispatch miss: the batch itself ran past the
                # deadline (e.g. a cold-bucket compile) — honor the SLA
                # and account for it rather than delivering late.
                self.metrics.record_deadline_miss()
                r.future.set_exception(
                    TimeoutError("request deadline exceeded during batch"))
            else:
                r.future.set_result([o[i] for o in host_outs])
