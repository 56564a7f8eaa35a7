"""Paged continuous-batching decode server (single shared KV pool).

The port's counterpart of `smelter_tpu/serving/paged_server.py::
PagedDecodeServer`. All slots share ONE pool of fixed-size pages per layer
(kernels/paged_decode_attention.py), each slot owns a page-table row, and
pages are allocated as sequences GROW and returned the moment they finish:
device memory is pages-in-use, whatever the mix of lengths.

The step graph is BATCHED (models/llama_style.py::
build_decode_step_paged): token (B, 1), pos (B,), page table (B, npg) and
one shared pool per layer, so no per-slot mapping is needed. Each tick runs
the step on the device and reads back only the (B,) greedy tokens. With
`tick_steps` T > 1 a tick chains T steps: prompt tokens ride in `forced`,
generated ones feed the next step on the device through argmax, and the
(B, T) tokens are read back once.

The pools are updated IN PLACE by PagedCacheUpdate, where the JAX server
donates them to a jitted step that returns new ones; the readers see the
same values. A failed step fails the in-flight requests and releases their
pages; nothing needs healing, since no buffer was given away.

Two disciplines keep shared pages safe with zero in-graph masking:
- scratch page (kv_pool.PagePool(scratch=True)): dead/stalled slots'
  table rows point at reserved page 0, so their unconditional writes land
  there instead of corrupting re-assigned pages;
- backpressure, not eviction: when the pool cannot grow a slot this tick
  (PoolExhausted), the slot is STALLED — it still rides the batched step
  (its row is pinned to the scratch page) but its result is not committed,
  and it resumes when pages free up. When every active slot is stalled,
  the least-progressed sequences are failed until one can move.

Prefill admission (`prefill_graphs`, `build_prefill` twins of the step
graph, the JAX package's `_build_paged_prefill_ladder`): a new request's
prompt runs one dense prefill forward of the smallest bucket that holds it,
and its cache rows are written into the slot's pages at position 0. Pages
are allocated for the prompt rows only; pad rows past them land on the
scratch page. When the pool cannot hold the prompt now (PoolExhausted) the
prompt is fed a token a tick instead, as the JAX server does; any other
prefill failure fails its own request (the JAX server falls back to feeding
there too, which would hide the failure). `stats()["prefills"]` counts the
prompts admitted by a prefill.

`SpecPagedDecodeServer` is the speculative form: each tick gamma + 1 draft
steps vmapped over the slots (the draft keeps small dense per-slot caches)
and ONE batched paged verify of gamma + 1 tokens a slot
(`build_decode_step_paged(chunk=gamma + 1)`).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future

import numpy as np
import torch

from ..kernels.paged_decode_attention import paged_cache_update
from .decode_server import (_Slot, _SpecTicks, _bucket, _build_prefill_ladder, _commit, _drain,
                            _prefill_into, _spec_inputs, _vmapped_draft)
from .kv_pool import PagePool, PoolExhausted


class PagedDecodeServer:
    """Continuous batching over a batched paged step graph.

    submit(prompt, n_new) -> Future of prompt+generated tokens (greedy;
    stop_tokens end early). Admission and growth are page-granular.
    """

    def __init__(self, step_graph, config=None,
                 stop_tokens: tuple[int, ...] = (), prefill_graphs=(),
                 tick_steps: int = 1):
        from ..runtime.config import Config
        from ..runtime.executor import Executor
        from ..runtime.generate import _cache_dtypes

        cfg = config or Config()
        ex = Executor(step_graph, cfg)
        self.device = ex.device
        self._params = ex.cast_params(ex.init_params())
        self._fn = ex.build_fn()
        host_map = {n: step_graph.initializers[n] for n in ex.param_names}
        # (plen, dense prefill forward), weights shared with the step's
        self._prefills = _build_prefill_ladder(prefill_graphs, self._params, host_map, cfg)
        self._input_names = [v.name for v in step_graph.inputs]
        shapes = {v.name: tuple(v.type.shape) for v in step_graph.inputs}
        self._pool_names = [n for n in self._input_names
                            if n.startswith(("k_pool_", "v_pool_",
                                             "k_scale_pool_",
                                             "v_scale_pool_"))]
        if not self._pool_names:
            raise ValueError("step graph has no k_pool_/v_pool_ inputs "
                             "(need build_decode_step_paged form)")
        self.slots, self.chunk = shapes["token"]
        if self.chunk != 1:
            raise NotImplementedError("paged server ticks at chunk=1")
        n_pages, page_size, _ = shapes[self._pool_names[0]]
        npg = shapes["page_table"][1]
        self.max_len = npg * page_size
        self.stop_tokens = set(stop_tokens)
        # ONE allocator for all layers: every layer's pool is indexed by
        # the same page table, so page p is "the" page p in all of them
        self.pool = PagePool(n_pages, page_size, self.slots, scratch=True)
        self.tick_steps = max(1, int(tick_steps))
        # floating pools run in the executor's compute dtype; made in it,
        # they are never converted (a converted copy would not be updated
        # in place)
        dts = _cache_dtypes(step_graph, cfg, self._pool_names)
        self._pools = [torch.zeros(shapes[n], dtype=d, device=self.device)
                       for n, d in zip(self._pool_names, dts)]
        self._table = self.pool.table(npg)
        self._npg = npg
        self._state = [_Slot() for _ in range(self.slots)]
        self._pending: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._shutdown = False
        self._wake = threading.Event()
        self._stall_ticks = 0  # observability: ticks with >=1 stalled slot
        self._steps = 0        # step-graph runs (tick_steps per tick)
        self._prefilled = 0    # prompts admitted by a prefill forward
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- public API ------------------------------------------------------

    def submit(self, prompt: list[int], n_new: int,
               context=None) -> Future:
        fut: Future = Future()
        if context:
            fut.set_exception(ValueError(
                "PagedDecodeServer does not take context arrays"))
            return fut
        if not prompt:
            fut.set_exception(ValueError("prompt must be non-empty"))
            return fut
        if len(prompt) >= self.max_len:
            fut.set_exception(ValueError(
                f"prompt length {len(prompt)} >= table capacity "
                f"{self.max_len}"))
            return fut
        if n_new <= 0:
            fut.set_result(list(prompt))
            return fut
        self._pending.put((list(prompt), int(n_new), fut))
        self._wake.set()
        return fut

    def stats(self) -> dict:
        with self._lock:
            return {
                "slots": self.slots,
                "active": sum(s.active for s in self._state),
                "queued": self._pending.qsize(),
                "free_pages": self.pool.free_pages,
                "page_size": self.pool.page_size,
                "stall_ticks": self._stall_ticks,
                "steps": self._steps,
                "prefills": self._prefilled,
            }

    def cache_bytes(self) -> int:
        """Device bytes of the shared pools (the whole pool is resident;
        pages-IN-USE is the scheduling quantity — see stats())."""
        return sum(p.numel() * p.element_size() for p in self._pools)

    def shutdown(self) -> None:
        self._shutdown = True
        self._wake.set()
        self._thread.join(timeout=30)

    # -- the step on the device ------------------------------------------

    def _run_step(self, tokens, pos, table) -> torch.Tensor:
        """One step graph: tokens (B, 1) and pos (B,) int64, table (B, npg)
        int32, all on the device. Updates the pools in place and returns
        the (B,) greedy tokens, still on the device."""
        by = {"token": tokens, "pos": pos, "page_table": table}
        by.update(zip(self._pool_names, self._pools))
        outs = self._fn(self._params, *[by[n] for n in self._input_names])
        self._pools = list(outs[1:])
        self._steps += 1
        return outs[0][:, -1, :].argmax(dim=-1)

    def _step_multi(self, tokens, pos, forced, nf, table) -> torch.Tensor:
        """T chained steps: step j feeds forced[:, j] where j < nf (the
        prompt), else step j-1's argmax. Returns (B, T): step j's argmax."""
        T = self.tick_steps
        tk, outs = tokens, []
        for j in range(T):
            out = self._run_step(tk[:, None], pos + j, table)
            outs.append(out)
            tk = torch.where(j < nf, forced[:, min(j, T - 2)], out)
        return torch.stack(outs, dim=1)

    # -- slot loop -------------------------------------------------------

    def _prefill_slot(self, i: int, prompt: list[int]):
        """Fill slot i's pages with one prefill forward. Allocates pages for
        the prompt rows only (pad rows past them land on the scratch page);
        raises PoolExhausted when the pool cannot hold the prompt now.
        Returns (fed, first) as DecodeServer._prefill_slot does."""
        p_len, fn, eff = _bucket(self._prefills, len(prompt))
        self.pool.ensure(i, eff)
        self._table = self.pool.table(self._npg, out=self._table)
        toks = np.zeros((p_len,), np.int64)
        toks[:eff] = prompt[:eff]
        dev = self.device
        with torch.inference_mode():
            outs = fn(self._params, torch.from_numpy(toks).to(dev))
            row = torch.from_numpy(self._table[i:i + 1]).to(dev)
            zero = torch.zeros(1, dtype=torch.int64, device=dev)
            for pool, rows in zip(self._pools, outs[1:]):
                paged_cache_update(pool, row, zero, rows[:p_len][None])
            first = int(outs[0][eff - 1].argmax()) if eff == len(prompt) else None
        self._prefilled += 1
        return eff - 1, first

    def _admit(self) -> None:
        for i, s in enumerate(self._state):
            if s.active:
                continue
            try:
                prompt, n_new, fut = self._pending.get_nowait()
            except queue.Empty:
                return
            n_new = min(n_new, self.max_len - len(prompt))
            fed = pos = 0
            last = prompt[0]
            generated: list[int] = []
            if self._prefills and len(prompt) > 1:
                try:
                    fed, first = self._prefill_slot(i, prompt)
                except PoolExhausted:
                    pass  # fed a token a tick instead, stalling until pages free
                except Exception as e:  # noqa: BLE001 — this request fails; the
                    # prefill wrote only slot i's pages and the scratch page
                    self.pool.release(i)
                    fut.set_exception(e)
                    continue
                else:
                    if first is not None:
                        generated = [first]
                        pos, last = len(prompt), first
                        if len(generated) >= n_new or first in self.stop_tokens:
                            fut.set_result(list(prompt) + generated)
                            self.pool.release(i)
                            continue
                    else:  # partial prefill: feed the rest a token a tick
                        pos, last = fed, prompt[fed]
            self._state[i] = _Slot(active=True, prompt=prompt, fed=fed, generated=generated,
                                   n_new=n_new, last_token=last, pos=pos, future=fut)

    def _loop(self) -> None:
        T = self.tick_steps
        dev = self.device
        while not self._shutdown:
            with self._lock:
                self._admit()
                active = [i for i, s in enumerate(self._state)
                          if s.active]
            if not active:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            # page growth BEFORE the step; slots the pool cannot grow are
            # stalled (they ride along but do not commit). Multi-step
            # ticks need T rows of headroom (capped at the table capacity
            # so the last tokens of a max-length sequence do not stall
            # forever).
            live: list[int] = []
            for i in active:
                s = self._state[i]
                try:
                    self.pool.ensure(i, min(s.pos + T, self.max_len))
                    live.append(i)
                except PoolExhausted:
                    pass
            if not live:
                # every active slot is stalled: pages can only free when
                # a sequence finishes, and nothing can step — resolve the
                # deadlock by failing the least-progressed sequence(s)
                # until someone can move (their pages return to the pool)
                with self._lock:
                    self._stall_ticks += 1
                    for i in sorted(active,
                                    key=lambda j: self._state[j].pos):
                        s = self._state[i]
                        s.future.set_exception(PoolExhausted(
                            "page pool exhausted by longer sequences"))
                        self._state[i] = _Slot()
                        self.pool.release(i)
                        nxt_i = [j for j in active if self._state[j].active]
                        if any(self.pool.pages_for(self._state[j].pos + 1)
                               - len(self.pool.pages_of(j))
                               <= self.pool.free_pages for j in nxt_i):
                            break
                continue
            if len(live) < len(active):
                self._stall_ticks += 1
            self._table = self.pool.table(self._npg, out=self._table)
            # stalled slots ride with their REAL pos: pos >= their page
            # capacity, so table[i, pos // ps] hits the zero-filled
            # (scratch) region and their writes are harmless; only
            # `live` slots commit results below
            tokens = np.zeros((self.slots,), np.int64)
            pos = np.zeros((self.slots,), np.int64)
            forced = np.zeros((self.slots, max(T - 1, 1)), np.int64)
            nf = np.zeros((self.slots,), np.int64)
            for i in active:
                s = self._state[i]
                tokens[i] = s.last_token
                pos[i] = s.pos
                nxt_prompt = s.prompt[s.pos + 1:s.pos + T]
                nf[i] = len(nxt_prompt)
                forced[i, :len(nxt_prompt)] = nxt_prompt
            try:
                with torch.inference_mode():
                    tok_d = torch.from_numpy(tokens).to(dev)
                    pos_d = torch.from_numpy(pos).to(dev)
                    table_d = torch.from_numpy(self._table).to(dev)
                    if T > 1:
                        nxt = self._step_multi(
                            tok_d, pos_d, torch.from_numpy(forced).to(dev),
                            torch.from_numpy(nf).to(dev), table_d)
                    else:
                        nxt = self._run_step(tok_d[:, None], pos_d, table_d)
                    nxt = nxt.cpu().numpy()
            except Exception as e:  # noqa: BLE001 — fail requests, keep
                # the serving thread; the pools were written in place, and
                # every page is released (before the callers hear of it), so
                # nothing stale is read again
                with self._lock:
                    failed = [s.future for s in self._state
                              if s.active and s.future is not None]
                    for i in range(self.slots):
                        self._state[i] = _Slot()
                        self.pool.release(i)
                    for fut in failed:
                        fut.set_exception(e)
                continue
            with self._lock:
                for i in live:
                    s = self._state[i]
                    if _commit(s, nxt[i], T, self.max_len, self.stop_tokens):
                        s.future.set_result(list(s.prompt) + s.generated)
                        self._state[i] = _Slot()
                        self.pool.release(i)  # pages free THIS tick
        _drain(self)


class SpecPagedDecodeServer(_SpecTicks):
    """Speculative continuous batching over the paged pool: each tick runs
    gamma + 1 draft steps vmapped over the slots and ONE batched paged
    chunk verify across all slots, SpecDecodeServer's tick with the
    target's KV memory paged. The draft keeps flat per-slot caches (a
    4-layer, 256-wide draft's caches are ~1 % of the target's); the target
    allocates pages as sequences grow and frees them when they finish.

    `chunk_graph` is a `build_decode_step_paged(chunk=gamma + 1,
    slots=B)` graph, `draft_graph` a `build_decode_step` graph (its weights
    join the target's uploaded set by name and content, so an early-exit
    self-draft shares every layer it has). `prefill_graphs` (dense target
    twins) write a new prompt's rows into its pages with one forward,
    `draft_prefill_graphs` fill its draft cache.

    The two servers' disciplines compose: rows of rejected drafts are
    overwritten before anything attends them (row i of a chunk attends
    rows <= pos + i); a stalled slot rides the tick with its real pos, so
    its target writes land on the scratch page and its round is not
    committed, and its draft writes hit its own rows, rewritten on resume.
    """

    def __init__(self, chunk_graph, draft_graph, config=None, draft_config=None,
                 stop_tokens: tuple[int, ...] = (), prefill_graphs=(), draft_prefill_graphs=(),
                 rounds_per_tick: int = 1):
        from ..runtime.config import Config
        from ..runtime.executor import Executor
        from ..runtime.generate import _cache_dtypes, _decode_graph, _merge_params, _step_io

        cfg = config or Config()
        dcfg = draft_config or cfg
        draft_graph = _decode_graph(draft_graph, dcfg)
        ex_t = Executor(chunk_graph, cfg)
        self.device = ex_t.device
        params = self._params = ex_t.cast_params(ex_t.init_params())
        host = {n: chunk_graph.initializers[n] for n in ex_t.param_names}
        chunk_fn = ex_t.build_fn()
        ex_d = _merge_params(params, host, draft_graph, dcfg)
        in_d, cn_d = _step_io(ex_d.graph)
        in_t = [v.name for v in chunk_graph.inputs]
        shapes_t = {v.name: tuple(v.type.shape) for v in chunk_graph.inputs}
        shapes_d = {v.name: tuple(v.type.shape) for v in ex_d.graph.inputs}
        self._pool_names = [n for n in in_t if n.startswith(
            ("k_pool_", "v_pool_", "k_scale_pool_", "v_scale_pool_"))]
        if not self._pool_names:
            raise ValueError("chunk graph has no k_pool_/v_pool_ inputs "
                             "(need build_decode_step_paged form)")
        self.slots, c = shapes_t["token"]
        self.gamma = c - 1
        if self.gamma < 1:
            raise ValueError("chunk graph must take >= 2 tokens")
        n_pages, page_size, _ = shapes_t[self._pool_names[0]]
        self._npg = npg = shapes_t["page_table"][1]
        self.max_len = min(npg * page_size, shapes_d[cn_d[0]][0])
        self.stop_tokens = set(stop_tokens)
        self.rounds_per_tick = max(1, int(rounds_per_tick))
        # one allocator for all layers; page 0 is the scratch page
        self.pool = PagePool(n_pages, page_size, self.slots, scratch=True)
        self._prefills = _build_prefill_ladder(prefill_graphs, params, host, cfg)
        self._d_prefills = _build_prefill_ladder(draft_prefill_graphs, params, host, dcfg)

        def verify_all(toks, pos):
            # ONE batched paged verify: (B, gamma + 1) tokens -> greedy tokens
            by = {"token": toks, "pos": pos, "page_table": self._table_d}
            by.update(zip(self._pool_names, self._pools))
            return chunk_fn(params, *[by[n] for n in in_t])[0].argmax(-1)

        draft_v = _vmapped_draft(ex_d.build_fn(donate=cn_d), params, in_d, cn_d)
        self._draft_all = lambda tok, pos: draft_v(tok, pos, *self._d_caches)
        self._verify_all = verify_all
        dts_t = _cache_dtypes(chunk_graph, cfg, self._pool_names)
        dts_d = _cache_dtypes(ex_d.graph, dcfg, cn_d)
        self._pools = [torch.zeros(shapes_t[n], dtype=d, device=self.device)
                       for n, d in zip(self._pool_names, dts_t)]
        self._d_caches = [torch.zeros((self.slots,) + shapes_d[n], dtype=d, device=self.device)
                          for n, d in zip(cn_d, dts_d)]
        self._table = self.pool.table(npg)
        self._table_d = None
        self._state = [_Slot() for _ in range(self.slots)]
        self._pending: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._shutdown = False
        self._wake = threading.Event()
        self._ticks = 0
        self._rounds = 0
        self._prefilled = 0
        self._acc_num = 0
        self._acc_den = 0
        self._stall_ticks = 0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    shutdown = PagedDecodeServer.shutdown
    _prefill_slot = PagedDecodeServer._prefill_slot

    def submit(self, prompt: list[int], n_new: int, context=None) -> Future:
        fut: Future = Future()
        if context:
            fut.set_exception(ValueError("SpecPagedDecodeServer does not take context arrays"))
            return fut
        if not prompt:
            fut.set_exception(ValueError("prompt must be non-empty"))
            return fut
        if len(prompt) + self.gamma >= self.max_len:
            fut.set_exception(ValueError(
                f"prompt length {len(prompt)} too long for max_len {self.max_len} at gamma "
                f"{self.gamma}"))
            return fut
        n_new = min(int(n_new), self.max_len - len(prompt) - self.gamma)
        if n_new <= 0:
            fut.set_result(list(prompt))
            return fut
        self._pending.put((list(prompt), n_new, fut))
        self._wake.set()
        return fut

    def stats(self) -> dict:
        with self._lock:
            return {"slots": self.slots,
                    "active": sum(s.active for s in self._state),
                    "queued": self._pending.qsize(),
                    "free_pages": self.pool.free_pages,
                    "page_size": self.pool.page_size,
                    "stall_ticks": self._stall_ticks, **self._spec_stats()}

    def cache_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self._pools + self._d_caches)

    # -- slot loop -------------------------------------------------------

    def _admit(self) -> None:
        for i, s in enumerate(self._state):
            if s.active:
                continue
            try:
                prompt, n_new, fut = self._pending.get_nowait()
            except queue.Empty:
                return
            fed = 0
            if len(prompt) > 1:
                try:
                    if self._prefills:
                        # fed: the last prompt token whose pool row is written
                        try:
                            fed, _ = self._prefill_slot(i, prompt)
                        except PoolExhausted:
                            fed = 0  # forced drafts take the prompt, stalling as needed
                    if self._d_prefills:
                        _prefill_into(self._d_prefills, self._params, self._d_caches, i, prompt,
                                      self.device)
                except Exception as e:  # noqa: BLE001 — this request fails; the
                    # prefills wrote only slot i's pages and rows
                    self.pool.release(i)
                    fut.set_exception(e)
                    continue
            self._state[i] = _Slot(active=True, prompt=prompt, fed=fed, n_new=n_new,
                                   last_token=prompt[fed], pos=fed, future=fut)

    def _evict(self, active: list[int]) -> None:
        """Every active slot is stalled: fail the least-progressed sequences
        until one of the rest can grow."""
        g = self.gamma
        with self._lock:
            self._stall_ticks += 1
            for i in sorted(active, key=lambda j: self._state[j].pos):
                self._state[i].future.set_exception(PoolExhausted(
                    "page pool exhausted by longer sequences"))
                self._state[i] = _Slot()
                self.pool.release(i)
                rest = [j for j in active if self._state[j].active]
                if any(self.pool.pages_for(self._state[j].pos + g + 1)
                       - len(self.pool.pages_of(j)) <= self.pool.free_pages for j in rest):
                    break

    def _loop(self) -> None:
        g, R = self.gamma, self.rounds_per_tick
        while not self._shutdown:
            with self._lock:
                self._admit()
                active = [i for i, s in enumerate(self._state) if s.active]
            if not active:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            # several rounds a tick need every active slot past its prompt
            # with R (gamma + 1) rows of room in the table and in pages
            multi = R > 1 and all(
                self._state[i].pos + 1 >= len(self._state[i].prompt)
                and self._state[i].pos + R * (g + 1) < self.max_len for i in active)
            if multi:
                try:
                    for i in active:
                        self.pool.ensure(i, self._state[i].pos + R * (g + 1))
                except PoolExhausted:
                    multi = False
            live: list[int] = []
            for i in active:
                try:  # a round writes rows pos .. pos + gamma
                    self.pool.ensure(i, self._state[i].pos + (R if multi else 1) * (g + 1))
                    live.append(i)
                except PoolExhausted:
                    pass
            if not live:
                self._evict(active)
                continue
            if len(live) < len(active):
                self._stall_ticks += 1
            self._table = self.pool.table(self._npg, out=self._table)
            inputs = _spec_inputs(self._state, self.slots, g)
            try:
                self._table_d = torch.from_numpy(self._table).to(self.device)
                emit, acc = self._run_tick(multi, *inputs)
            except Exception as e:  # noqa: BLE001 — fail the requests and release
                # every page; the pools were written in place
                with self._lock:
                    failed = [s.future for s in self._state if s.active and s.future]
                    for i in range(self.slots):
                        self._state[i] = _Slot()
                        self.pool.release(i)
                    for fut in failed:
                        fut.set_exception(e)
                continue
            with self._lock:
                self._ticks += 1
                self._rounds += R if multi else 1
                for i in self._commit_tick(live, multi, emit, acc, *inputs[4:]):
                    s = self._state[i]
                    s.future.set_result(list(s.prompt) + s.generated)
                    self._state[i] = _Slot()
                    self.pool.release(i)
        _drain(self)
