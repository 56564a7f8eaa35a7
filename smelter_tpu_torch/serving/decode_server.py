"""Continuous-batching decode serving over a static-cache step graph.

The port's counterpart of `smelter_tpu/serving/decode_server.py`
(`DecodeServer`, `_build_prefill_ladder`, `_Slot`). DecodeServer keeps B
slots of device-resident KV cache, `(slots, max_len, kvd)` a layer, and
runs ONE step for all slots a tick: the batch-1 step graph
(`models/llama_style.py::build_decode_step`) is mapped over the slots with
`torch.func.vmap`, as the JAX server `jax.vmap`s it. Its kernels are
`torch.library` custom ops whose vmap rules fold the slot axis into their
own (`int4_matmul` into M, `ragged_decode_attention` into its slot grid), so
a tick launches each once a layer for all slots, not once a slot. New
requests are admitted into free slots mid-flight and finished sequences
free their slot at once. With `tick_steps` T > 1 a tick chains T steps:
prompt tokens ride in `forced`, generated ones feed the next step on the
device through argmax, and the (B, T) tokens are read back once.

A reused slot needs no cache reset: a sequence reads only rows <= its
position and writes each row before it first reads it, so whatever the
previous occupant left is never observed.

The caches are donated to the step (`Executor.build_fn(donate=...)`): its
ScatterND writes update them in place, where the JAX server donates them to
a jitted step that returns new ones; readers see the same values. So the JAX
package's `_heal_caches` has no counterpart: a failed step gives no buffer
away, and it fails the in-flight requests and nothing else.

Prefill admission (`prefill_graphs`, `build_prefill` twins of the step
graph): a new request's prompt fills its slot's cache rows with one forward
of the smallest bucket that holds it (pad rows are written before they are
read); a longer prompt fills the largest bucket and feeds the rest a token
a tick. A prefill that fails fails its own request: the JAX server falls
back to feeding the prompt a token a tick, which would hide the failure.
Context inputs (cross-attention decoders), SpecDecodeServer and
BucketedDecodeServer are not ported yet.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch


def _build_prefill_ladder(graphs, params: dict, host_map: dict, cfg) -> list:
    """[(plen, fn)] sorted by plen: each prefill graph's forward, its
    weights shared with the step graph's by name and content. fn(params,
    tokens (plen,)) -> (logits (plen, vocab), *caches (max_len, ...)), the
    caches in the step graph's cache-input order."""
    from ..ir.errors import NotSupportedError
    from ..runtime.generate import _merge_params

    out = []
    for g in graphs:
        if [v.name for v in g.inputs] != ["tokens"]:
            raise NotSupportedError("a prefill graph takes one input, tokens")
        pex = _merge_params(params, host_map, g, cfg)
        out.append((g.inputs[0].type.shape[0], pex.build_fn()))
    out.sort(key=lambda t: t[0])
    return out


def _bucket(prefills: list, n: int):
    """(bucket length, fn, rows of the prompt it takes) for an n-token
    prompt: the smallest bucket that holds it, else the largest."""
    ups = [p for p, _ in prefills if p >= n]
    p_len = min(ups) if ups else max(p for p, _ in prefills)
    return p_len, dict(prefills)[p_len], min(n, p_len)


@dataclass
class _Slot:
    active: bool = False
    prompt: list[int] = field(default_factory=list)
    fed: int = 0                 # tokens of the prompt already consumed
    generated: list[int] = field(default_factory=list)
    n_new: int = 0
    last_token: int = 0
    pos: int = 0
    future: Future | None = None


def _commit(s: _Slot, out, T: int, max_len: int, stop_tokens) -> bool:
    """Take one tick's tokens for slot s (out: its (T,) tokens, or its token
    at T = 1); True when the sequence is done."""
    if T > 1:
        # out[j] predicts sequence position s.pos + j + 1; those past the
        # prompt are generated tokens (greedy chain on the device)
        plen = len(s.prompt)
        start = s.pos
        s.pos = min(start + T, max_len)
        s.fed = min(plen - 1, s.pos)
        for j in range(T):
            idx = start + j + 1
            if idx < plen:
                continue
            tok = int(out[j])
            s.generated.append(tok)
            if len(s.generated) >= s.n_new or tok in stop_tokens or idx >= max_len:
                s.generated = s.generated[:s.n_new]
                return True
        seq = s.prompt + s.generated
        s.last_token = seq[s.pos] if s.pos < len(seq) else seq[-1]
        return False
    s.pos += 1
    if s.fed + 1 < len(s.prompt):  # still feeding the prompt
        s.fed += 1
        s.last_token = s.prompt[s.fed]
        return False
    tok = int(out)
    s.generated.append(tok)
    s.last_token = tok
    return len(s.generated) >= s.n_new or tok in stop_tokens or s.pos >= max_len


class DecodeServer:
    """Continuous batching over a FusedGenerator-compatible step graph.

    submit(prompt, n_new) -> Future resolving to prompt + generated tokens.
    Greedy decoding; stop_tokens end a sequence early. `shared_weights`
    (another server's `shared_weights()`) serves the same model at another
    cache length without a second copy of the weights.
    """

    def __init__(self, step_graph, slots: int = 8, config=None,
                 stop_tokens: tuple[int, ...] = (), prefill_graphs=(),
                 shared_weights=None, tick_steps: int = 1):
        from ..runtime.config import Config
        from ..runtime.executor import Executor
        from ..runtime.generate import _cache_dtypes, _decode_graph, _merge_params, _step_io

        self.slots = slots
        self.stop_tokens = set(stop_tokens)
        cfg = config or Config()
        step_graph = _decode_graph(step_graph, cfg)
        if shared_weights is None:
            ex = Executor(step_graph, cfg)
            params = ex.cast_params(ex.init_params())
            host_map = {n: step_graph.initializers[n] for n in ex.param_names}
        else:
            params, host_map = shared_weights
            ex = _merge_params(params, host_map, step_graph, cfg)
            step_graph = ex.graph
        self._params, self._host_map = params, host_map
        self.device = ex.device
        input_names, cache_names = _step_io(step_graph)
        self._cache_names = cache_names
        fn = ex.build_fn(donate=cache_names)
        shapes = {v.name: tuple(v.type.shape) for v in step_graph.inputs}
        self.max_len = shapes[cache_names[0]][0]
        self.tick_steps = max(1, int(tick_steps))

        def one(tok, pos, *caches):
            # one slot's step: its (1,) token and position, its caches
            # (updated in place); the greedy token stays on the device
            by = {"token": tok, "pos": pos}
            by.update(zip(cache_names, caches))
            return fn(params, *[by[n] for n in input_names])[0][0].argmax()

        self._step_all = torch.func.vmap(one)
        self._prefills = _build_prefill_ladder(prefill_graphs, params, host_map, cfg)
        dts = _cache_dtypes(step_graph, cfg, cache_names)
        self._caches = [torch.zeros((slots,) + shapes[n], dtype=d, device=self.device)
                        for n, d in zip(cache_names, dts)]
        self._state = [_Slot() for _ in range(slots)]
        self._pending: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._shutdown = False
        self._wake = threading.Event()
        self._steps = 0     # step-graph runs (tick_steps a tick)
        self._prefilled = 0  # prompts admitted by a prefill forward
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- public API ------------------------------------------------------

    def submit(self, prompt: list[int], n_new: int, context=None) -> Future:
        fut: Future = Future()
        if context:
            fut.set_exception(ValueError("DecodeServer does not take context arrays"))
            return fut
        if not prompt:
            fut.set_exception(ValueError("prompt must be non-empty"))
            return fut
        if len(prompt) >= self.max_len:
            fut.set_exception(ValueError(
                f"prompt length {len(prompt)} >= cache max_len {self.max_len}"))
            return fut
        if n_new <= 0:
            fut.set_result(list(prompt))  # FusedGenerator parity
            return fut
        self._pending.put((list(prompt), int(n_new), fut))
        self._wake.set()
        return fut

    def stats(self) -> dict:
        with self._lock:
            return {"slots": self.slots,
                    "active": sum(s.active for s in self._state),
                    "queued": self._pending.qsize(),
                    "steps": self._steps,
                    "prefills": self._prefilled}

    def shared_weights(self) -> tuple[dict, dict]:
        """(device params, host arrays by name), for another server of the
        same model."""
        return self._params, self._host_map

    def cache_bytes(self) -> int:
        """Device bytes held by this server's KV caches (all slots)."""
        return sum(c.numel() * c.element_size() for c in self._caches)

    def shutdown(self) -> None:
        self._shutdown = True
        self._wake.set()
        self._thread.join(timeout=30)

    # -- the step on the device -------------------------------------------

    def _run_step(self, tokens, pos) -> torch.Tensor:
        """One step for every slot: tokens and pos (B, 1) int64 on the
        device. Updates the caches in place; returns the (B,) greedy
        tokens, still on the device."""
        self._steps += 1
        return self._step_all(tokens, pos, *self._caches)

    def _step_multi(self, tokens, pos, forced, nf) -> torch.Tensor:
        """T chained steps: step j feeds forced[:, j] where j < nf (the
        prompt), else step j-1's argmax. Returns (B, T)."""
        T = self.tick_steps
        tk, outs = tokens, []
        for j in range(T):
            out = self._run_step(tk[:, None], (pos + j)[:, None])
            outs.append(out)
            tk = torch.where(j < nf, forced[:, min(j, T - 2)], out)
        return torch.stack(outs, dim=1)

    # -- slot loop -------------------------------------------------------

    def _prefill_slot(self, i: int, prompt: list[int]):
        """Fill slot i's cache rows with one prefill forward. Returns (fed,
        first): `fed` is the index of the last prompt token whose row was
        written, `first` the greedy first generation when the whole prompt
        fit the bucket, else None (the rest of the prompt feeds a token a
        tick)."""
        p_len, fn, eff = _bucket(self._prefills, len(prompt))
        toks = np.zeros((p_len,), np.int64)
        toks[:eff] = prompt[:eff]
        with torch.inference_mode():
            outs = fn(self._params, torch.from_numpy(toks).to(self.device))
            for c, new in zip(self._caches, outs[1:]):
                c[i].copy_(new)
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
                except Exception as e:  # noqa: BLE001 — this request fails; the
                    # prefill wrote only slot i's rows, so the others go on
                    fut.set_exception(e)
                    continue
                if first is not None:
                    # the whole prompt prefilled: its logits give the first token
                    generated = [first]
                    pos, last = len(prompt), first
                    if len(generated) >= n_new or first in self.stop_tokens:
                        fut.set_result(list(prompt) + generated)
                        continue
                else:
                    pos, last = fed, prompt[fed]
            self._state[i] = _Slot(active=True, prompt=prompt, fed=fed, generated=generated,
                                   n_new=n_new, last_token=last, pos=pos, future=fut)

    def _loop(self) -> None:
        T = self.tick_steps
        dev = self.device
        while not self._shutdown:
            with self._lock:
                self._admit()
                active = [i for i, s in enumerate(self._state) if s.active]
            if not active:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
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
                    if T > 1:
                        nxt = self._step_multi(tok_d, pos_d, torch.from_numpy(forced).to(dev),
                                               torch.from_numpy(nf).to(dev))
                    else:
                        nxt = self._run_step(tok_d[:, None], pos_d[:, None])
                    nxt = nxt.cpu().numpy()
            except Exception as e:  # noqa: BLE001 — fail the requests, keep the
                # serving thread; the caches were written in place, so nothing
                # needs healing
                with self._lock:
                    failed = [s.future for s in self._state if s.active and s.future]
                    self._state = [_Slot() for _ in range(self.slots)]
                    for fut in failed:
                        fut.set_exception(e)
                continue
            with self._lock:
                for i in active:
                    s = self._state[i]
                    if _commit(s, nxt[i], T, self.max_len, self.stop_tokens):
                        s.future.set_result(list(s.prompt) + s.generated)
                        self._state[i] = _Slot()
        with self._lock:
            for s in self._state:
                if s.active and s.future is not None and not s.future.done():
                    s.future.set_exception(RuntimeError("server shut down"))
            while True:
                try:
                    *_rest, fut = self._pending.get_nowait()
                except queue.Empty:
                    break
                fut.set_exception(RuntimeError("server shut down"))
