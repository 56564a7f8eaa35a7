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

`SpecDecodeServer` is the speculative form (a draft-and-verify round for
all slots a tick, `runtime/speculative.py`'s rounds over slots) and
`BucketedDecodeServer` a ladder of plain and speculative servers of
several cache lengths over one uploaded weight set. Context inputs
(cross-attention decoders) are not ported yet.
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


def _prefill_into(prefills, params, caches, i: int, prompt: list[int], device):
    """Fill slot i of `caches` with one prefill forward of the prompt's
    bucket. Returns (the forward's logits, rows of the prompt it took)."""
    p_len, fn, eff = _bucket(prefills, len(prompt))
    toks = np.zeros((p_len,), np.int64)
    toks[:eff] = prompt[:eff]
    with torch.inference_mode():
        outs = fn(params, torch.from_numpy(toks).to(device))
        for c, new in zip(caches, outs[1:]):
            c[i].copy_(new)
    return outs[0], eff


def _drain(server) -> None:
    """Fail every request a stopping server still holds, in a slot or
    queued."""
    with server._lock:
        for s in server._state:
            if s.active and s.future is not None and not s.future.done():
                s.future.set_exception(RuntimeError("server shut down"))
        while True:
            try:
                *_rest, fut = server._pending.get_nowait()
            except queue.Empty:
                break
            fut.set_exception(RuntimeError("server shut down"))


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
        logits, eff = _prefill_into(self._prefills, self._params, self._caches, i, prompt,
                                    self.device)
        first = int(logits[eff - 1].argmax()) if eff == len(prompt) else None
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
        _drain(self)


def _vmapped_draft(draft_fn, params, in_d, cn_d):
    """The draft step vmapped over slots: (tokens (B, 1), pos (B, 1),
    *caches) -> (B,) greedy tokens, left on the device; the caches are
    updated in place."""
    def one(tok, pos, *caches):
        by = {"token": tok, "pos": pos}
        by.update(zip(cn_d, caches))
        return draft_fn(params, *[by[n] for n in in_d])[0][-1].argmax()

    return torch.func.vmap(one)


def _spec_inputs(state, slots: int, g: int):
    """(tokens, prevs, pos, forced, n_forced, free) of a speculative tick,
    as numpy arrays: a slot still on its prompt passes its next prompt
    tokens as forced drafts; `free` once the prompt is consumed."""
    toks = np.zeros((slots,), np.int64)
    prevs = np.zeros((slots,), np.int64)
    pos = np.zeros((slots,), np.int64)
    forced = np.zeros((slots, g), np.int64)
    n_forced = np.zeros((slots,), np.int64)
    free = np.zeros((slots,), bool)
    for i, s in enumerate(state):
        if not s.active:
            continue
        seq = s.prompt + s.generated
        toks[i] = seq[s.pos]
        prevs[i] = seq[max(s.pos - 1, 0)]
        pos[i] = s.pos
        rem = s.prompt[s.pos + 1:s.pos + 1 + g]
        n_forced[i] = len(rem)
        forced[i, :len(rem)] = rem
        free[i] = s.pos + 1 + len(rem) >= len(s.prompt)
    return toks, prevs, pos, forced, n_forced, free


def _spec_round(draft_all, verify_all, g: int, tok, prev, pos, forced, n_forced, free):
    """One draft-and-verify round for every slot, on the device: a catch-up
    draft step at pos - 1 (after a fully accepted round the draft never
    ingested its last draft token), gamma draft steps, one verify of the
    gamma + 1 tokens. Forced drafts (the prompt) are taken as given; a draft
    beyond them counts only once the prompt is consumed (`free`). Returns
    the target's (B, gamma + 1) greedy tokens and the (B,) accepted
    count."""
    tk, drafts = prev, []
    for j in range(-1, g):
        nxt = draft_all(tk[:, None], (pos + j).clamp_min(0)[:, None])
        if j < 0:
            tk = tok
            continue
        tk = torch.where(j < n_forced, forced[:, j], nxt)
        drafts.append(tk)
    drafts = torch.stack(drafts, dim=1)  # (B, gamma)
    tnext = verify_all(torch.cat([tok[:, None], drafts], dim=1), pos)
    steps = torch.arange(g, device=tok.device)[None]
    ok = (steps < n_forced[:, None]) | (free[:, None] & (drafts == tnext[:, :g]))
    return tnext, torch.cumprod(ok.long(), dim=1).sum(dim=1)


def _spec_rounds(draft_all, verify_all, g: int, R: int, tok, prev, pos):
    """R rounds chained on the device for slots past their prompts: each
    round's last token, the one before it and its position feed the next.
    Returns (B, R, gamma + 1) tokens and (B, R) accepted counts."""
    zf = torch.zeros((tok.shape[0], g), dtype=torch.int64, device=tok.device)
    zn = torch.zeros_like(tok)
    fr = torch.ones_like(tok, dtype=torch.bool)
    emits, accs = [], []
    for _ in range(R):
        tnext, a = _spec_round(draft_all, verify_all, g, tok, prev, pos, zf, zn, fr)
        emits.append(tnext)
        accs.append(a)
        prev = torch.where(a > 0, tnext.gather(1, (a - 1).clamp_min(0)[:, None])[:, 0], tok)
        tok = tnext.gather(1, a[:, None])[:, 0]
        pos = pos + a + 1
    return torch.stack(emits, dim=1), torch.stack(accs, dim=1)


class _SpecTicks:
    """What both speculative servers share: running a tick on the device,
    applying a round's (accepted count, tokens) to a slot, and the
    acceptance counts (draft positions past the prompt only: forced prompt
    tokens are always accepted and would inflate the rate)."""

    def _apply_round(self, s: _Slot, a: int, nf: int, row, was_free: bool) -> bool:
        """Take one round into slot s; True when the request is done. A
        token for sequence position pos + j + 1 is generated only once past
        the prompt; a bonus token inside the prompt is dropped."""
        g = self.gamma
        if was_free and g > nf:
            self._acc_den += g - nf
            self._acc_num += max(0, a - nf)
        plen = len(s.prompt)
        new = [int(row[j]) for j in range(nf, a + 1) if s.pos + j + 1 >= plen]
        s.pos += a + 1
        for tok in new:
            s.generated.append(tok)
            if len(s.generated) >= s.n_new or tok in self.stop_tokens:
                s.generated = s.generated[:s.n_new]
                return True
        return False

    def _commit_tick(self, slots, multi: bool, emit, acc, n_forced, free) -> list[int]:
        """Apply a tick to `slots` (indices); returns those that finished."""
        done_slots = []
        for i in slots:
            s = self._state[i]
            if multi:  # emit (B, R, g + 1), acc (B, R): the rounds in order;
                # rounds past a finish are dropped (their rows die with the slot)
                for r in range(self.rounds_per_tick):
                    done = self._apply_round(s, int(acc[i, r]), 0, emit[i, r], True)
                    if done:
                        break
            else:
                done = self._apply_round(s, int(acc[i]), int(n_forced[i]), emit[i],
                                         bool(free[i]))
            if done:
                done_slots.append(i)
        return done_slots

    def _run_tick(self, multi: bool, toks, prevs, pos, forced, n_forced, free):
        """One tick on the device (R rounds where `multi`, else one), its
        (emit, accepted) read back as numpy."""
        dev, g = self.device, self.gamma
        with torch.inference_mode():
            t = [torch.from_numpy(a).to(dev) for a in (toks, prevs, pos)]
            if multi:
                emit, acc = _spec_rounds(self._draft_all, self._verify_all, g,
                                         self.rounds_per_tick, *t)
            else:
                emit, acc = _spec_round(self._draft_all, self._verify_all, g, *t,
                                        *(torch.from_numpy(a).to(dev)
                                          for a in (forced, n_forced, free)))
            return emit.cpu().numpy(), acc.cpu().numpy()

    def _spec_stats(self) -> dict:
        return {"ticks": self._ticks, "rounds": self._rounds,
                "accept_rate": self._acc_num / self._acc_den if self._acc_den else None,
                "gamma": self.gamma, "prefills": self._prefilled}


class SpecDecodeServer(_SpecTicks):
    """Speculative continuous batching: each tick runs one draft-and-verify
    round for all slots (gamma + 1 draft steps and one (gamma + 1)-token
    chunk verify, each vmapped over the slots), up to gamma + 1 tokens a
    slot a tick, with greedy tokens identical to DecodeServer's.

    A slot still on its prompt passes its next prompt tokens as FORCED
    drafts (accepted as given), so prompts also go in gamma + 1 tokens a
    tick and the draft sees them. `prefill_graphs` (target twins) fill a new
    slot's target caches with one forward instead; `draft_prefill_graphs`
    do the same for the draft (without them the draft starts blind on that
    prompt: acceptance suffers, the tokens do not). `rounds_per_tick` R > 1
    chains R rounds on the device when every active slot is past its prompt
    with R (gamma + 1) rows of room, else the tick runs one round. The host
    keeps each slot's token sequence and reads back (emit (B, gamma + 1),
    accepted (B,)) once a tick. The draft's weights join the target's
    uploaded set (`_merge_params`), so an early-exit self-draft shares
    every layer it has with the target.
    """

    def __init__(self, step_graph, chunk_graph, draft_graph, slots: int = 4, config=None,
                 draft_config=None, stop_tokens: tuple[int, ...] = (), prefill_graphs=(),
                 draft_prefill_graphs=(), shared_weights=None, rounds_per_tick: int = 1):
        from ..runtime.config import Config
        from ..runtime.executor import Executor
        from ..runtime.generate import _cache_dtypes, _decode_graph, _merge_params, _step_io

        self.slots = slots
        self.stop_tokens = set(stop_tokens)
        cfg = config or Config()
        dcfg = draft_config or cfg
        step_graph = _decode_graph(step_graph, cfg)
        chunk_graph = _decode_graph(chunk_graph, cfg)
        draft_graph = _decode_graph(draft_graph, dcfg)
        if shared_weights is None:
            ex_t = Executor(step_graph, cfg)
            params = ex_t.cast_params(ex_t.init_params())
            host_map = {n: step_graph.initializers[n] for n in ex_t.param_names}
        else:
            params, host_map = shared_weights
            ex_t = _merge_params(params, host_map, step_graph, cfg)
            step_graph = ex_t.graph
        self._params, self._host_map = params, host_map
        self.device = ex_t.device
        ex_c = _merge_params(params, host_map, chunk_graph, cfg)
        ex_d = _merge_params(params, host_map, draft_graph, dcfg)
        _, cn_t = _step_io(step_graph)
        in_c, cn_c = _step_io(ex_c.graph)
        in_d, cn_d = _step_io(ex_d.graph)
        if cn_c != cn_t:
            raise ValueError("chunk_graph's caches differ from step_graph's")
        chunk_fn = ex_c.build_fn(donate=cn_c)
        shapes_t = {v.name: tuple(v.type.shape) for v in step_graph.inputs}
        shapes_d = {v.name: tuple(v.type.shape) for v in ex_d.graph.inputs}
        self.max_len = min(shapes_t[cn_t[0]][0], shapes_d[cn_d[0]][0])
        self.gamma = next(v.type.shape[0] for v in chunk_graph.inputs if v.name == "token") - 1
        if self.gamma < 1:
            raise ValueError("chunk_graph must take >= 2 tokens")
        self.rounds_per_tick = max(1, int(rounds_per_tick))

        def verify_one(toks, pos, *caches):
            # one slot's (gamma + 1)-token verify: the target's greedy tokens
            by = {"token": toks, "pos": pos}
            by.update(zip(cn_t, caches))
            return chunk_fn(params, *[by[n] for n in in_c])[0].argmax(-1)

        draft_v = _vmapped_draft(ex_d.build_fn(donate=cn_d), params, in_d, cn_d)
        verify_v = torch.func.vmap(verify_one)
        self._draft_all = lambda tok, pos: draft_v(tok, pos, *self._d_caches)
        self._verify_all = lambda toks, pos: verify_v(toks, pos[:, None], *self._t_caches)
        self._prefills = _build_prefill_ladder(prefill_graphs, params, host_map, cfg)
        self._d_prefills = _build_prefill_ladder(draft_prefill_graphs, params, host_map, dcfg)
        dts_t = _cache_dtypes(step_graph, cfg, cn_t)
        dts_d = _cache_dtypes(ex_d.graph, dcfg, cn_d)
        self._t_caches = [torch.zeros((slots,) + shapes_t[n], dtype=d, device=self.device)
                          for n, d in zip(cn_t, dts_t)]
        self._d_caches = [torch.zeros((slots,) + shapes_d[n], dtype=d, device=self.device)
                          for n, d in zip(cn_d, dts_d)]
        self._state = [_Slot() for _ in range(slots)]
        self._pending: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._shutdown = False
        self._wake = threading.Event()
        self._ticks = 0      # ticks run
        self._rounds = 0     # draft-and-verify rounds run (R a multi-round tick)
        self._prefilled = 0  # target prefill forwards at admission
        self._acc_num = 0
        self._acc_den = 0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- public API ------------------------------------------------------

    submit = DecodeServer.submit
    shutdown = DecodeServer.shutdown
    shared_weights = DecodeServer.shared_weights

    def stats(self) -> dict:
        with self._lock:
            return {"slots": self.slots,
                    "active": sum(s.active for s in self._state),
                    "queued": self._pending.qsize(), **self._spec_stats()}

    def cache_bytes(self) -> int:
        """Device bytes of the target AND draft KV caches."""
        return sum(c.numel() * c.element_size() for c in self._t_caches + self._d_caches)

    # -- slot loop -------------------------------------------------------

    def _admit(self) -> None:
        for i, s in enumerate(self._state):
            if s.active:
                continue
            try:
                prompt, n_new, fut = self._pending.get_nowait()
            except queue.Empty:
                return
            n_new = min(n_new, self.max_len - len(prompt) - self.gamma)
            if n_new < 1:
                fut.set_result(list(prompt))
                continue
            fed = 0
            if len(prompt) > 1:
                try:
                    if self._prefills:
                        fed = _prefill_into(self._prefills, self._params, self._t_caches, i,
                                            prompt, self.device)[1] - 1
                        self._prefilled += 1
                    if self._d_prefills:
                        _prefill_into(self._d_prefills, self._params, self._d_caches, i, prompt,
                                      self.device)
                except Exception as e:  # noqa: BLE001 — this request fails; the
                    # prefills wrote only slot i's rows
                    fut.set_exception(e)
                    continue
            # fed: the last prompt token whose target row is written; the
            # ticks take prompt[fed + 1:] as forced drafts
            self._state[i] = _Slot(active=True, prompt=prompt, fed=fed, n_new=n_new,
                                   last_token=prompt[fed], pos=fed, future=fut)

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
            multi = R > 1 and all(
                self._state[i].pos + 1 >= len(self._state[i].prompt)
                and self._state[i].pos + R * (g + 1) < self.max_len for i in active)
            inputs = _spec_inputs(self._state, self.slots, g)
            try:
                emit, acc = self._run_tick(multi, *inputs)
            except Exception as e:  # noqa: BLE001 — fail the requests, keep the
                # serving thread; the caches were written in place
                with self._lock:
                    failed = [s.future for s in self._state if s.active and s.future]
                    self._state = [_Slot() for _ in range(self.slots)]
                    for fut in failed:
                        fut.set_exception(e)
                continue
            with self._lock:
                self._ticks += 1
                self._rounds += R if multi else 1
                for i in self._commit_tick(active, multi, emit, acc, *inputs[4:]):
                    s = self._state[i]
                    s.future.set_result(list(s.prompt) + s.generated)
                    self._state[i] = _Slot()
        _drain(self)


class BucketedDecodeServer:
    """A ladder of KV-cache lengths over DecodeServer: several slot groups
    ("buckets"), each with its own cache length, all sharing ONE uploaded
    weight set (`_merge_params` by name and content), so that the caches
    cost sum(slots_i x len_i) instead of slots x max(len).

    `buckets`: dicts {"step": step graph, "slots": n, "prefills": [prefill
    graphs at this bucket's max_len], "tick_steps": T}; a bucket with
    "chunk" and "draft" graphs (and optionally "draft_prefills",
    "rounds_per_tick") is a SpecDecodeServer. Build every bucket's graphs
    from one weight dict, quantized alike, or the weights are held twice
    (a warning says so).

    A request goes to the smallest bucket whose cache holds len(prompt) +
    n_new; when that bucket has no free slot and a larger fitting one has
    one and no queue, it spills up. A request longer than every bucket goes
    to the largest, which clamps n_new or rejects the prompt.
    """

    def __init__(self, buckets, config=None, stop_tokens=()):
        if not buckets:
            raise ValueError("need at least one bucket")
        for i, b in enumerate(buckets):
            if ("chunk" in b) != ("draft" in b):
                raise ValueError("speculative bucket needs BOTH 'chunk' and 'draft' graphs "
                                 f"(bucket {i} has only one)")
        self._servers = []
        built: dict[int, object] = {}
        shared = None
        try:
            # largest first: its server uploads the weights, the rest share them
            for i in sorted(range(len(buckets)),
                            key=lambda i: -self._graph_max_len(buckets[i]["step"])):
                b = buckets[i]
                if "chunk" in b:
                    srv = SpecDecodeServer(
                        b["step"], b["chunk"], b["draft"], slots=b.get("slots", 4),
                        config=config, stop_tokens=stop_tokens,
                        prefill_graphs=b.get("prefills", ()),
                        draft_prefill_graphs=b.get("draft_prefills", ()),
                        shared_weights=shared, rounds_per_tick=b.get("rounds_per_tick", 1))
                else:
                    srv = DecodeServer(b["step"], slots=b.get("slots", 4), config=config,
                                       stop_tokens=stop_tokens,
                                       prefill_graphs=b.get("prefills", ()),
                                       shared_weights=shared,
                                       tick_steps=b.get("tick_steps", 1))
                built[i] = srv
                if shared is None:
                    shared = srv.shared_weights()
        except BaseException:
            for srv in built.values():
                srv.shutdown()
            raise
        self._servers = sorted(built.values(), key=lambda s: s.max_len)

    @staticmethod
    def _graph_max_len(g) -> int:
        for v in g.inputs:
            if v.name.startswith(("k_cache_", "v_cache_")):
                return int(v.type.shape[0])
        raise ValueError("step graph has no KV cache inputs")

    @property
    def max_len(self) -> int:
        return self._servers[-1].max_len

    def submit(self, prompt, n_new, context=None) -> Future:
        need = len(prompt) + max(int(n_new), 0)
        # need == max_len fits: plen + n_new tokens fill rows 0 .. max_len - 1
        fits = [s for s in self._servers if need <= s.max_len] or [self._servers[-1]]
        target = fits[0]
        if target.stats()["active"] >= target.slots:
            for s in fits[1:]:
                st = s.stats()
                if st["active"] < s.slots and st["queued"] == 0:
                    target = s  # spill up: a longer-cache slot is idle
                    break
        return target.submit(prompt, n_new, context)

    def stats(self) -> dict:
        per = [s.stats() for s in self._servers]
        return {"buckets": [{"max_len": s.max_len, **st} for s, st in zip(self._servers, per)],
                "slots": sum(p["slots"] for p in per),
                "active": sum(p["active"] for p in per),
                "queued": sum(p["queued"] for p in per)}

    def cache_bytes(self) -> int:
        return sum(s.cache_bytes() for s in self._servers)

    def uniform_cache_bytes(self) -> int:
        """What the same slot count would cost at the largest bucket's
        length (the flat DecodeServer this ladder replaces); of a
        speculative largest bucket only its target caches count."""
        big = self._servers[-1]
        caches = getattr(big, "_t_caches", None) or big._caches
        per_slot = sum(c.numel() * c.element_size() for c in caches) // big.slots
        return per_slot * sum(s.slots for s in self._servers)

    def shutdown(self) -> None:
        for s in self._servers:
            s.shutdown()
