"""Speculative decoding: a draft model proposes, the target verifies.

The port's counterpart of `smelter_tpu/runtime/speculative.py`. A small
DRAFT model proposes gamma tokens with cheap single-token steps; the TARGET
model verifies all gamma + 1 positions in one chunked causal forward
(`models/llama_style.py::build_decode_step(chunk=gamma + 1)`), which reads
each weight once for the whole chunk. Greedy acceptance keeps the longest
prefix of draft tokens that matches the target's argmax chain, plus the
target's own token at the first mismatch (or the bonus token when all
match), so the output is token for token that of plain greedy decoding of
the target, whatever the draft; only the number of rounds varies.

The JAX package runs its rounds in one `lax.while_loop`. Here a round stays
on the device: the draft steps, the verify, the acceptance (an argmax
compare and a cumulative product) and the next round's tokens are tensor
ops, and the host reads one number a round, the count of accepted drafts,
to advance its position. Sampled mode (temperature / top-k) uses rejection
sampling: accept draft i with probability min(1, p_i / q_i), resample the
first rejection from norm(max(p - q, 0)), draw the bonus token from p when
all are accepted; its draws come from a `torch.Generator` seeded by `seed`,
so its tokens are reproducible but differ from the JAX run's, as
`FusedGenerator`'s sampled tokens do.

Cache staleness needs no rewind: a step at position p writes cache row p
before any read of it, and row i of a chunk attends only positions <= pos
+ i, so rows written by rejected drafts are overwritten by the chunk or
step that later reaches them, before anything attends them.

The target step and chunk share device weights by name and content
(`generate._merge_params`); the draft has its own.
"""

from __future__ import annotations

import torch

from ..ir.errors import NotSupportedError
from .config import Config
from .executor import Executor
from .generate import _cache_dtypes, _decode_graph, _merge_params, _step_io


class SpeculativeGenerator:
    """Speculative decoding over (target step, target chunk step, draft step)
    graphs. `target_step` and `target_chunk` must be built from one weight
    dict (they share device weights); `draft_step` is a separate, smaller
    model. `prefill_graph` (one graph or a list, `build_prefill` of the
    target) fills the target's caches of a prompt of exactly its length with
    one forward; the draft then ingests the prompt a token a step."""

    def __init__(self, target_step, target_chunk, draft_step, config=None,
                 draft_config=None, prefill_graph=None):
        cfg = config or Config()
        dcfg = draft_config or cfg
        target_step = _decode_graph(target_step, cfg)
        target_chunk = _decode_graph(target_chunk, cfg)
        draft_step = _decode_graph(draft_step, dcfg)
        ex_t = Executor(target_step, cfg)
        self.device = ex_t.device
        self._in_t, self._cn_t = _step_io(target_step)
        self._params_t = ex_t.cast_params(ex_t.init_params())
        self._step_t = ex_t.build_fn(donate=self._cn_t)
        host_map = {n: target_step.initializers[n] for n in ex_t.param_names}
        ex_c = _merge_params(self._params_t, host_map, target_chunk, cfg)
        self._in_c, cn_c = _step_io(ex_c.graph)
        if cn_c != self._cn_t:
            raise NotSupportedError("target_chunk's caches differ from target_step's")
        self._chunk_t = ex_c.build_fn(donate=cn_c)
        ex_d = Executor(draft_step, dcfg)
        self._in_d, self._cn_d = _step_io(draft_step)
        self._params_d = ex_d.cast_params(ex_d.init_params())
        self._step_d = ex_d.build_fn(donate=self._cn_d)

        shapes_t = {v.name: tuple(v.type.shape) for v in target_step.inputs}
        shapes_d = {v.name: tuple(v.type.shape) for v in draft_step.inputs}
        self._cshapes_t = [shapes_t[n] for n in self._cn_t]
        self._cshapes_d = [shapes_d[n] for n in self._cn_d]
        self._cdts_t = _cache_dtypes(target_step, cfg, self._cn_t)
        self._cdts_d = _cache_dtypes(draft_step, dcfg, self._cn_d)
        self.max_len = min(self._cshapes_t[0][0], self._cshapes_d[0][0])
        self.gamma = next(v.type.shape[0] for v in target_chunk.inputs if v.name == "token") - 1
        if self.gamma < 1:
            raise ValueError("target_chunk must take >= 2 tokens")

        self._prefills: dict[int, object] = {}
        graphs = (prefill_graph if isinstance(prefill_graph, (list, tuple))
                  else [] if prefill_graph is None else [prefill_graph])
        for g in graphs:
            if [v.name for v in g.inputs] != ["tokens"]:
                raise NotSupportedError("a prefill graph takes one input, tokens")
            pex = _merge_params(self._params_t, host_map, g, cfg)
            self._prefills[g.inputs[0].type.shape[0]] = pex.build_fn()
        # positions as (1,) views of one device tensor: no copy a step
        self._ar = torch.arange(self.max_len + self.gamma + 1, dtype=torch.int64,
                                device=self.device)
        # measured per call (host-visible diagnostics)
        self.last_rounds = None
        self.last_accept_rate = None

    # -- one graph run -------------------------------------------------------

    def _run(self, fn, params, names, cnames, caches, tok, pos: int):
        """Logits of `fn` at tokens `tok` from position `pos`; the caches are
        updated in place."""
        by = {"token": tok, "pos": self._ar[pos:pos + 1]}
        by.update(zip(cnames, caches))
        return fn(params, *[by[n] for n in names])[0]

    def _target(self, caches, tok, pos):
        return self._run(self._step_t, self._params_t, self._in_t, self._cn_t, caches, tok, pos)

    def _draft(self, caches, tok, pos):
        return self._run(self._step_d, self._params_d, self._in_d, self._cn_d, caches, tok, pos)

    # -- sampling ----------------------------------------------------------------

    @staticmethod
    def _dist(logits, temperature: float, top_k: int):
        """The sampling distribution (temperature, then top-k), applied alike
        to draft (q) and target (p) rows, as rejection sampling requires."""
        lg = logits.float() / temperature
        if top_k:
            kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
            lg = torch.where(lg < kth, float("-inf"), lg)
        return torch.softmax(lg, dim=-1)

    @staticmethod
    def _sample(probs, gen):
        """One draw from each row of `probs` by the Gumbel-max trick, with
        uniforms from `gen`: a (1,) or (rows,) int64 tensor."""
        u = torch.rand(probs.shape, generator=gen, device=probs.device).clamp_min(1e-20)
        return (torch.log(probs + 1e-30) - torch.log(-torch.log(u))).argmax(-1).reshape(-1)

    # -- public API ----------------------------------------------------------

    def generate(self, prompt: list[int], n_new: int, temperature: float | None = None,
                 top_k: int = 0, seed: int = 0) -> list[int]:
        """Greedy decoding, token for token `FusedGenerator`'s on the target;
        sampled when temperature or top_k is given (its output distribution
        is that of plain sampling from the target). Rounds and acceptance are
        recorded in last_rounds and last_accept_rate. Returns prompt + new."""
        plen = len(prompt)
        n_new = min(n_new, self.max_len - plen)
        if n_new < 1:
            return list(prompt)
        gamma, dev = self.gamma, self.device
        do_sample = temperature is not None or bool(top_k)
        temp = 1.0 if temperature is None else float(temperature)
        top_k = int(top_k)
        gen = torch.Generator(device=dev).manual_seed(int(seed)) if do_sample else None

        def pick(logits):
            """(1,) next token from (vocab,) logits."""
            if do_sample:
                return self._sample(self._dist(logits, temp, top_k), gen)
            return logits.argmax().reshape(1)

        t_caches = [torch.zeros(s, dtype=d, device=dev)
                    for s, d in zip(self._cshapes_t, self._cdts_t)]
        d_caches = [torch.zeros(s, dtype=d, device=dev)
                    for s, d in zip(self._cshapes_d, self._cdts_d)]
        prompt_d = torch.tensor(prompt, dtype=torch.int64, device=dev)
        buf = torch.zeros(n_new + gamma + 1, dtype=torch.int64, device=dev)

        # -- the prompt --------------------------------------------------------
        prefill = self._prefills.get(plen)
        if prefill is not None:
            outs = prefill(self._params_t, prompt_d)
            for c, new in zip(t_caches, outs[1:]):
                c.copy_(new)
            last = pick(outs[0][plen - 1])
            buf[:1].copy_(last)
            pos, n_done, d_len = plen, 1, plen
            prev = prompt_d[plen - 1:plen]
        else:
            for p in range(plen - 1):
                self._target(t_caches, prompt_d[p:p + 1], p)
            last = prompt_d[plen - 1:plen]
            pos, n_done, d_len = plen - 1, 0, plen - 1
            prev = prompt_d[max(plen - 2, 0):max(plen - 2, 0) + 1]
        done0 = n_done
        for p in range(d_len):
            self._draft(d_caches, prompt_d[p:p + 1], p)

        # -- rounds: gamma drafts, one verify ----------------------------------
        rounds = 0
        while n_done < n_new and pos <= self.max_len - 1 - gamma:
            # a catch-up step (j = -1) first: after a fully accepted round the
            # draft never ingested the last draft token, so the token at
            # pos - 1 is fed again (the same row and value where it was)
            tk, drafts, q_rows = prev, [], []
            for j in range(-1, gamma):
                logits = self._draft(d_caches, tk, max(pos + j, 0))
                if j < 0:
                    tk = last
                    continue
                if do_sample:
                    q = self._dist(logits[-1], temp, top_k)
                    q_rows.append(q)
                    tk = self._sample(q, gen)
                else:
                    tk = logits[-1].argmax().reshape(1)
                drafts.append(tk)
            drafts = torch.cat(drafts)  # d_1 .. d_gamma
            logits = self._run(self._chunk_t, self._params_t, self._in_c, self._cn_t,
                               t_caches, torch.cat([last, drafts]), pos)
            if do_sample:
                p_rows = self._dist(logits, temp, top_k)  # (gamma + 1, vocab)
                q_rows = torch.stack(q_rows)
                p_d = p_rows[:gamma].gather(1, drafts[:, None])[:, 0]
                q_d = q_rows.gather(1, drafts[:, None])[:, 0]
                u = torch.rand(gamma, generator=gen, device=dev)
                a = torch.cumprod((u * q_d <= p_d).long(), 0).sum()
                p_a = p_rows.index_select(0, a.reshape(1))[0]
                q_a = torch.where(a < gamma, q_rows.index_select(
                    0, a.clamp(max=gamma - 1).reshape(1))[0], torch.zeros_like(p_a))
                resid = (p_a - q_a).clamp_min(0.0)
                base = torch.where(resid.sum() > 1e-9, resid, p_a)
                emit = torch.cat([drafts, drafts[-1:]])
                emit = torch.where(torch.arange(gamma + 1, device=dev) == a,
                                   self._sample(base, gen), emit)
            else:
                emit = logits.argmax(-1)
                a = torch.cumprod((drafts == emit[:gamma]).long(), 0).sum()
            # emit[0 .. a] are the round's tokens; the rest are overwritten by
            # the next round's write
            buf[n_done:n_done + gamma + 1].copy_(emit)
            ai = a.reshape(1)
            prev = torch.where(ai > 0, drafts.index_select(0, (ai - 1).clamp_min(0)), last)
            last = emit.index_select(0, ai)
            n = int(a) + 1  # the host's one read a round
            pos += n
            n_done += n
            rounds += 1
        emitted = n_done - done0

        # -- near the cache's end the chunk's gamma + 1 rows would not fit:
        # the last tokens are plain steps of the target
        while n_done < n_new:
            last = pick(self._target(t_caches, last, pos)[0])
            buf[n_done:n_done + 1].copy_(last)
            pos += 1
            n_done += 1
        self.last_rounds = rounds
        self.last_accept_rate = (emitted / rounds - 1.0) / gamma if rounds else None
        return list(prompt) + buf[:n_new].tolist()
