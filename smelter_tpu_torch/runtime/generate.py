"""Autoregressive decoding over a static-cache step graph.

The port's counterpart of `smelter_tpu/runtime/generate.py`. A step graph
(token (1,), pos (1,), caches) -> (logits, updated caches), as
`models/llama_style.py::build_decode_step` builds it, runs with its KV
caches resident on the device and DONATED to it: its ScatterND writes update
them in place (`Executor.build_fn(donate=...)`), so no cache is copied per
step and no output needs to be fed back.

- `Generator`: the host loop, one step a token, the next token picked on
  the host.
- `FusedGenerator`: the JAX package runs its whole greedy loop as one
  `lax.scan` in one `jit`. Here the step, the pick of the next token
  (greedy, or temperature / top-k sampling with noise drawn beforehand from
  an explicit `torch.Generator`) and the advance of token and position are
  captured once as a CUDA graph over static device buffers; each token is
  one replay, the token feeds back on the device, and the host syncs once
  at the end. On the CPU the same body runs eagerly, step by step.
- A ladder of prefill graphs (`build_prefill`, one per prompt length): a
  prompt of exactly that length is filled into the caches by one forward,
  run eagerly, instead of plen - 1 steps.

`_merge_params` shares device tensors between a step graph and its
companions (prefill graphs) by name and content, so one copy of the
weights serves both. `_decode_graph` applies `Config.ragged_attention`.
Left out (ROADMAP): `BatchedGenerator`, `FusedBatchedGenerator`, the AOT
save/load of decode executables, and context inputs (cross-attention
decoders).
"""

from __future__ import annotations

import copy
import warnings

import numpy as np
import torch

from ..ir.errors import NotSupportedError
from ..utils import dtypes as dt
from .config import Config
from .executor import _COMPUTE_DTYPES, Executor

_CACHE_PREFIX = ("k_cache_", "v_cache_")


def _cache_dtypes(step_graph, config, cache_names) -> list[torch.dtype]:
    """Dtypes to seed the KV caches with: the executor runs floating inputs
    in its compute dtype, and the caches are carried from step to step (in
    place, in the port), so a floating cache is made in the compute dtype
    and an integer one in its declared type."""
    cd = _COMPUTE_DTYPES[config.compute_dtype]
    by = {}
    for v in step_graph.inputs:
        tdt = dt.onnx_to_torch_dtype(v.type.dtype)
        by[v.name] = cd if tdt.is_floating_point else tdt
    return [by[n] for n in cache_names]


def _arr_eq(a, b) -> bool:
    return a is b or (a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b))


def _shallow_clone(graph):
    """Structure-only clone: fresh node objects, input/output lists and
    initializer dict, arrays shared by reference, so that a rewrite of the
    clone leaves the caller's graph as it was."""
    g2 = copy.copy(graph)
    g2.nodes = [copy.copy(n) for n in graph.nodes]
    for n in g2.nodes:
        n.inputs = list(n.inputs)
        n.outputs = list(n.outputs)
    g2.initializers = dict(graph.initializers)
    g2.inputs = list(graph.inputs)
    g2.outputs = list(graph.outputs)
    g2.value_types = dict(graph.value_types)
    return g2


def _merge_params(params: dict, host_map: dict, graph, cfg) -> Executor:
    """Add a companion graph's params to `params`, sharing the device tensor
    wherever name AND content match one already there (the builders name
    weights by their weight-dict key and quantization is deterministic, so
    a prefill graph shares every weight with its step graph). A name whose
    content differs is renamed in a structure-only clone of `graph`, to an
    earlier companion's renamed twin of the same content where there is one
    (a draft model's prefill graphs then share the draft step's weights); a
    newly renamed array above 1 MB is warned about, since its weights are
    then held twice unless it is another model's. Returns the companion's
    Executor (on the clone)."""
    graph = _shallow_clone(graph)
    renames = {}
    for name, want in list(graph.initializers.items()):
        have = host_map.get(name)
        if have is not None and not _arr_eq(have, want):
            new = name + "__p"
            while (new in host_map and not _arr_eq(host_map[new], want)) \
                    or new in graph.initializers:
                new += "_"
            renames[name] = new
            if new not in host_map and want.nbytes > (1 << 20):
                warnings.warn(
                    f"companion graph initializer {name!r} ({want.nbytes >> 20} MB) differs "
                    f"from the step graph's: weights are being duplicated on the device; "
                    f"build both graphs from one weight dict and quantize them identically",
                    stacklevel=3)
    for old, new in renames.items():
        graph.initializers[new] = graph.initializers.pop(old)
    if renames:
        for node in graph.nodes:
            node.inputs = [renames.get(i, i) for i in node.inputs]
    ex = Executor(graph, cfg)
    fresh = [n for n in ex.param_names if n not in params]
    if fresh:
        from ..weights import params_from_numpy

        arrays = {n: graph.initializers[n] for n in fresh}
        params.update(ex.cast_params(params_from_numpy(arrays, ex.device, graph=graph)))
        host_map.update(arrays)
    return ex


def _decode_graph(graph, cfg):
    """Apply the config's decode-graph rewrites on a structure-only clone.
    `Config.ragged_attention` fuses the masked cache attention into
    RaggedDecodeAttention (passes/ragged_attention.py), whose kernel reads
    only the live cache rows; a graph left with no such attention raises
    rather than running the dense chain."""
    if cfg is None or not cfg.ragged_attention:
        return graph
    from ..passes.ragged_attention import fuse_ragged_attention

    g2 = _shallow_clone(graph)
    fuse_ragged_attention(g2)
    if not any(n.op_type == "RaggedDecodeAttention" for n in g2.nodes):
        raise NotSupportedError(
            "Config.ragged_attention: no static-cache attention chain to fuse in "
            f"graph {graph.name!r}")
    g2.dead_code_eliminate()
    return g2


def _step_io(graph):
    """(input names, cache names) of a step graph; it takes no other input
    than token, pos and its caches."""
    names = [v.name for v in graph.inputs]
    caches = [n for n in names if n.startswith(_CACHE_PREFIX)]
    other = [n for n in names if n not in ("token", "pos") and n not in caches]
    if other:
        raise NotSupportedError(f"decode step inputs {other}: context inputs are not taken")
    return names, caches


class Generator:
    """The host loop: one step a token. generate() returns prompt + new."""

    def __init__(self, step_graph, config=None):
        cfg = config or Config()
        step_graph = _decode_graph(step_graph, cfg)
        ex = Executor(step_graph, cfg)
        self.device = ex.device
        self.input_names, self.cache_names = _step_io(step_graph)
        self._params = ex.cast_params(ex.init_params())
        self._fn = ex.build_fn(donate=self.cache_names)
        shapes = {v.name: tuple(v.type.shape) for v in step_graph.inputs}
        self.cache_shapes = [shapes[n] for n in self.cache_names]
        self.cache_dtypes = _cache_dtypes(step_graph, cfg, self.cache_names)
        self.max_len = self.cache_shapes[0][0]

    def generate(self, prompt: list[int], n_new: int, sample=None) -> list[int]:
        """Greedy (or `sample(logits) -> token`, logits as f32 numpy)
        decoding."""
        dev = self.device
        by = {n: torch.zeros(s, dtype=d, device=dev)
              for n, s, d in zip(self.cache_names, self.cache_shapes, self.cache_dtypes)}
        tokens = list(prompt)
        logits = None
        for pos in range(min(len(tokens) + n_new - 1, self.max_len)):
            if pos < len(tokens):
                tok = tokens[pos]
            else:
                tok = (int(logits.argmax()) if sample is None
                       else int(sample(logits.float().cpu().numpy())))
                tokens.append(tok)
            by["token"] = torch.tensor([tok], dtype=torch.int64, device=dev)
            by["pos"] = torch.tensor([pos], dtype=torch.int64, device=dev)
            logits = self._fn(self._params, *[by[n] for n in self.input_names])[0][0]
        if len(tokens) < len(prompt) + n_new and logits is not None:
            tokens.append(int(logits.argmax()))
        return tokens


class FusedGenerator:
    """The decode loop with no host round trip a token: on the card, the
    step and the pick of the next token are one CUDA graph, replayed once a
    token. `prefill_graph` (one graph or a list, e.g. `build_prefill` at
    several prompt lengths) fills the caches of a prompt of exactly its
    length with one forward. Weights are shared with the step graph by name
    and content (`_merge_params`)."""

    def __init__(self, step_graph, config=None, prefill_graph=None):
        cfg = config or Config()
        step_graph = _decode_graph(step_graph, cfg)
        ex = self._ex = Executor(step_graph, cfg)
        self.device = ex.device
        self.input_names, self.cache_names = _step_io(step_graph)
        self._params = ex.cast_params(ex.init_params())
        self._host_map = {n: step_graph.initializers[n] for n in ex.param_names}
        self._step = ex.build_fn(donate=self.cache_names)
        self._prefills: dict[int, tuple] = {}
        graphs = (prefill_graph if isinstance(prefill_graph, (list, tuple))
                  else [] if prefill_graph is None else [prefill_graph])
        for g in graphs:
            if [v.name for v in g.inputs] != ["tokens"]:
                raise NotSupportedError("a prefill graph takes one input, tokens")
            pex = _merge_params(self._params, self._host_map, g, cfg)
            self._prefills[g.inputs[0].type.shape[0]] = pex.build_fn()
        shapes = {v.name: tuple(v.type.shape) for v in step_graph.inputs}
        self.cache_shapes = [shapes[n] for n in self.cache_names]
        self.cache_dtypes = _cache_dtypes(step_graph, cfg, self.cache_names)
        self.max_len = self.cache_shapes[0][0]
        dev, i64 = self.device, torch.int64
        # the state every step reads and advances, at fixed addresses
        self._caches = [torch.zeros(s, dtype=d, device=dev)
                        for s, d in zip(self.cache_shapes, self.cache_dtypes)]
        self._token = torch.zeros(1, dtype=i64, device=dev)
        self._pos = torch.zeros(1, dtype=i64, device=dev)
        self._plen = torch.ones(1, dtype=i64, device=dev)
        self._prompt = torch.zeros(self.max_len, dtype=i64, device=dev)
        self._out = torch.zeros(self.max_len, dtype=i64, device=dev)  # token for pos + 1
        self._temp = torch.ones(1, dtype=torch.float32, device=dev)
        self._noise = None  # (max_len, vocab) uniforms for sampling, made on first use
        # (do_sample, top_k) -> the CUDA graph of a step, and its launches
        self._graphs: dict[tuple[bool, int], torch.cuda.CUDAGraph] = {}
        self.step_launches: dict[str, dict[str, int]] = {}
        self.replays = 0

    # -- the body of a step ------------------------------------------------

    def _pick(self, logits, row, do_sample: bool, top_k: int):
        """Next token from (vocab,) logits: argmax, or the Gumbel-max draw
        of temperature / top-k sampling from the noise row `row` (a (1,)
        device index)."""
        if not do_sample:
            return logits.argmax().reshape(1)
        lg = logits.float() / self._temp
        if top_k:
            kth = torch.topk(lg, top_k).values[-1]
            lg = torch.where(lg < kth, float("-inf"), lg)
        u = self._noise.index_select(0, row)[0].clamp_min(1e-20)
        return (lg - torch.log(-torch.log(u))).argmax().reshape(1)

    def _body(self, do_sample: bool, top_k: int) -> None:
        """One step at self._pos: run the graph, pick the token for pos + 1
        (the prompt's while inside it), record it, advance token and pos."""
        by = {"token": self._token, "pos": self._pos}
        by.update(zip(self.cache_names, self._caches))
        logits = self._step(self._params, *[by[n] for n in self.input_names])[0][0]
        nxt = self._pick(logits, self._pos, do_sample, top_k)
        given = self._prompt.index_select(0, torch.minimum(self._pos + 1, self._plen - 1))
        nxt = torch.where(self._pos + 1 < self._plen, given, nxt)
        self._out.index_copy_(0, self._pos, nxt)
        self._token.copy_(nxt)
        self._pos.add_(1)

    def _graph(self, do_sample: bool, top_k: int):
        """The CUDA graph of one body, captured at first use (after a warm-up
        step on a side stream) and kept. The kernels' launch counts move at
        capture, not at replay: `step_launches` keeps a replay's, under
        "greedy" or "sample top_k <k>"."""
        key = (do_sample, top_k)
        if key not in self._graphs:
            from ..kernels import int4_matmul, ragged_decode_attention

            mods = {"int4_matmul": int4_matmul,
                    "ragged_decode_attention": ragged_decode_attention}
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._body(do_sample, top_k)  # warm-up; the state is reset after
            torch.cuda.current_stream(self.device).wait_stream(side)
            before = {k: m.launches for k, m in mods.items()}
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._body(do_sample, top_k)
            name = f"sample top_k {top_k}" if do_sample else "greedy"
            self.step_launches[name] = {k: m.launches - before[k] for k, m in mods.items()}
            self._graphs[key] = graph
        return self._graphs[key]

    # -- public API ----------------------------------------------------------

    def generate(self, prompt: list[int], n_new: int, temperature: float | None = None,
                 top_k: int = 0, seed: int = 0) -> list[int]:
        """Greedy decode, or sampled when temperature or top_k is given
        (noise from a torch.Generator seeded with `seed`: a seed is
        reproducible). Returns prompt + generated tokens."""
        plen = len(prompt)
        n_new = min(n_new, self.max_len - plen)
        if n_new < 1:
            return list(prompt)
        do_sample = temperature is not None or bool(top_k)
        top_k = int(top_k)
        on_card = self.device.type == "cuda"
        if do_sample:
            self._draw_noise(seed)
        graph = self._graph(do_sample, top_k) if on_card else None
        self._temp.fill_(1.0 if temperature is None else float(temperature))
        self._prompt[:plen].copy_(torch.tensor(prompt, dtype=torch.int64))
        self._plen.fill_(plen)
        prefill = self._prefills.get(plen)
        if prefill is not None:
            outs = prefill(self._params, self._prompt[:plen])
            for c, new in zip(self._caches, outs[1:]):
                c.copy_(new)
            start = torch.full((1,), plen - 1, dtype=torch.int64, device=self.device)
            first = self._pick(outs[0][plen - 1], start, do_sample, top_k)
            self._out.index_copy_(0, start, first)
            self._token.copy_(first)
            self._pos.fill_(plen)
            steps = n_new - 1
        else:
            for c in self._caches:
                c.zero_()
            self._token.copy_(self._prompt[:1])
            self._pos.zero_()
            steps = plen - 1 + n_new
        for _ in range(steps):
            if graph is not None:
                graph.replay()
            else:
                self._body(do_sample, top_k)
        self.replays += steps if graph is not None else 0
        return list(prompt) + self._out[plen - 1:plen - 1 + n_new].tolist()

    def _draw_noise(self, seed: int) -> None:
        """Uniforms for every position's draw, from a torch.Generator seeded
        with `seed`, drawn on the device before the loop."""
        if self._noise is None:
            ex = self._ex
            meta = ex.build_fn(device="meta")(ex.cast_params(ex.param_shapes()),
                                              *ex.input_shapes())[0]
            self._noise = torch.empty((self.max_len, meta.shape[-1]), dtype=torch.float32,
                                      device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self._noise.uniform_(generator=gen)
