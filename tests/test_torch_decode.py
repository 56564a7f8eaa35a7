"""The port's static-cache decode path against the JAX package, on the CPU.

A narrow LLaMA-style model at which the JAX package's ragged kernel runs in
interpret mode within its Mosaic gate: vocab 96, dim 256, 2 heads, 1 KV head
(hd 128), ffn 512, 2 layers, max_len 64. Its random weights are scaled up
threefold (the same dict goes to both packages) so that greedy decoding
does not settle into a two-token loop. Inputs come from numpy seeds; the
JAX side runs its Pallas kernel in interpret mode (`_FORCE_RAGGED_KERNEL`,
as tests/test_ragged_attention.py does) or its plain reference. Tokens must
be identical in f32.
"""

import contextlib
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smelter_tpu as st
import smelter_tpu.ops.fused_ops as jfused
import smelter_tpu_torch as stt
from smelter_tpu.ir.build import GraphBuilder as JGraphBuilder
from smelter_tpu.kernels import ragged_decode_attention as jrda
from smelter_tpu.models import llama_style as jls
from smelter_tpu.passes.pass_manager import run_passes as jrun_passes
from smelter_tpu.runtime.executor import Executor as JExecutor
from smelter_tpu.runtime.generate import FusedGenerator as JFusedGenerator
from smelter_tpu.serving.decode_server import DecodeServer as JDecodeServer
from smelter_tpu.serving.paged_server import PagedDecodeServer as JPagedDecodeServer
from smelter_tpu_torch.ir.build import GraphBuilder
from smelter_tpu_torch.ir.errors import NotSupportedError
from smelter_tpu_torch.kernels import int4_matmul as i4
from smelter_tpu_torch.kernels import ragged_decode_attention as rda
from smelter_tpu_torch.models import llama_style as ls
from smelter_tpu_torch.passes.pass_manager import run_passes
from smelter_tpu_torch.runtime.executor import Executor
from smelter_tpu_torch.runtime.generate import (FusedGenerator, Generator, _decode_graph,
                                                _merge_params)
from smelter_tpu_torch.serving.decode_server import DecodeServer
from smelter_tpu_torch.serving.paged_server import PagedDecodeServer
from smelter_tpu_torch.utils import dtypes as dt
from torch_port_common import assert_graphs_equal

REPO = Path(__file__).resolve().parents[1]
CFG = dict(vocab=96, dim=256, heads=2, kv_heads=1, ffn=512, layers=2)
L = 64
CPU = stt.Config(device="cpu")
_SHARPEN = ("wte", "wq", "wk", "wv", "wo", "wgate", "wup", "wdown")


def _weights(seed: int = 0):
    w = ls.make_weights(**CFG, max_len=L, seed=seed)
    return {k: (v * np.float32(3) if k.startswith(_SHARPEN) else v) for k, v in w.items()}


def _graphs(build, w, kv_quant, buckets=(8, 16), max_len=L, chunk=1):
    step = build.build_decode_step(w, **CFG, max_len=max_len, kv_quant=kv_quant,
                                   chunk=chunk)[0]
    pfs = [build.build_prefill(w, prompt_len=p, max_len=max_len, kv_quant=kv_quant, **CFG)
           for p in buckets]
    return step, pfs


@contextlib.contextmanager
def _jax_ragged_kernel(on: bool):
    """The JAX package's ragged kernel in interpret mode off the TPU."""
    jfused._FORCE_RAGGED_KERNEL = on
    try:
        yield
    finally:
        jfused._FORCE_RAGGED_KERNEL = False


# -- op lowerings --------------------------------------------------------------

def _one_op(op_type, inputs: dict, attrs: dict, inits: dict = (), n_out=1,
            opset: int = 17):
    """One node through both executors in f32: graph inputs `inputs`,
    initializers `inits`, `n_out` outputs (a count, or names with "" for
    the ones left out). Returns (port outputs, JAX outputs) as numpy."""
    inits = dict(inits)
    res = []
    for GB, Ex, conv in ((GraphBuilder, Executor, torch.from_numpy),
                         (JGraphBuilder, JExecutor, jnp.asarray)):
        b = GB("op", opset=opset)
        for n, a in inputs.items():
            b.input(n, a.shape, dt.numpy_to_onnx_dtype(a.dtype))
        for n, a in inits.items():
            b.init(a, n)
        names = list(attrs.pop("_order", [])) or list(inputs) + list(inits)
        outs = b.node(op_type, names, outputs=n_out, **attrs)
        g = b.finish([o for o in outs if o] if isinstance(outs, list) else [outs])
        ex = Ex(g, CPU) if Ex is Executor else Ex(g)
        got = ex.build_fn()(ex.init_params() if Ex is JExecutor
                            else ex.cast_params(ex.init_params()),
                            *[conv(a.copy()) for a in inputs.values()])
        res.append([np.asarray(o) for o in got])
        attrs = dict(attrs, _order=names)
    return res


def _close(got, want, rel=1e-5):
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.abs(a.astype(np.float64) - b).max() <= rel * max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("case", ["rows", "chunk", "out_of_range", "negative", "collision",
                                  "negative_out_of_range", "negative_collision"])
def test_scatter_nd_matches_jax(case):
    """Out-of-range rows are dropped without touching the in-range row that
    shares their index modulo the dim (collision: 5 on a dim of 4 meets 1;
    negative_collision: -5, dropped, meets 3, written before it)."""
    rng = np.random.default_rng(1)
    dim, idx = {"rows": (12, [[3]]), "chunk": (12, [[7], [8], [9]]),
                "out_of_range": (12, [[10], [11], [12], [13]]), "negative": (12, [[-2], [0]]),
                "collision": (4, [[1], [5]]), "negative_out_of_range": (4, [[-5], [1]]),
                "negative_collision": (4, [[3], [-5]])}[case]
    x = rng.standard_normal((dim, 5)).astype(np.float32)
    idx = np.array(idx, np.int64)
    upd = rng.standard_normal((idx.shape[0], 5)).astype(np.float32)
    got, want = _one_op("ScatterND", {"x": x, "idx": idx, "upd": upd}, {})
    assert np.array_equal(got[0], want[0])


def test_scatter_nd_updates_a_donated_input_in_place():
    b = GraphBuilder("s", opset=17)
    b.input("cache", (6, 4))
    b.input("idx", (1, 1), dt.INT64)
    b.input("row", (1, 4))
    g = b.finish([b.node("ScatterND", ["cache", "idx", "row"])])
    ex = Executor(g, CPU)
    cache = torch.zeros(6, 4)
    args = (cache, torch.tensor([[2]]), torch.ones(1, 4))
    out = ex.build_fn(donate=("cache",))({}, *args)[0]
    assert out is cache and cache[2].eq(1).all() and cache.sum() == 4
    fresh = torch.zeros(6, 4)
    out = ex.build_fn()({}, fresh, *args[1:])[0]
    assert out is not fresh and fresh.sum() == 0 and out.sum() == 4
    with pytest.raises(TypeError, match="donated"):  # a copy on the way in
        ex.build_fn(donate=("cache",))({}, cache.double(), *args[1:])


def test_dense_mask_ops_match_jax():
    rng = np.random.default_rng(2)
    ar = np.arange(L, dtype=np.int64)
    for pos in (np.array([0], np.int64), np.array([[5], [6], [63]], np.int64)):
        le = _one_op("LessOrEqual", {"pos": pos}, {"_order": ["ar", "pos"]}, {"ar": ar})
        assert np.array_equal(*[r[0] for r in le])
    cond = rng.random((3, L)) < 0.5
    got, want = _one_op("Where", {"c": cond}, {"_order": ["c", "z", "n"]},
                        {"z": np.float32(0.0), "n": np.float32(-1e9)})
    assert np.array_equal(got[0], want[0])
    s = (rng.standard_normal((2, 3, 4, L)) * 4).astype(np.float32)
    _close(*_one_op("Softmax", {"s": s}, {"axis": -1}))
    _close(*_one_op("Softmax", {"s": s}, {"axis": 2}, opset=11))


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_pad_matches_jax(dtype):
    x = (np.random.default_rng(3).standard_normal((5, 7)) * 50).astype(dtype)
    pads = np.array([0, 1, 4, 2], np.int64)
    got, want = _one_op("Pad", {"x": x}, {}, {"pads": pads})
    assert np.array_equal(got[0], want[0])


def test_skip_simplified_layer_norm_matches_jax():
    rng = np.random.default_rng(4)
    x, skip = (rng.standard_normal((1, 6, 32)).astype(np.float32) for _ in range(2))
    gamma = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    got, want = _one_op("SkipSimplifiedLayerNormalization", {"x": x, "skip": skip},
                        {"epsilon": 1e-6}, {"gamma": gamma})
    _close(got, want)
    got, want = _one_op("SkipSimplifiedLayerNormalization", {"x": x, "skip": skip},
                        {"epsilon": 1e-6}, {"gamma": gamma}, n_out=["y", "", "", "sum"])
    assert len(got) == 2
    _close(got, want)


@pytest.mark.parametrize("form", ["plain", "packed", "window", "seqlens", "rotary"])
def test_group_query_attention_matches_jax(form):
    rng = np.random.default_rng(5)
    B, S, H, Hkv, hd = 2, 9, 4, 2, 16
    q = rng.standard_normal((B, S, H * hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, Hkv * hd)).astype(np.float32) for _ in range(2))
    attrs = {"num_heads": H, "kv_num_heads": Hkv}
    inputs, inits, order = {"q": q, "k": k, "v": v}, {}, ["q", "k", "v"]
    if form == "packed":
        inputs, order = {"q": np.concatenate([q, k, v], -1)}, ["q", "", ""]
    if form == "window":
        attrs["local_window_size"] = 3
    if form == "seqlens":
        inputs["seqlens_k"] = np.array([8, 4], np.int32)
        order += ["", "", "seqlens_k"]
    if form == "rotary":
        cos, sin = ls._rope_caches(16, hd)
        inits = {"cos": cos, "sin": sin}
        attrs["do_rotary"] = 1
        order += ["", "", "", "", "cos", "sin"]
    got, want = _one_op("GroupQueryAttention", inputs, dict(attrs, _order=order), inits)
    _close(got, want)


def test_group_query_attention_past_buffers_raise():
    b = GraphBuilder("gqa", opset=17)
    for n, s in (("q", (1, 1, 32)), ("k", (1, 1, 16)), ("v", (1, 1, 16)),
                 ("pk", (1, 1, 8, 16)), ("pv", (1, 1, 8, 16))):
        b.input(n, s)
    g = b.finish([b.node("GroupQueryAttention", ["q", "k", "v", "pk", "pv"], outputs=3,
                         num_heads=2, kv_num_heads=1)[0]])
    ex = Executor(g, CPU)
    with pytest.raises(NotSupportedError):
        ex.build_fn()({}, *[torch.zeros(s) for s in ((1, 1, 32), (1, 1, 16), (1, 1, 16),
                                                      (1, 1, 8, 16), (1, 1, 8, 16))])


# -- graphs and the ragged pass -------------------------------------------------

@pytest.mark.parametrize("kv_quant", [False, True])
def test_prefill_builders_match_jax(kv_quant):
    w = _weights()
    for p in (8, 16):
        assert_graphs_equal(
            jls.build_prefill(w, prompt_len=p, max_len=L, kv_quant=kv_quant, **CFG),
            ls.build_prefill(w, prompt_len=p, max_len=L, kv_quant=kv_quant, **CFG))
    assert_graphs_equal(jls.build_full(w, seq_len=12, **CFG), ls.build_full(w, seq_len=12, **CFG))


@pytest.mark.parametrize("kv_quant", [False, True])
def test_prefill_forward_matches_jax(kv_quant):
    """Logits and the filled (padded) caches of one prefill forward."""
    w = _weights()
    gt = ls.build_prefill(w, prompt_len=16, max_len=L, kv_quant=kv_quant, **CFG)
    gj = jls.build_prefill(w, prompt_len=16, max_len=L, kv_quant=kv_quant, **CFG)
    toks = np.random.default_rng(6).integers(0, CFG["vocab"], 16).astype(np.int64)
    ex, exj = Executor(gt, CPU), JExecutor(gj)
    got = ex.build_fn()(ex.cast_params(ex.init_params()), torch.from_numpy(toks))
    want = exj.build_fn()(exj.init_params(), jnp.asarray(toks))
    assert len(got) == len(want) == 1 + (4 if kv_quant else 2) * CFG["layers"]
    lt, lj = got[0].numpy(), np.asarray(want[0])
    assert np.abs(lt - lj).max() <= 1e-4 * np.abs(lj).max()
    for a, b in zip(got[1:], want[1:]):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape == (L,) + b.shape[1:] and a.dtype == b.dtype
        if a.dtype == np.int8:  # a half-way rounding may part by one step
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        else:
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
        assert not a[16:].any()  # rows past the prompt are the Pad's zeros


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("chunk", [1, 5])
def test_ragged_pass_matches_jax(chunk, kv_quant):
    w = _weights()
    gt = ls.build_decode_step(w, **CFG, max_len=L, kv_quant=kv_quant, chunk=chunk)[0]
    gj = jls.build_decode_step(w, **CFG, max_len=L, kv_quant=kv_quant, chunk=chunk)[0]
    run_passes(gt, ["fuse_ragged_attention", "dce"])
    jrun_passes(gj, ["fuse_ragged_attention", "dce"])
    assert_graphs_equal(gj, gt)
    fused = [n for n in gt.nodes if n.op_type == "RaggedDecodeAttention"]
    assert len(fused) == CFG["layers"] and fused[0].attr("chunk") == chunk
    assert len(fused[0].inputs) == (6 if kv_quant else 4)
    assert not any(n.op_type in ("Softmax", "LessOrEqual") for n in gt.nodes)


def test_ragged_attention_config_raises_without_a_chain():
    g = ls.build_decode_step_paged(_weights(), **CFG, slots=2, page_size=32, n_pages=5, npg=2)[0]
    with pytest.raises(NotSupportedError, match="ragged_attention"):
        _decode_graph(g, stt.Config(device="cpu", ragged_attention=True))


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_static_step_matches_jax(ragged, kv_quant):
    """One static-cache step: logits and the written caches, with caches
    full of earlier rows (and stale ones past pos)."""
    w = _weights()
    gt = _decode_graph(ls.build_decode_step(w, **CFG, max_len=L, kv_quant=kv_quant)[0],
                       stt.Config(device="cpu", ragged_attention=ragged))
    gj = jls.build_decode_step(w, **CFG, max_len=L, kv_quant=kv_quant)[0]
    if ragged:
        jrun_passes(gj, ["fuse_ragged_attention", "dce"])
    rng = np.random.default_rng(7)
    by = {"token": np.array([11], np.int64), "pos": np.array([37], np.int64)}
    for v in gt.inputs:
        if v.name.startswith(("k_cache", "v_cache")):
            shape = tuple(v.type.shape)
            by[v.name] = (rng.uniform(1e-3, 2e-2, shape).astype(np.float32) if "scale" in v.name
                          else rng.integers(-127, 128, shape).astype(np.int8) if kv_quant
                          else rng.standard_normal(shape).astype(np.float32))
    ins = [by[v.name] for v in gt.inputs]
    ex, exj = Executor(gt, CPU), JExecutor(gj)
    got = ex.build_fn()(ex.cast_params(ex.init_params()), *[torch.from_numpy(a.copy())
                                                            for a in ins])
    with _jax_ragged_kernel(ragged):
        want = exj.build_fn()(exj.init_params(), *[jnp.asarray(a) for a in ins])
    lt, lj = got[0].numpy(), np.asarray(want[0])
    assert np.abs(lt - lj).max() <= 1e-4 * np.abs(lj).max()
    for a, b in zip(got[1:], want[1:]):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype
        diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
        assert diff.max() <= (1 if a.dtype == np.int8 else 1e-5 * np.abs(b).max())


# -- the ragged kernel's plain version ---------------------------------------------

@pytest.mark.parametrize("B,c", [(1, 1), (3, 1), (1, 5), (3, 5)])
@pytest.mark.parametrize("scales", [None, "float32", "bfloat16"])
def test_ragged_plain_matches_jax_kernel(B, c, scales):
    rng = np.random.default_rng(10 * B + c)
    kvh, g, hd, Lc = 2, 1 if c == 5 else 2, 128, 48
    q = rng.standard_normal((B, kvh, g * c, hd)).astype(np.float32)
    pos = np.array([0, Lc // 2, Lc - 1][:B] if B == 3 else [Lc - 1 if c == 1 else 17], np.int64)
    if scales:  # int8 caches, finite values in every row (stale ones too)
        k, v = (rng.integers(-127, 128, (B, Lc, kvh * hd)).astype(np.int8) for _ in range(2))
        sdt = jnp.bfloat16 if scales == "bfloat16" else jnp.float32
        ks, vs = (np.asarray(jnp.asarray(rng.uniform(1e-3, 2e-2, (B, Lc, 1)), sdt)
                             .astype(jnp.float32)) for _ in range(2))
    else:
        k, v = (rng.standard_normal((B, Lc, kvh * hd)).astype(np.float32) for _ in range(2))
        ks = vs = None
    kw = dict(c=c, kv_heads=kvh, scale=hd ** -0.5)
    t = (lambda a: None if a is None else torch.from_numpy(a.copy()))
    tsc = (lambda a: None if a is None else t(a).to(getattr(torch, scales)))
    got = rda.ragged_decode_attention(t(q), t(k), t(v), t(pos), tsc(ks), tsc(vs), **kw)
    assert rda.launches == 0 and got.dtype == torch.float32  # CPU: the plain version
    got = got.numpy()
    assert np.isfinite(got).all()
    j = (lambda a: None if a is None else jnp.asarray(a))
    for b in range(B):
        kernel = np.asarray(jrda.ragged_decode_attention(
            j(q[b]), j(k[b]), j(v[b]), int(pos[b]), j(None if ks is None else ks[b]),
            j(None if vs is None else vs[b]), interpret=True, **kw))
        ref = np.asarray(jrda.ragged_decode_attention_reference(
            j(q[b]), j(k[b]), j(v[b]), int(pos[b]), j(None if ks is None else ks[b]),
            j(None if vs is None else vs[b]), **kw))
        for r in (kernel, ref):
            assert np.abs(got[b] - r).max() <= 1e-5 * np.abs(r).max()


def test_kernel_ops_vmap_to_one_call_on_cpu():
    """The custom ops' vmap rules: a vmapped per-slot call equals the
    per-slot calls (on the CPU both take the plain versions)."""
    rng = np.random.default_rng(12)
    S, kvh, hd, Lc = 4, 2, 128, 40
    q = torch.from_numpy(rng.standard_normal((S, kvh, 2, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((S, Lc, kvh * hd)).astype(np.float32))
            for _ in range(2))
    pos = torch.tensor([0, 9, 20, 39])
    x = torch.from_numpy(rng.standard_normal((S, 256)).astype(np.float32))
    pk = torch.from_numpy(rng.integers(-128, 128, (128, 64)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(1e-3, 2e-2, (4, 64)).astype(np.float32))
    kw = dict(c=1, kv_heads=kvh, scale=0.1)

    def one(q1, k1, v1, p1, x1):
        att = rda.ragged_decode_attention(q1[None], k1[None], v1[None], p1.reshape(1), **kw)[0]
        return att, i4.int4_matmul(x1[None], pk, s, group=64)[0]

    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no slow per-slot fallback of vmap
        att, mm = torch.func.vmap(one)(q, k, v, pos, x)
    for b in range(S):  # f32 sums in another order: 1e-5 of the largest
        a1, m1 = one(q[b], k[b], v[b], pos[b], x[b])
        assert (att[b] - a1).abs().max() <= 1e-5 * a1.abs().max()
        assert (mm[b] - m1).abs().max() <= 1e-5 * m1.abs().max()


# -- generators -----------------------------------------------------------------

PROMPT = [5, 17, 3, 44, 9, 60, 2, 11]


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_generators_match_jax(ragged, kv_quant):
    """Greedy tokens of Generator and FusedGenerator, with and without a
    prefill graph, identical to the JAX FusedGenerator's."""
    w = _weights()
    step, pfs = _graphs(ls, w, kv_quant)
    jstep, jpfs = _graphs(jls, w, kv_quant)
    cfg = stt.Config(device="cpu", ragged_attention=ragged)
    jcfg = st.Config(ragged_attention=ragged)
    n_new = 14
    with _jax_ragged_kernel(ragged):
        want = JFusedGenerator(jstep, jcfg).generate(PROMPT, n_new)
        want_pf = JFusedGenerator(jstep, jcfg, prefill_graph=jpfs).generate(PROMPT, n_new)
        want16 = JFusedGenerator(jstep, jcfg, prefill_graph=jpfs).generate(
            PROMPT * 2, n_new)
    assert len(set(want[len(PROMPT):])) > 4  # the tokens move
    assert Generator(step, cfg).generate(PROMPT, n_new) == want
    assert FusedGenerator(step, cfg).generate(PROMPT, n_new) == want
    gen = FusedGenerator(step, cfg, prefill_graph=pfs)
    assert gen.generate(PROMPT, n_new) == want_pf
    assert gen.generate(PROMPT * 2, n_new) == want16
    assert gen.generate(PROMPT[:5], n_new) == want[:5] + Generator(step, cfg).generate(
        PROMPT[:5], n_new)[5:]
    assert gen.generate(PROMPT, L) == gen.generate(PROMPT, L - len(PROMPT))  # n_new clamps


def test_fused_generator_samples_reproducibly():
    step, pfs = _graphs(ls, _weights(), True)
    gen = FusedGenerator(step, stt.Config(device="cpu", ragged_attention=True),
                         prefill_graph=pfs)
    a = gen.generate(PROMPT, 12, temperature=0.7, top_k=10, seed=3)
    assert a == gen.generate(PROMPT, 12, temperature=0.7, top_k=10, seed=3)
    assert a[:8] == PROMPT and len(a) == 20
    assert len({tuple(gen.generate(PROMPT, 12, temperature=1.5, seed=s)) for s in range(4)}) > 1


def test_merge_params_shares_weights_by_name_and_content():
    w = _weights()
    step, pfs = _graphs(ls, w, True)
    ex = Executor(step, CPU)
    params = ex.cast_params(ex.init_params())
    host = {n: step.initializers[n] for n in ex.param_names}
    before = dict(params)
    pex = _merge_params(params, host, pfs[0], CPU)
    assert all(params[n] is t for n, t in before.items())  # nothing replaced
    shared = set(pex.param_names) & set(before)
    assert {"wte", "w_head", "wq_0", "wdown_1"} <= shared
    # other weights under the same names are renamed, not shared (an array
    # above 1 MB would also be warned about)
    other = ls.build_prefill(_weights(seed=1), prompt_len=8, max_len=L, **CFG)
    oex = _merge_params(params, host, other, CPU)
    assert "wte__p" in oex.param_names and "wte" not in oex.param_names
    assert not torch.equal(params["wte__p"], params["wte"])
    assert "wte" in other.initializers  # the caller's graph is untouched


# -- servers ---------------------------------------------------------------------

def _prompts(lens, seed=13):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, CFG["vocab"] - 1, n)] for n in lens]


def _serve(server, prompts, n_new=10):
    """Each request's tokens, or the name of the exception it failed with."""
    out = []
    try:
        for f in [server.submit(p, n_new) for p in prompts]:
            try:
                out.append(f.result(timeout=300))
            except Exception as e:  # noqa: BLE001 — the type is the record
                out.append(type(e).__name__)
        return out, server.stats()
    finally:
        server.shutdown()


# 1 token (no prefill), within a bucket, exactly a bucket, past the largest
# bucket (prefill 16, then fed), and enough requests to reuse slots.
SERVE_LENS = (1, 5, 8, 13, 16, 23, 40, 3)


@pytest.mark.parametrize("tick_steps", [1, 3])
def test_decode_server_matches_jax(tick_steps):
    w = _weights()
    prompts = _prompts(SERVE_LENS)
    step, pfs = _graphs(ls, w, True)
    jstep, jpfs = _graphs(jls, w, True)
    got, stats = _serve(DecodeServer(step, slots=3, config=stt.Config(
        device="cpu", ragged_attention=True), prefill_graphs=pfs, tick_steps=tick_steps),
        prompts)
    with _jax_ragged_kernel(True):
        want, _ = _serve(JDecodeServer(jstep, slots=3, config=st.Config(ragged_attention=True),
                                       prefill_graphs=jpfs, tick_steps=tick_steps), prompts)
    assert got == want
    assert stats["prefills"] == sum(n > 1 for n in SERVE_LENS) and stats["active"] == 0


def test_decode_server_without_prefill_matches_generator():
    w = _weights()
    prompts = _prompts((4, 9, 2))
    step, _ = _graphs(ls, w, False)
    got, stats = _serve(DecodeServer(step, slots=2, config=CPU), prompts)
    assert got == [Generator(step, CPU).generate(p, 10) for p in prompts]
    assert stats["prefills"] == 0 and stats["steps"] > 0


def test_decode_server_shares_weights_and_fails_only_the_bad_request():
    w = _weights()
    step, pfs = _graphs(ls, w, True)
    cfg = stt.Config(device="cpu", ragged_attention=True)
    first = DecodeServer(step, slots=2, config=cfg, prefill_graphs=pfs)
    try:
        short = ls.build_decode_step(w, **CFG, max_len=32, kv_quant=True)[0]
        second = DecodeServer(short, slots=2, config=cfg, shared_weights=first.shared_weights())
        try:
            assert second._params is first._params
            assert second.submit(PROMPT, 6).result(timeout=120) == \
                first.submit(PROMPT, 6).result(timeout=120)
        finally:
            second.shutdown()
        good = first._prefills[0][1]

        def broken(*args):
            raise RuntimeError("prefill boom")

        first._prefills[0] = (first._prefills[0][0], broken)
        bad = first.submit(PROMPT[:6], 4)
        with pytest.raises(RuntimeError, match="prefill boom"):
            bad.result(timeout=60)
        first._prefills[0] = (first._prefills[0][0], good)
        assert len(first.submit(PROMPT[:6], 4).result(timeout=60)) == 10
    finally:
        first.shutdown()


@pytest.mark.parametrize("tick_steps", [1, 2])
def test_paged_server_prefill_matches_jax(tick_steps):
    """Prefill admission into pages: 4 pages of 16 rows a slot, 3 slots and
    5 usable pages, so the third prompt finds no pages (PoolExhausted) and
    is fed a token a tick instead, in both packages."""
    w = _weights()
    lens = (40, 30, 21, 5, 8, 13, 2, 16)
    prompts = _prompts(lens)
    ps, npg, slots, n_pages = 16, 4, 3, 6
    pt = ls.build_decode_step_paged(w, **CFG, slots=slots, page_size=ps, n_pages=n_pages,
                                    npg=npg, kv_quant=True)[0]
    pj = jls.build_decode_step_paged(w, **CFG, slots=slots, page_size=ps, n_pages=n_pages,
                                     npg=npg, kv_quant=True)[0]
    pfs = [ls.build_prefill(w, prompt_len=p, max_len=L, kv_quant=True, **CFG) for p in (8, 32)]
    jpfs = [jls.build_prefill(w, prompt_len=p, max_len=L, kv_quant=True, **CFG)
            for p in (8, 32)]
    got, stats = _serve(PagedDecodeServer(pt, CPU, prefill_graphs=pfs, tick_steps=tick_steps),
                        prompts, n_new=6)
    want, _ = _serve(JPagedDecodeServer(pj, prefill_graphs=jpfs, tick_steps=tick_steps),
                     prompts, n_new=6)
    assert got == want
    assert sum(isinstance(r, list) for r in got) >= len(lens) // 2  # evictions match too
    assert 0 < stats["prefills"] < len(lens) and stats["stall_ticks"] > 0
    assert stats["free_pages"] == n_pages - 1


def test_decode_path_runs_without_jax():
    code = textwrap.dedent(f"""
        import sys
        for m in ("jax", "jaxlib", "google.protobuf", "ml_dtypes", "smelter_tpu"):
            sys.modules[m] = None
        import smelter_tpu_torch as stt
        from smelter_tpu_torch.models import llama_style as ls
        from smelter_tpu_torch.runtime.generate import FusedGenerator
        from smelter_tpu_torch.serving.decode_server import DecodeServer
        cfg = {CFG!r}
        w = ls.make_weights(**cfg, max_len={L})
        g = ls.build_decode_step(w, **cfg, max_len={L}, kv_quant=True)[0]
        pf = ls.build_prefill(w, prompt_len=4, max_len={L}, kv_quant=True, **cfg)
        c = stt.Config(device="cpu", ragged_attention=True)
        a = FusedGenerator(g, c, prefill_graph=pf).generate([5, 6, 7, 8], 3)
        srv = DecodeServer(g, slots=2, config=c, prefill_graphs=[pf])
        b = srv.submit([5, 6, 7, 8], 3).result(timeout=120)
        srv.shutdown()
        assert a == b and len(a) == 7, (a, b)
        bad = sorted(k for k, v in sys.modules.items() if v is not None and (
            k == "smelter_tpu" or k.startswith(("smelter_tpu.", "ml_dtypes", "jax",
                                                "google.protobuf"))))
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    step, _ = _graphs(ls, _weights(), True)
    for make in (Generator, FusedGenerator, DecodeServer):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(step)
