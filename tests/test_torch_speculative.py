"""The port's `SpeculativeGenerator` (smelter_tpu_torch/runtime/
speculative.py) against the JAX package's, on the CPU in f32.

The JAX tests' small configurations (tests/test_speculative.py): a target of
vocab 96, dim 128, 4 heads over 2 KV heads, 3 layers, verified in chunks of
5 (gamma 4, so g*c = 2 x 5 = 10 query rows a KV head, as llama_1b's verify),
and a 1-layer draft of dim 32. Both packages get the same numpy weights.
Greedy tokens must equal the JAX generator's and the port's plain
`Generator`'s, and `last_rounds` / `last_accept_rate` the JAX run's: with a
random draft, a self-draft (every draft accepted), a prefill graph, near
max_len (the plain-step tail), an int4 target and the ragged attention
route. Sampled mode draws from a `torch.Generator`, so its tokens differ
from the JAX run's: it is held to being deterministic by seed, to
collapsing to greedy at temperature 1e-4, and to the target's first-token
distribution within a total-variation bound.
"""

import collections

import numpy as np
import pytest

import smelter_tpu as st
import smelter_tpu_torch as stt
from smelter_tpu.models import llama_style as jls
from smelter_tpu.runtime.speculative import SpeculativeGenerator as JSpec
from smelter_tpu_torch.models import llama_style as tls
from smelter_tpu_torch.runtime.generate import FusedGenerator, Generator
from smelter_tpu_torch.runtime.speculative import SpeculativeGenerator

CFG = dict(vocab=96, dim=128, heads=4, kv_heads=2, ffn=256, layers=3)
DCFG = dict(vocab=96, dim=32, heads=2, kv_heads=1, ffn=64, layers=1)
MAX_LEN, CHUNK = 64, 5
CPU = stt.Config(device="cpu")
PROMPTS = [[5, 9, 2, 17, 3], [1], [7, 7]]


def _graphs(ls, wt, wd, **kw):
    """(step, chunk, draft step) of one package on the shared weights."""
    return (ls.build_decode_step(wt, max_len=MAX_LEN, **kw, **CFG)[0],
            ls.build_decode_step(wt, max_len=MAX_LEN, chunk=CHUNK, **kw, **CFG)[0],
            ls.build_decode_step(wd, max_len=MAX_LEN, **DCFG)[0])


@pytest.fixture(scope="module")
def weights():
    return (jls.make_weights(max_len=MAX_LEN, **CFG),
            jls.make_weights(max_len=MAX_LEN, seed=7, **DCFG))


@pytest.fixture(scope="module")
def gens(weights):
    """The JAX and port speculative generators with the random draft, and
    the port's plain generators."""
    wt, wd = weights
    step = _graphs(tls, wt, wd)[0]
    return (JSpec(*_graphs(jls, wt, wd)), SpeculativeGenerator(*_graphs(tls, wt, wd), config=CPU),
            (Generator(step, CPU), FusedGenerator(step, CPU)))


def _same(jax_gen, port, plain, prompt, n):
    want = jax_gen.generate(prompt, n)
    got = port.generate(prompt, n)
    assert got == want, (prompt, n)
    host, fused = plain
    assert got == fused.generate(prompt, n)
    if len(prompt) + n <= MAX_LEN:  # Generator does not clamp n_new to the cache
        assert got == host.generate(prompt, n)
    assert port.last_rounds == jax_gen.last_rounds
    assert port.last_accept_rate == jax_gen.last_accept_rate
    return got


@pytest.mark.parametrize("prompt", PROMPTS)
def test_random_draft_matches_jax(gens, prompt):
    """A junk draft changes the round count, never the tokens."""
    j, t, plain = gens
    _same(j, t, plain, prompt, 16)
    assert t.last_rounds <= 16


def test_self_draft_full_acceptance(weights, gens):
    """Draft = target: every draft verifies, so 20 tokens take ceil(20 / 5)
    rounds; this runs the full-acceptance catch-up step."""
    wt, _ = weights
    j = JSpec(*_graphs(jls, wt, wt)[:2], jls.build_decode_step(wt, max_len=MAX_LEN, **CFG)[0])
    t = SpeculativeGenerator(*_graphs(tls, wt, wt)[:2],
                             tls.build_decode_step(wt, max_len=MAX_LEN, **CFG)[0], config=CPU)
    _same(j, t, gens[2], [5, 9, 2, 17, 3], 20)
    assert t.last_rounds == 4 and t.last_accept_rate == 1.0


def test_prefill_graph(weights, gens):
    """A prompt of the prefill graph's length fills the target's caches in
    one forward; another length falls back to steps."""
    wt, wd = weights
    j = JSpec(*_graphs(jls, wt, wd),
              prefill_graph=jls.build_prefill(wt, prompt_len=5, max_len=MAX_LEN, **CFG))
    t = SpeculativeGenerator(*_graphs(tls, wt, wd), config=CPU,
                             prefill_graph=tls.build_prefill(wt, prompt_len=5,
                                                             max_len=MAX_LEN, **CFG))
    _same(j, t, gens[2], [5, 9, 2, 17, 3], 16)
    _same(j, t, gens[2], [3, 4], 10)


@pytest.mark.parametrize("plen,n", [(MAX_LEN - 6, 6), (MAX_LEN - 2, 2), (MAX_LEN - 1, 1),
                                    (MAX_LEN - 10, 99)])
def test_tail_near_max_len(gens, plen, n):
    """Near the cache's end the chunk's gamma + 1 rows do not fit: the
    rounds stop and plain target steps finish, n_new = max_len - plen."""
    j, t, plain = gens
    got = _same(j, t, plain, list(range(1, plen + 1)), n)
    assert len(got) == plen + min(n, MAX_LEN - plen)


def test_int4_target_and_ragged_route(weights):
    """An int4-g32 target (step and chunk quantized alike, weights shared)
    against an f32 draft, through the ragged attention route (the chunk's
    attention at g*c 10, the draft's at hd 16): the tokens of the port's
    FusedGenerator on the same target, and the JAX generator's."""
    from smelter_tpu.passes.pass_manager import run_passes as jrun
    from smelter_tpu.quant import quantize_weights as jq
    from smelter_tpu_torch.passes.pass_manager import run_passes as trun
    from smelter_tpu_torch.quant import quantize_weights as tq

    wt, wd = weights

    def q4(g, quantize, run):
        quantize(g, "int4-g32", min_elements=64)
        run(g, ["fuse_dequant_matmul", "dce"])
        return g

    js, jc, jd = _graphs(jls, wt, wd)
    ts, tc, td = _graphs(tls, wt, wd)
    j = JSpec(q4(js, jq, jrun), q4(jc, jq, jrun), jd)
    ts, tc = q4(ts, tq, trun), q4(tc, tq, trun)
    ragged = stt.Config(device="cpu", ragged_attention=True)
    t = SpeculativeGenerator(ts, tc, td, config=ragged)
    fused = FusedGenerator(ts, ragged)
    p = [5, 9, 2, 17, 3]
    want = j.generate(p, 12)
    assert t.generate(p, 12) == want == fused.generate(p, 12)
    assert (t.last_rounds, t.last_accept_rate) == (j.last_rounds, j.last_accept_rate)


def test_sampled_deterministic_and_greedy_collapse(gens):
    _, t, _ = gens
    p = [5, 9, 2]
    a = t.generate(p, 10, temperature=0.9, top_k=8, seed=5)
    assert a == t.generate(p, 10, temperature=0.9, top_k=8, seed=5)
    assert len(a) == 13 and all(0 <= x < CFG["vocab"] for x in a)
    # temperature -> 0 collapses to the greedy chain
    assert t.generate(p, 10, temperature=1e-4, seed=11) == t.generate(p, 10)


def test_sampled_first_token_distribution():
    """The first sampled token's distribution against the target's exact
    one (the JAX package's full forward): total variation within sampling
    noise, as tests/test_speculative.py holds the JAX generator."""
    cfg = dict(vocab=12, dim=64, heads=4, kv_heads=2, ffn=128, layers=2)
    dcfg = dict(vocab=12, dim=32, heads=2, kv_heads=1, ffn=64, layers=1)
    max_len = 16
    wt = jls.make_weights(max_len=max_len, **cfg)
    wd = jls.make_weights(max_len=max_len, seed=7, **dcfg)
    spec = SpeculativeGenerator(
        tls.build_decode_step(wt, max_len=max_len, **cfg)[0],
        tls.build_decode_step(wt, max_len=max_len, chunk=4, **cfg)[0],
        tls.build_decode_step(wd, max_len=max_len, **dcfg)[0], config=CPU)
    p, temp, n = [3, 7, 1], 1.1, 300
    full = st.CompiledModel(jls.build_full(wt, seq_len=3, **cfg))
    logits = np.asarray(full(np.asarray(p, np.int64))[0][2], np.float64)
    pz = np.exp(logits / temp - np.max(logits / temp))
    pz /= pz.sum()
    cnt = collections.Counter(spec.generate(p, 1, temperature=temp, seed=s)[3]
                              for s in range(n))
    emp = np.array([cnt.get(i, 0) for i in range(12)], np.float64) / n
    tv = 0.5 * np.abs(emp - pz).sum()
    assert tv < 0.15, tv
