"""The port's speculative servers and KV bucket ladder
(smelter_tpu_torch/serving/decode_server.py: `SpecDecodeServer`,
`BucketedDecodeServer`; serving/paged_server.py: `SpecPagedDecodeServer`)
against the JAX package's, on the CPU in f32.

The JAX tests' small configurations (tests/test_speculative.py): a target of
vocab 96, dim 128, 4 heads over 2 KV heads, 3 layers, verified in chunks of
5 (g*c = 10, as llama_1b's verify), a 1-layer draft of dim 32; both
packages get the same numpy weights. Tokens and `accept_rate` must equal the
JAX servers' and the tokens the port's DecodeServer's: prompts fed as
forced drafts, prefill admission (target and draft ladders), a self-draft
(every draft accepted), an early-exit draft (the target's first layer),
stop tokens, rounds_per_tick 1 and 3, the ragged attention route; the paged
server also under a pool too small for both requests. The ladder: routing
to the smallest bucket that fits, spill-up, rejection, one weight set, and
a speculative bucket beside a plain one.
"""

import warnings

import numpy as np
import pytest

import smelter_tpu_torch as stt
from smelter_tpu.models import llama_style as jls
from smelter_tpu.serving import decode_server as jds
from smelter_tpu.serving import paged_server as jps
from smelter_tpu_torch.models import llama_style as tls
from smelter_tpu_torch.serving import decode_server as tds
from smelter_tpu_torch.serving import paged_server as tps
from smelter_tpu_torch.serving.kv_pool import PoolExhausted

CFG = dict(vocab=96, dim=128, heads=4, kv_heads=2, ffn=256, layers=3)
DCFG = dict(vocab=96, dim=32, heads=2, kv_heads=1, ffn=64, layers=1)
MAX_LEN, CHUNK, SLOTS = 64, 5, 3
PS, NPG = 8, 8  # paged: 8-row pages, 8 a slot (64 rows)
CPU = stt.Config(device="cpu")
RAGGED = stt.Config(device="cpu", ragged_attention=True)
PROMPTS = [[5, 9, 2, 17], [1, 4], [7, 3, 9, 1, 2, 8, 6], [2] * 9, [9], [4, 8] * 9]
N_NEW = 10


def _graphs(ls, wt, wd):
    """One package's graphs on the shared weights."""
    return {
        "step": ls.build_decode_step(wt, max_len=MAX_LEN, **CFG)[0],
        "chunk": ls.build_decode_step(wt, max_len=MAX_LEN, chunk=CHUNK, **CFG)[0],
        "draft": ls.build_decode_step(wd, max_len=MAX_LEN, **DCFG)[0],
        "self": ls.build_decode_step(wt, max_len=MAX_LEN, **CFG)[0],
        "early": ls.build_decode_step(wt, max_len=MAX_LEN, **dict(CFG, layers=1))[0],
        "pfs": [ls.build_prefill(wt, prompt_len=p, max_len=MAX_LEN, **CFG) for p in (4, 8)],
        "dpfs": [ls.build_prefill(wd, prompt_len=p, max_len=MAX_LEN, **DCFG) for p in (4, 8)],
        "paged": ls.build_decode_step_paged(wt, **CFG, slots=SLOTS, page_size=PS,
                                            n_pages=1 + SLOTS * NPG, npg=NPG,
                                            chunk=CHUNK)[0],
    }


@pytest.fixture(scope="module")
def graphs():
    wt = jls.make_weights(max_len=MAX_LEN, **CFG)
    wd = jls.make_weights(max_len=MAX_LEN, seed=7, **DCFG)
    return wt, _graphs(jls, wt, wd), _graphs(tls, wt, wd)


@pytest.fixture(scope="module")
def plain(graphs):
    """The port's DecodeServer tokens for PROMPTS."""
    srv = tds.DecodeServer(graphs[2]["step"], slots=SLOTS, config=CPU)
    try:
        return [f.result(timeout=300) for f in [srv.submit(p, N_NEW) for p in PROMPTS]]
    finally:
        srv.shutdown()


def _serve(srv, prompts=PROMPTS, n=N_NEW):
    try:
        out = [f.result(timeout=300) for f in [srv.submit(p, n) for p in prompts]]
        return out, srv.stats()
    finally:
        srv.shutdown()


# (variant, draft, SpecDecodeServer keyword arguments): prompts as forced
# drafts, prefill admission of target and draft, self- and early-exit
# drafts, three rounds a tick
SPEC = [("forced", "draft", {}),
        ("prefill", "draft", {"prefill_graphs": "pfs", "draft_prefill_graphs": "dpfs"}),
        ("self", "self", {}),
        ("early", "early", {"prefill_graphs": "pfs"}),
        ("rounds3", "draft", {"rounds_per_tick": 3})]


@pytest.mark.parametrize("variant,draft,kw", SPEC, ids=[v[0] for v in SPEC])
def test_spec_decode_server_matches_jax(graphs, plain, variant, draft, kw):
    _, jg, tg = graphs

    def make(mod, g, **extra):
        args = {k: (g[v] if isinstance(v, str) else v) for k, v in kw.items()}
        return mod.SpecDecodeServer(g["step"], g["chunk"], g[draft], slots=SLOTS, **args,
                                    **extra)

    want, jst = _serve(make(jds, jg))
    srv = make(tds, tg, config=RAGGED if variant == "rounds3" else CPU)
    got, st = _serve(srv)
    assert got == want == plain
    assert st["accept_rate"] == jst["accept_rate"] and st["gamma"] == CHUNK - 1
    # the draft's prefill graphs share the draft step's renamed weights
    assert not [n for n in srv._params if n.endswith("__p_")]
    if variant == "self":
        assert st["accept_rate"] == 1.0
    if "prefill_graphs" in kw:
        assert st["prefills"] == sum(len(p) > 1 for p in PROMPTS)


def test_spec_rounds_take_fewer_ticks_and_stop_tokens(graphs, plain):
    """Three rounds a tick give round-for-round the single-round tokens in
    fewer ticks; a stop token ends a sequence as in DecodeServer."""
    _, _, tg = graphs
    one, st1 = _serve(tds.SpecDecodeServer(tg["step"], tg["chunk"], tg["self"], slots=SLOTS,
                                           config=CPU), PROMPTS[:3], 16)
    three, st3 = _serve(tds.SpecDecodeServer(tg["step"], tg["chunk"], tg["self"], slots=SLOTS,
                                             config=CPU, rounds_per_tick=3), PROMPTS[:3], 16)
    assert three == one
    assert 0 < st3["ticks"] < st1["ticks"] and st3["rounds"] > st3["ticks"]
    full = plain[2]
    stop = full[len(PROMPTS[2]) + 4]
    first = full.index(stop, len(PROMPTS[2]))
    for R in (1, 3):
        srv = tds.SpecDecodeServer(tg["step"], tg["chunk"], tg["draft"], slots=SLOTS,
                                   config=CPU, stop_tokens=(stop,), rounds_per_tick=R)
        got, _ = _serve(srv, [PROMPTS[2]])
        assert got[0] == full[:first + 1]


PAGED = [("forced", {}, {}),
         ("prefill", {"prefill_graphs": "pfs", "draft_prefill_graphs": "dpfs"}, {}),
         ("rounds3", {"rounds_per_tick": 3}, {"config": RAGGED})]


@pytest.mark.parametrize("variant,kw,port_kw", PAGED, ids=[v[0] for v in PAGED])
def test_spec_paged_server_matches_jax(graphs, plain, variant, kw, port_kw):
    _, jg, tg = graphs

    def make(mod, g, **extra):
        args = {k: (g[v] if isinstance(v, str) else v) for k, v in kw.items()}
        return mod.SpecPagedDecodeServer(g["paged"], g["draft"], **args, **extra)

    want, jst = _serve(make(jps, jg))
    srv = make(tps, tg, **({"config": CPU} | port_kw))
    got, st = _serve(srv)
    assert got == want == plain
    assert st["accept_rate"] == jst["accept_rate"]
    assert srv.pool.free_pages == SLOTS * NPG  # every page back (page 0 is scratch)


def test_spec_paged_backpressure(graphs):
    """A pool of 3 usable pages for two requests that need 2 each: slots
    stall and resume, or the least-progressed one is failed; what finishes
    equals DecodeServer's tokens, and every page comes back."""
    wt, _, tg = graphs
    chunk = tls.build_decode_step_paged(wt, **CFG, slots=2, page_size=PS, n_pages=4, npg=NPG,
                                        chunk=CHUNK)[0]
    srv = tps.SpecPagedDecodeServer(chunk, tg["draft"], config=CPU)
    prompts = [[3, 9], [5, 1]]
    try:
        futs = [srv.submit(p, 12) for p in prompts]
        got = []
        for f in futs:
            try:
                got.append(f.result(timeout=300))
            except PoolExhausted:
                got.append(None)
    finally:
        srv.shutdown()
    assert sum(g is None for g in got) <= 1
    flat = tds.DecodeServer(tg["step"], slots=2, config=CPU)
    try:
        for p, g in zip(prompts, got):
            if g is not None:
                assert g == flat.submit(p, 12).result(timeout=300)
    finally:
        flat.shutdown()
    assert srv.pool.free_pages == 3


def _buckets(ls, wt, spec_short: bool):
    """A 16-row bucket of 2 slots (speculative, chunk 3 and a 1-layer
    early-exit draft, if spec_short) and a 64-row one of 2."""
    short = {"step": ls.build_decode_step(wt, max_len=16, **CFG)[0], "slots": 2}
    if spec_short:
        short["chunk"] = ls.build_decode_step(wt, max_len=16, chunk=3, **CFG)[0]
        short["draft"] = ls.build_decode_step(wt, max_len=16, **dict(CFG, layers=1))[0]
    return [short, {"step": ls.build_decode_step(wt, max_len=64, **CFG)[0], "slots": 2}]


def test_bucketed_mixed_spec_and_plain_matches_jax(graphs, plain):
    wt, _, _ = graphs
    prompts = [[5, 9, 2], [1] * 30, [7, 3], [4, 4, 4]]
    want, _ = _serve(jds.BucketedDecodeServer(_buckets(jls, wt, True)), prompts, 6)
    srv = tds.BucketedDecodeServer(_buckets(tls, wt, True), config=CPU)
    got, st = _serve(srv, prompts, 6)
    assert got == want
    assert st["buckets"][0]["max_len"] == 16 and "accept_rate" in st["buckets"][0]
    assert srv.cache_bytes() < srv.uniform_cache_bytes()
    flat = tds.DecodeServer(_buckets(tls, wt, False)[1]["step"], slots=2, config=CPU)
    try:
        assert got == [flat.submit(p, 6).result(timeout=300) for p in prompts]
    finally:
        flat.shutdown()


def test_bucketed_routing_spill_and_shared_weights(graphs):
    wt, _, _ = graphs
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a duplicated-weights warning fails
        srv = tds.BucketedDecodeServer(_buckets(tls, wt, False), config=CPU)
    small, big = srv._servers
    try:
        assert small.shared_weights()[0] is big.shared_weights()[0]  # one weight set
        assert not [n for n, t in small.shared_weights()[0].items()
                    if "__p" in n and t.numel() > 1000]
        # a short request goes to the 16-row bucket, a long one to 64
        assert len(srv.submit([3, 1], 4).result(timeout=300)) == 6
        assert small.stats()["steps"] > 0 and big.stats()["steps"] == 0
        assert len(srv.submit([9] * 30, 8).result(timeout=300)) == 38
        steps = big.stats()["steps"]
        assert steps > 0
        # a full small bucket spills a short request up
        small.stats = lambda: {"active": small.slots, "queued": 0, "slots": small.slots}
        assert len(srv.submit([3, 1], 4).result(timeout=300)) == 6
        assert big.stats()["steps"] > steps
        # longer than every bucket: the largest rejects the prompt
        with pytest.raises(ValueError):
            srv.submit([1] * 64, 4).result(timeout=60)
        assert [b["max_len"] for b in srv.stats()["buckets"]] == [16, 64]
        assert np.isclose(srv.cache_bytes() / srv.uniform_cache_bytes(), (16 + 64) / 128)
    finally:
        srv.shutdown()
