"""The port's paged decode serving path against the JAX package, on the CPU.

A tiny LLaMA-style model that passes the int4 fusion gates (K % 2g, N % 128,
g % 32): vocab 256, dim 256, 2 heads (hd 128), 1 KV head, ffn 512, 2 layers,
group 64, page size 32, 2 pages a slot, 4 slots. Inputs come from numpy
seeds and go to both packages; the JAX side runs its Pallas kernels in
interpret mode or through its plain references, as its own tests do.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smelter_tpu_torch as stt
from smelter_tpu.kernels import int4_matmul as ji4
from smelter_tpu.kernels import paged_decode_attention as jpda
from smelter_tpu.kernels.ragged_decode_attention import (
    ragged_decode_attention_reference as jragged_reference)
from smelter_tpu.models import llama_style as jls
from smelter_tpu.passes.pass_manager import run_passes as jrun_passes
from smelter_tpu.quant import quantize_weights as jquantize
from smelter_tpu.runtime.executor import Executor as JExecutor
from smelter_tpu.serving.kv_pool import PagePool as JPagePool
from smelter_tpu.serving.paged_server import PagedDecodeServer as JPagedDecodeServer
from smelter_tpu_torch.ir.errors import NotSupportedError
from smelter_tpu_torch.kernels import int4_matmul as i4
from smelter_tpu_torch.kernels import paged_decode_attention as pda
from smelter_tpu_torch.models import llama_style as ls
from smelter_tpu_torch.passes.fuse_dequant import pack_int4_half
from smelter_tpu_torch.passes.pass_manager import run_passes
from smelter_tpu_torch.quant import quantize_weights
from smelter_tpu_torch.runtime.executor import Executor
from smelter_tpu_torch.serving.kv_pool import PagePool, PoolExhausted
from smelter_tpu_torch.serving.paged_server import PagedDecodeServer
from torch_port_common import assert_graphs_equal

REPO = Path(__file__).resolve().parents[1]
CFG = dict(vocab=256, dim=256, heads=2, kv_heads=1, ffn=512, layers=2)
GROUP, PS, NPG, SLOTS = 64, 32, 2, 4
NPAGES = 1 + SLOTS * NPG
CPU = stt.Config(device="cpu")


def _weights():
    return ls.make_weights(**CFG, max_len=NPG * PS)


def _paged(build, w, kv_quant, n_pages=NPAGES, slots=SLOTS):
    return build.build_decode_step_paged(w, **CFG, slots=slots, page_size=PS,
                                         n_pages=n_pages, npg=NPG, kv_quant=kv_quant)[0]


def _int4(g, quantize, run):
    quantize(g, f"int4-g{GROUP}", min_elements=1024)
    run(g, ["fuse_dequant_matmul", "dce"])
    return g


# -- builders and quantization ---------------------------------------------

def test_make_weights_match_jax():
    w, wj = _weights(), jls.make_weights(**CFG, max_len=NPG * PS)
    assert list(w) == list(wj)
    for k in w:
        assert w[k].dtype == wj[k].dtype and w[k].tobytes() == wj[k].tobytes(), k


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("form", ["paged", "dense"])
def test_builders_match_jax(form, kv_quant):
    w = _weights()
    if form == "paged":
        gt, gj = _paged(ls, w, kv_quant), _paged(jls, w, kv_quant)
    else:
        gt = ls.build_decode_step(w, **CFG, max_len=NPG * PS, kv_quant=kv_quant)[0]
        gj = jls.build_decode_step(w, **CFG, max_len=NPG * PS, kv_quant=kv_quant)[0]
    assert_graphs_equal(gj, gt)


def test_int4_quantization_bit_equal_to_jax():
    w = _weights()
    gt, gj = _paged(ls, w, True), _paged(jls, w, True)
    quantize_weights(gt, f"int4-g{GROUP}", min_elements=1024)
    jquantize(gj, f"int4-g{GROUP}", min_elements=1024)
    assert [n.op_type for n in gt.nodes] == [n.op_type for n in gj.nodes]
    assert list(gt.initializers) == list(gj.initializers)
    n4 = 0
    for name, arr in gj.initializers.items():
        mine = gt.initializers[name]
        if arr.dtype.name == "int4":  # the port holds 4-bit values as int8
            n4 += 1
            assert mine.dtype == np.int8 and np.abs(mine).max() <= 7
            assert np.array_equal(mine, arr.astype(np.int8)), name
        else:
            assert mine.dtype == arr.dtype and mine.tobytes() == arr.tobytes(), name
    assert n4 == 7 * CFG["layers"] + 1  # every MatMul weight, the head included
    assert gt.metadata == gj.metadata == {"quant": f"int4-g{GROUP}"}


def test_int4_fusion_bit_equal_to_jax():
    w = _weights()
    gt = _int4(_paged(ls, w, True), quantize_weights, run_passes)
    gj = _int4(_paged(jls, w, True), jquantize, jrun_passes)
    assert_graphs_equal(gj, gt)
    ops = [n.op_type for n in gt.nodes]
    assert ops.count("FusedDequantMatMulI4") == 7 * CFG["layers"] + 1
    assert "DequantizeLinear" not in ops and "MatMul" not in ops


def test_int4_modes_left_out_still_raise():
    g = _paged(ls, _weights(), False)
    for mode in ("int4", "int8-g64", "fp8"):
        with pytest.raises(NotSupportedError):
            quantize_weights(g, mode)


# -- int4_matmul -------------------------------------------------------------

def _int4_operands(m, k, n, group, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w4 = rng.integers(-8, 8, (k, n), dtype=np.int8)
    s = rng.uniform(1e-3, 2e-2, (k // group, n)).astype(np.float32)
    return x, pack_int4_half(w4), s


@pytest.mark.parametrize("shape", [(8, 256, 128, 64), (3, 512, 256, 128), (5, 128, 384, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int4_matmul_plain_matches_jax(shape, dtype):
    m, k, n, group = shape
    x, pk, s = _int4_operands(m, k, n, group, seed=sum(shape))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = i4.int4_matmul(xt, torch.from_numpy(pk), torch.from_numpy(s), group=group)
    assert i4.launches == 0  # CPU tensors never reach the kernel
    assert got.dtype == torch.float32 and got.shape == (m, n)
    got = got.numpy()
    xj = jnp.asarray(x).astype(dtype)
    kernel = np.asarray(ji4.int4_matmul(xj, jnp.asarray(pk), jnp.asarray(s), group=group,
                                        interpret=True))
    # the Pallas kernel's arithmetic (bf16 x, f32 group dots): sum order only
    assert np.abs(got - kernel).max() <= 1e-5 * np.abs(kernel).max()
    # the JAX package's CPU composite keeps x in f32: bf16 rounding of x
    wd = ji4.unpack_int4_half(jnp.asarray(pk), k).astype(jnp.float32) \
        * jnp.repeat(jnp.asarray(s), group, axis=0)
    composite = np.asarray(jnp.dot(xj.astype(jnp.float32), wd))
    assert np.abs(got - composite).max() <= 1e-2 * np.abs(composite).max()


def test_int4_unpack_inverts_pack():
    w4 = np.random.default_rng(2).integers(-8, 8, (64, 40), dtype=np.int8)
    assert np.array_equal(i4.unpack_int4_half(torch.from_numpy(pack_int4_half(w4))).numpy(), w4)


# -- paged attention and the cache update -----------------------------------

def _paged_inputs(rng, B, kvh, g, c, hd, ps, npg, quant):
    """Pools full of foreign values (pages a slot does not own, rows past its
    frontier) and a shuffled page table."""
    n_pages = 1 + B * npg + 2
    kvd = kvh * hd
    q = rng.standard_normal((B, kvh, g * c, hd)).astype(np.float32)
    table = rng.permutation(np.arange(1, n_pages))[: B * npg].reshape(B, npg).astype(np.int32)
    pos = np.array([0, ps - c, ps, npg * ps - c][:B], np.int64)
    if quant:
        k = rng.integers(-127, 128, (n_pages, ps, kvd), dtype=np.int8)
        v = rng.integers(-127, 128, (n_pages, ps, kvd), dtype=np.int8)
        ks = rng.uniform(1e-3, 2e-2, (n_pages, ps, 1)).astype(np.float32)
        vs = rng.uniform(1e-3, 2e-2, (n_pages, ps, 1)).astype(np.float32)
    else:
        k = rng.standard_normal((n_pages, ps, kvd)).astype(np.float32)
        v = rng.standard_normal((n_pages, ps, kvd)).astype(np.float32)
        ks = vs = None
    return q, k, v, table, pos, ks, vs


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("c", [1, 2])
def test_paged_attention_plain_matches_jax(c, quant):
    rng = np.random.default_rng(10 + c + 2 * quant)
    kvh, g, hd, ps, npg, B = 2, 2, 128, 16, 3, 4
    q, k, v, table, pos, ks, vs = _paged_inputs(rng, B, kvh, g, c, hd, ps, npg, quant)
    kw = dict(c=c, kv_heads=kvh, scale=hd ** -0.5)
    t = (lambda a: None if a is None else torch.from_numpy(a))
    got = pda.paged_decode_attention(t(q), t(k), t(v), t(table), t(pos), t(ks), t(vs), **kw)
    assert pda.launches == 0
    got = got.numpy()
    j = (lambda a: None if a is None else jnp.asarray(a))
    kernel = np.asarray(jpda.paged_decode_attention(
        j(q), j(k), j(v), j(table), j(pos.astype(np.int32)), j(ks), j(vs), interpret=True,
        **kw))
    L = npg * ps
    refs = []
    for b in range(B):
        gat = [None if a is None else jpda.paged_gather_reference(j(a), j(table), L)[b]
               for a in (k, v, ks, vs)]
        refs.append(np.asarray(jragged_reference(j(q)[b], gat[0], gat[1], int(pos[b]),
                                                 gat[2], gat[3], **kw)))
    for ref in (kernel, np.stack(refs)):
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_paged_cache_update_matches_jax_in_place():
    rng = np.random.default_rng(4)
    n_pages, ps, kvd, c = 7, 8, 16, 2
    pool = rng.standard_normal((n_pages, ps, kvd)).astype(np.float32)
    # slots 0-1 live (slot 1 crosses into its second page), slots 2-3 dead:
    # their table rows point at the scratch page 0
    table = np.array([[3, 5], [1, 6], [0, 0], [0, 0]], np.int32)
    pos = np.array([3, 7, 0, 0], np.int64)
    rows = rng.standard_normal((4, c, kvd)).astype(np.float32)
    want = np.asarray(jpda.paged_cache_update(jnp.asarray(pool), jnp.asarray(table),
                                              jnp.asarray(pos), jnp.asarray(rows)))
    pt = torch.from_numpy(pool.copy())
    got = pda.paged_cache_update(pt, torch.from_numpy(table), torch.from_numpy(pos),
                                 torch.from_numpy(rows))
    assert got is pt  # in place
    # the dead slots write the same scratch rows; which write lands last is
    # not defined in either package, so page 0 is checked by membership
    assert np.array_equal(got.numpy()[1:], want[1:])
    for r in range(c):
        assert any(np.array_equal(got.numpy()[0, r], rows[b, r]) for b in (2, 3))


# -- one paged step through both executors ----------------------------------

def _step_inputs(g, seed):
    """Three live slots at different positions (one past its first page)
    and a dead slot on the scratch page."""
    rng = np.random.default_rng(seed)
    by = {"token": rng.integers(0, CFG["vocab"], (SLOTS, 1)).astype(np.int64),
          "pos": np.array([0, 17, 40, 0], np.int64),
          "page_table": np.array([[1, 2], [3, 4], [5, 6], [0, 0]], np.int32)}
    for v in g.inputs:
        if v.name.startswith(("k_pool", "v_pool")):
            dt_ = v.type.np_dtype
            shape = tuple(v.type.shape)
            by[v.name] = (rng.integers(-127, 128, shape).astype(dt_)
                          if dt_ == np.int8 else rng.standard_normal(shape).astype(dt_))
        elif v.name.startswith(("k_scale_pool", "v_scale_pool")):
            by[v.name] = rng.uniform(1e-3, 2e-2, tuple(v.type.shape)).astype(np.float32)
    return [by[v.name] for v in g.inputs]


def _run_both(gt, gj, inputs):
    ext, exj = Executor(gt, CPU), JExecutor(gj)
    got = ext.build_fn()(ext.cast_params(ext.init_params()),
                         *[torch.from_numpy(a.copy()) for a in inputs])
    want = exj.build_fn()(exj.init_params(), *[jnp.asarray(a) for a in inputs])
    return got, want


@pytest.mark.parametrize("kv_quant", [False, True])
def test_paged_step_matches_jax_float_weights(kv_quant):
    w = _weights()
    gt, gj = _paged(ls, w, kv_quant), _paged(jls, w, kv_quant)
    got, want = _run_both(gt, gj, _step_inputs(gt, seed=7))
    lt, lj = got[0].numpy(), np.asarray(want[0])
    assert lt.shape == (SLOTS, 1, CFG["vocab"])
    # f32 on both sides, sums in other orders: 1e-4 of the largest logit
    assert np.abs(lt - lj).max() <= 1e-4 * np.abs(lj).max()
    for a, b in zip(got[1:], want[1:]):  # the pools after the write
        assert a.numpy().dtype == np.asarray(b).dtype
        if a.dtype == torch.int8:  # a half-way rounding may part by one step
            assert np.abs(a.numpy().astype(int) - np.asarray(b).astype(int)).max() <= 1
        else:
            assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-5 * np.abs(b).max() + 1e-12


def test_paged_step_matches_jax_int4_weights():
    w = _weights()
    gt = _int4(_paged(ls, w, True), quantize_weights, run_passes)
    gj = _int4(_paged(jls, w, True), jquantize, jrun_passes)
    got, want = _run_both(gt, gj, _step_inputs(gt, seed=8))
    lt, lj = got[0].numpy(), np.asarray(want[0])
    # the port's int4_matmul rounds x to bf16 (as the Pallas kernel does),
    # the JAX CPU composite keeps it in f32: 1e-2 of the largest logit
    assert np.abs(lt - lj).max() <= 1e-2 * np.abs(lj).max()
    assert np.isfinite(lt).all()


# -- the server -----------------------------------------------------------

# Lengths 25-50 cross the 32-row page boundary; at 5 usable pages for 4
# slots that need 8, slots stall until a sequence finishes.
PROMPT_LENS, N_NEW = (20, 25, 28, 30, 5, 12), 20


def _prompts():
    rng = np.random.default_rng(11)
    return [[int(t) for t in rng.integers(1, CFG["vocab"] - 1, n)] for n in PROMPT_LENS]


def _serve(server, prompts):
    try:
        futs = [server.submit(p, N_NEW) for p in prompts]
        results = [f.result(timeout=300) for f in futs]
    finally:
        server.shutdown()
    return results, server.stats()


@pytest.mark.parametrize("tick_steps", [1, 2])
def test_server_tokens_match_jax(tick_steps):
    w = _weights()
    prompts = _prompts()
    small = 1 + 5
    got, stats = _serve(PagedDecodeServer(_paged(ls, w, True, n_pages=small), CPU,
                                          tick_steps=tick_steps), prompts)
    want, jstats = _serve(JPagedDecodeServer(_paged(jls, w, True, n_pages=small),
                                             tick_steps=tick_steps), prompts)
    assert got == want
    assert all(len(g) == len(p) + N_NEW for g, p in zip(got, prompts))
    assert stats["stall_ticks"] > 0 and jstats["stall_ticks"] > 0
    assert stats["free_pages"] == small - 1 and stats["active"] == 0
    assert stats["steps"] > 0


@pytest.mark.parametrize("tick_steps", [1, 5])
def test_server_tokens_match_jax_up_to_the_table_end(tick_steps):
    """Sequences that fill all NPG * PS rows: a multi-step tick runs its last
    steps past the end, where both packages clamp the rotary positions."""
    w = _weights()
    rng = np.random.default_rng(12)
    prompts = [[int(t) for t in rng.integers(1, CFG["vocab"] - 1, n)] for n in (50, 61, 9)]
    got, _ = _serve(PagedDecodeServer(_paged(ls, w, True), CPU, tick_steps=tick_steps),
                    prompts)
    want, _ = _serve(JPagedDecodeServer(_paged(jls, w, True), tick_steps=tick_steps), prompts)
    assert got == want
    assert [len(g) for g in got] == [NPG * PS, NPG * PS, 9 + N_NEW]


def test_server_deadlock_eviction_fails_one_and_finishes_the_other():
    """Two slots that both need a second page with none free: one fails
    with PoolExhausted, the other finishes as it does alone."""
    w = _weights()
    prompts = [[3, 9, 14, 2] * 5, [5, 1] * 8]  # both cross row 32 on one tick
    alone = _serve(PagedDecodeServer(_paged(ls, w, True), CPU), prompts)[0]
    srv = PagedDecodeServer(_paged(ls, w, True, n_pages=3, slots=2), CPU)
    res = []
    try:
        for f in [srv.submit(p, N_NEW) for p in prompts]:
            try:
                res.append(f.result(timeout=300))
            except PoolExhausted:
                res.append(None)
    finally:
        srv.shutdown()
    assert res.count(None) == 1
    assert all(r is None or r == a for r, a in zip(res, alone))
    assert srv.pool.free_pages == 2


def test_server_rejects_what_the_port_leaves_out():
    """Still left out: a step of more than one token a slot, and context
    arrays (prefill admission is in; tests/test_torch_decode.py covers it)."""
    gc2 = ls.build_decode_step_paged(_weights(), **CFG, slots=SLOTS, page_size=PS,
                                     n_pages=NPAGES, npg=NPG, chunk=2)[0]
    with pytest.raises(NotImplementedError):
        PagedDecodeServer(gc2, CPU)
    srv = PagedDecodeServer(_paged(ls, _weights(), True), CPU)
    try:
        with pytest.raises(ValueError, match="context"):
            srv.submit([3, 4], 2, context={"memory": np.zeros(4, np.float32)}).result(timeout=60)
    finally:
        srv.shutdown()


def test_server_fails_requests_on_a_step_error_and_keeps_serving():
    srv = PagedDecodeServer(_paged(ls, _weights(), True), CPU)
    try:
        good = srv._fn

        def broken(*args):
            raise RuntimeError("boom")

        srv._fn = broken
        with pytest.raises(RuntimeError, match="boom"):
            srv.submit([3, 4], 4).result(timeout=60)
        assert srv.pool.free_pages == NPAGES - 1  # released before the failure is told
        srv._fn = good
        assert len(srv.submit([3, 4], 4).result(timeout=60)) == 6
    finally:
        srv.shutdown()


# -- the page pool ----------------------------------------------------------

def _pool_script(pool_cls):
    pool = pool_cls(7, 4, 3, scratch=True)
    log = []
    for op, slot, n in [("ensure", 0, 5), ("ensure", 1, 4), ("ensure", 2, 9),
                        ("release", 0, 0), ("ensure", 2, 12), ("ensure", 1, 20),
                        ("ensure", 0, 1), ("release", 2, 0), ("ensure", 1, 12)]:
        try:
            r = getattr(pool, op)(slot, n) if op == "ensure" else pool.release(slot)
            log.append((op, slot, r))
        except Exception as e:  # noqa: BLE001 — the exception type is the record
            log.append((op, slot, type(e).__name__))
        log.append((pool.free_pages, pool.table(3).tolist(), pool.pages_of(slot)))
    return log


def test_page_pool_matches_jax():
    assert _pool_script(PagePool) == _pool_script(JPagePool)


# -- the import rule --------------------------------------------------------

def test_decode_path_runs_without_jax_protobuf_or_ml_dtypes():
    code = textwrap.dedent(f"""
        import sys
        for m in ("jax", "jaxlib", "google.protobuf", "ml_dtypes", "smelter_tpu"):
            sys.modules[m] = None
        import smelter_tpu_torch as stt
        from smelter_tpu_torch.models import llama_style as ls
        from smelter_tpu_torch.passes.pass_manager import run_passes
        from smelter_tpu_torch.quant import quantize_weights
        from smelter_tpu_torch.serving.paged_server import PagedDecodeServer
        cfg = {CFG!r}
        w = ls.make_weights(**cfg, max_len={NPG * PS})
        g = ls.build_decode_step_paged(w, **cfg, slots=2, page_size={PS}, n_pages=5,
                                       npg={NPG}, kv_quant=True)[0]
        quantize_weights(g, "int4-g{GROUP}", min_elements=1024)
        run_passes(g, ["fuse_dequant_matmul", "dce"])
        srv = PagedDecodeServer(g, stt.Config(device="cpu"), tick_steps=2)
        out = srv.submit([5, 6, 7], 3).result(timeout=120)
        srv.shutdown()
        assert len(out) == 6, out
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
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedDecodeServer(_paged(ls, _weights(), True))
