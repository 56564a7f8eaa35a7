"""The port's Hopper kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and skip without one. This file imports no JAX,
so on a machine without JAX run it without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from smelter_tpu_torch.kernels import dequant_matmul as dm
from smelter_tpu_torch.kernels import int4_matmul as i4
from smelter_tpu_torch.kernels import int8_matmul as im
from smelter_tpu_torch.kernels import paged_decode_attention as pda
from smelter_tpu_torch.passes.fuse_dequant import pack_int4_half

pytestmark = pytest.mark.gpu

# Ragged edges (M, N, K not multiples of the 128/128/32-or-64 tiles, N not
# a multiple of the vector width) beside the ResNet-50 head shape.
SHAPES = [(1, 8, 16), (37, 100, 70), (130, 257, 1000), (128, 1000, 2048),
          (300, 1001, 99)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(m, n, k, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k), np.float32)).to(device, dtype)
    w = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8)).to(device)
    s = torch.from_numpy(rng.uniform(1e-3, 2e-2, n).astype(np.float32)).to(device)
    return x, w, s


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_dequant_matmul_matches_plain(cuda, shape, dtype):
    m, n, k = shape
    x, w, s = _operands(m, n, k, dtype, cuda)
    before = dm.launches
    got = dm.dequant_matmul(x, w, s)
    torch.cuda.synchronize()
    assert dm.launches == before + 1
    ref = dm.dequant_matmul_plain(x, w, s)
    assert got.dtype == dtype and got.shape == (m, n)
    # bf16/f16: the two sums differ in order, then both round to 8 or 11
    # mantissa bits, so ~1 ulp of the largest output; f32: order only.
    tol = {torch.bfloat16: 1e-2, torch.float16: 2e-3, torch.float32: 1e-5}[dtype]
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


# dequant_matmul's two wgmma forms (kernels/wgmma_plan.py): every M x N x K
# of these lists, in bf16, against the plain version at 1e-2 of its largest
# output, and bit-equal from call to call (the cluster form's K split is
# summed in a fixed order). N 1000 is the head's 1000-byte W row, which TMA
# cannot take.
DQ_M, DQ_N, DQ_K = [1, 7, 128, 129, 8192], [8, 1000, 1001, 4096], [8, 72, 2048, 2056, 4096]
_DQ_TOL = {torch.bfloat16: 1e-2, torch.float16: 2e-3, torch.float32: 1e-5}


def _dequant_agrees(x, w, s, out_dtype=None):
    got = dm.dequant_matmul(x, w, s, out_dtype=out_dtype)
    again = dm.dequant_matmul(x, w, s, out_dtype=out_dtype)
    ref = dm.dequant_matmul_plain(x, w, s, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.equal(got, again)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= _DQ_TOL[got.dtype] * ref.float().abs().max().item(), err


@pytest.mark.parametrize("m", DQ_M)
@pytest.mark.parametrize("n", DQ_N)
@pytest.mark.parametrize("k", DQ_K)
def test_dequant_matmul_forms_match_plain(cuda, m, n, k):
    x, w, s = _operands(m, n, k, torch.bfloat16, cuda, seed=m + n + k)
    _dequant_agrees(x, w, s)


@pytest.mark.parametrize("shape", [(128, 1000, 2048), (129, 1001, 72), (2048, 4096, 2048),
                                   (8192, 4096, 4096)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_dequant_matmul_forms_each_dtype(cuda, shape, dtype, out_dtype):
    m, n, k = shape
    x, w, s = _operands(m, n, k, dtype, cuda)
    _dequant_agrees(x, w, s, out_dtype)


def test_dequant_matmul_unaligned_bases_take_the_cluster_form(cuda):
    """Bases 8 bytes off a 16-byte boundary: no TMA map; the cluster form
    with 8-byte loads of x's rows, then element loads."""
    m, n, k = 2048, 4096, 2048
    x, w, s = _operands(m, n, k, torch.bfloat16, cuda)
    xo = torch.empty(m * k + 4, device=cuda, dtype=x.dtype)[4:].view(m, k)
    xo.copy_(x)
    wo = torch.empty(k * n + 8, device=cuda, dtype=w.dtype)[8:].view(k, n)
    wo.copy_(w)
    assert xo.data_ptr() % 16 == 8 and wo.data_ptr() % 16 == 8
    _dequant_agrees(xo, wo, s)


@pytest.mark.parametrize("shape", SHAPES)
def test_int8_matmul_exact(cuda, shape):
    m, n, k = shape
    rng = np.random.default_rng(1)
    xq = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8)).to(cuda)
    wq = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8)).to(cuda)
    sr = torch.from_numpy(rng.uniform(1e-3, 1e-2, (m, 1)).astype(np.float32)).to(cuda)
    sc = torch.from_numpy(rng.uniform(1e-3, 1e-2, n).astype(np.float32)).to(cuda)
    acc = im.int8_matmul(xq, wq, sr, sc, out_dtype=torch.int32)
    assert torch.equal(acc, im.int8_matmul_plain(xq, wq, sr, sc, out_dtype=torch.int32))
    for dt in (torch.float32, torch.bfloat16):
        got = im.int8_matmul(xq, wq, sr, sc, out_dtype=dt)
        assert torch.equal(got, im.int8_matmul_plain(xq, wq, sr, sc, out_dtype=dt))


def test_dequant_matmul_int8_matches_plain(cuda):
    x, w, s = _operands(64, 1000, 2048, torch.bfloat16, cuda)
    before = im.launches
    got = im.dequant_matmul_int8(x, w, s)
    assert im.launches == before + 1
    xq, sr = im.quantize_rows(x)
    assert torch.equal(got, im.int8_matmul_plain(xq, w, sr, s, out_dtype=torch.bfloat16))


def test_wrappers_raise_on_bad_operands(cuda):
    x, w, s = _operands(16, 32, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        dm.dequant_matmul(x.t(), w, s)
    with pytest.raises(TypeError):
        im.int8_matmul(x, w, s[:16].reshape(16, 1), s)


# int4_matmul: (M, K, N, group) at the llama_1b decode shapes (M 8, and 1
# for a single stream; the wgmma form) and small ragged ones (M not a
# multiple of 16, several M tiles; N 32/96 and group 32 keep the mma.sync
# kernel, (8, 256, 128, 64) takes the wgmma form with two K chunks).
LLAMA_INT4 = [(2048, 1024), (2048, 2048), (2048, 5632), (5632, 2048), (2048, 32000)]  # (K, N)
INT4_SHAPES = [(8, 2048, 1024, 128), (8, 2048, 2048, 128), (8, 5632, 2048, 128),
               (8, 2048, 5632, 128), (8, 2048, 32000, 128), (1, 2048, 1024, 128),
               (1, 2048, 32000, 128), (1, 64, 32, 32), (37, 512, 96, 64), (130, 256, 128, 32),
               (8, 256, 128, 64), (37, 256, 128, 64)]


def _int4_operands(m, k, n, group, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k), np.float32)).to(device, dtype)
    w4 = rng.integers(-8, 8, (k, n), dtype=np.int8)
    pk = torch.from_numpy(pack_int4_half(w4)).to(device)
    s = torch.from_numpy(rng.uniform(1e-3, 2e-2, (k // group, n)).astype(np.float32)).to(device)
    return x, pk, s


@pytest.mark.parametrize("shape", INT4_SHAPES)
@pytest.mark.parametrize("dtype,out_dtype", [(torch.bfloat16, torch.float32),
                                             (torch.float32, torch.float32),
                                             (torch.bfloat16, torch.bfloat16)])
def test_int4_matmul_matches_plain(cuda, shape, dtype, out_dtype):
    from smelter_tpu_torch.kernels.wgmma_plan import int4_plan

    m, k, n, group = shape
    x, pk, s = _int4_operands(m, k, n, group, dtype, cuda)
    form = int4_plan(n, k, group).form
    before, forms = i4.launches, dict(i4.forms)
    got = i4.int4_matmul(x, pk, s, group=group, out_dtype=out_dtype)
    again = i4.int4_matmul(x, pk, s, group=group, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert i4.launches == before + 2 and i4.forms[form] == forms[form] + 2
    if (k, n) in LLAMA_INT4:
        assert form == "wgmma"
    ref = i4.int4_matmul_plain(x, pk, s, group=group, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert torch.equal(got, again)  # K chunks summed in a fixed order
    # f32: the same bf16 products summed in another order; a bf16 output
    # rounds both sums to 8 mantissa bits.
    tol = 1e-5 if out_dtype == torch.float32 else 1e-2
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


@pytest.mark.parametrize("m", [1, 8, 37, 130, 256])
@pytest.mark.parametrize("k,n", LLAMA_INT4)
def test_int4_matmul_rows_do_not_depend_on_the_batch(cuda, m, k, n):
    x, pk, s = _int4_operands(m, k, n, 128, torch.bfloat16, cuda, seed=3)
    before = i4.forms["wgmma"]
    full = i4.int4_matmul(x, pk, s, group=128)
    for r in sorted({0, 5 % m, m - 1}):
        one = i4.int4_matmul(x[r:r + 1].contiguous(), pk, s, group=128)
        assert torch.equal(one[0], full[r])
    assert i4.forms["wgmma"] == before + 1 + len({0, 5 % m, m - 1})


def _paged_operands(B, kvh, g, c, hd, ps, npg, quant, dtype, scale_dtype, device, seed=0):
    """Pools with foreign pages: every page not owned by a slot holds other
    values, and the table's tail past a slot's pages points anywhere."""
    rng = np.random.default_rng(seed)
    P_ = 1 + B * npg + 3
    kvd = kvh * hd
    q = torch.from_numpy(rng.standard_normal((B, kvh, g * c, hd), np.float32)).to(device, dtype)
    perm = rng.permutation(np.arange(1, P_))[: B * npg].reshape(B, npg).astype(np.int32)
    table = torch.from_numpy(perm).to(device)
    pos = torch.from_numpy(rng.integers(0, npg * ps - c + 1, B).astype(np.int64)).to(device)
    if quant:
        k = torch.from_numpy(rng.integers(-127, 128, (P_, ps, kvd), dtype=np.int8)).to(device)
        v = torch.from_numpy(rng.integers(-127, 128, (P_, ps, kvd), dtype=np.int8)).to(device)
        ks = torch.from_numpy(rng.uniform(1e-3, 2e-2, (P_, ps, 1)).astype(np.float32))
        vs = torch.from_numpy(rng.uniform(1e-3, 2e-2, (P_, ps, 1)).astype(np.float32))
        ks, vs = ks.to(device, scale_dtype), vs.to(device, scale_dtype)
    else:
        k = torch.from_numpy(rng.standard_normal((P_, ps, kvd), np.float32)).to(device, dtype)
        v = torch.from_numpy(rng.standard_normal((P_, ps, kvd), np.float32)).to(device, dtype)
        ks = vs = None
    return q, k, v, table, pos, ks, vs


# geometries (B, kvh, g, c, hd, ps, npg): llama_1b's step (32-row blocks, 4
# a page), two slots of 128-row pages (4 a page), whole pages of 32 and 16;
# then wide query-row groups and the tiny draft's head dim: llama_1b's
# chunk-5 verify (g*c 10), g*c 16 (one full group), 20 (two groups), 20 at
# hd 256 (groups of 8), and hd 32 alone and under a chunk-5 verify
@pytest.mark.parametrize("geom", [(8, 8, 2, 1, 128, 128, 4), (2, 2, 2, 1, 128, 128, 3),
                                  (3, 2, 2, 2, 128, 32, 3), (2, 4, 4, 1, 64, 16, 5),
                                  (2, 1, 2, 4, 256, 32, 2),
                                  (8, 8, 2, 5, 128, 128, 4), (2, 4, 4, 4, 128, 32, 3),
                                  (2, 2, 4, 5, 64, 16, 5), (2, 1, 4, 5, 256, 32, 2),
                                  (8, 4, 2, 1, 32, 128, 4), (2, 4, 2, 5, 32, 32, 3)])
@pytest.mark.parametrize("quant,dtype,scale_dtype", [
    (True, torch.bfloat16, torch.bfloat16), (True, torch.float32, torch.float32),
    (True, torch.bfloat16, torch.float32), (False, torch.float32, None),
    (False, torch.bfloat16, None)])
def test_paged_decode_attention_matches_plain(cuda, geom, quant, dtype, scale_dtype):
    B, kvh, g, c, hd, ps, npg = geom
    q, k, v, table, pos, ks, vs = _paged_operands(B, kvh, g, c, hd, ps, npg, quant, dtype,
                                                  scale_dtype, cuda)
    kw = dict(c=c, kv_heads=kvh, scale=hd ** -0.5)
    before = pda.launches
    got = pda.paged_decode_attention(q, k, v, table, pos, ks, vs, **kw)
    again = pda.paged_decode_attention(q, k, v, table, pos, ks, vs, **kw)
    torch.cuda.synchronize()
    assert pda.launches == before + 2
    assert torch.equal(got, again)  # partials merged in a fixed order
    ref = pda.paged_decode_attention_plain(q, k, v, table, pos, ks, vs, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    # f32: the streaming softmax sums in another order; bf16 output: 8 bits.
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


def test_paged_split_graph_replays_at_any_position(cuda):
    """A captured paged call replays right after pos moves: the split plan
    reads the shapes only."""
    B, kvh, g, c, hd, ps, npg = 2, 8, 2, 1, 128, 128, 4
    q, k, v, table, pos, ks, vs = _paged_operands(B, kvh, g, c, hd, ps, npg, True,
                                                  torch.bfloat16, torch.bfloat16, cuda, seed=9)
    kw = dict(c=c, kv_heads=kvh, scale=hd ** -0.5)
    assert pda.paged_split_plan(B, kvh, npg, ps)[0] == 32
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pda.paged_decode_attention(q, k, v, table, pos, ks, vs, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = pda.paged_decode_attention(q, k, v, table, pos, ks, vs, **kw)
    for new in ([3, 40], [280, 0], [511, 200], [31, 32]):
        pos.copy_(torch.tensor(new, dtype=torch.int64, device=cuda))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, pda.paged_decode_attention(q, k, v, table, pos, ks, vs, **kw))


def test_paged_decode_attention_reads_only_live_rows(cuda):
    """NaN past every slot's frontier and on pages it does not own changes
    nothing: the kernel never reads them."""
    B, kvh, g, c, hd, ps, npg = 4, 2, 2, 1, 128, 32, 3
    q, k, v, table, pos, ks, vs = _paged_operands(B, kvh, g, c, hd, ps, npg, False,
                                                  torch.float32, None, cuda, seed=5)
    kw = dict(c=c, kv_heads=kvh, scale=hd ** -0.5)
    ref = pda.paged_decode_attention(q, k, v, table, pos, **kw)
    live = torch.zeros(k.shape[:2], dtype=torch.bool, device=cuda)
    for b in range(B):
        for r in range(int(pos[b]) + c):
            live[table[b, r // ps], r % ps] = True
    k2 = torch.where(live[..., None], k, float("nan"))
    v2 = torch.where(live[..., None], v, float("nan"))
    got = pda.paged_decode_attention(q, k2, v2, table, pos, **kw)
    assert torch.equal(got, ref)


def test_new_wrappers_raise_on_bad_operands(cuda):
    x, pk, s = _int4_operands(8, 256, 128, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        i4.int4_matmul(x, pk[:, :96].contiguous(), s[:, :96].contiguous(), group=48)
    with pytest.raises(TypeError):
        i4.int4_matmul(x.half(), pk, s, group=64)
    q, k, v, table, pos, ks, vs = _paged_operands(2, 2, 2, 1, 96, 16, 2, True,
                                                  torch.bfloat16, torch.bfloat16, cuda)
    with pytest.raises(ValueError):  # head dim 96 is not taken
        pda.paged_decode_attention(q, k, v, table, pos, ks, vs, c=1, kv_heads=2, scale=0.1)


# -- ragged_decode_attention -------------------------------------------------

def _ragged_operands(B, kvh, g, c, hd, L, quant, dtype, scale_dtype, device, seed=0,
                     pos=None):
    """Caches full of values in every row, positions anywhere a chunk of c
    fits (or the given ones)."""
    rng = np.random.default_rng(seed)
    kvd = kvh * hd
    q = torch.from_numpy(rng.standard_normal((B, kvh, g * c, hd), np.float32)).to(device, dtype)
    if pos is None:
        pos = rng.integers(0, L - c + 1, B)
    pos = torch.as_tensor(np.asarray(pos, np.int64)).to(device)
    if quant:
        k = torch.from_numpy(rng.integers(-127, 128, (B, L, kvd), dtype=np.int8)).to(device)
        v = torch.from_numpy(rng.integers(-127, 128, (B, L, kvd), dtype=np.int8)).to(device)
        ks = torch.from_numpy(rng.uniform(1e-3, 2e-2, (B, L, 1)).astype(np.float32))
        vs = torch.from_numpy(rng.uniform(1e-3, 2e-2, (B, L, 1)).astype(np.float32))
        ks, vs = ks.to(device, scale_dtype), vs.to(device, scale_dtype)
    else:
        k = torch.from_numpy(rng.standard_normal((B, L, kvd), np.float32)).to(device, dtype)
        v = torch.from_numpy(rng.standard_normal((B, L, kvd), np.float32)).to(device, dtype)
        ks = vs = None
    return q, k, v, pos, ks, vs


def _ragged_check(q, k, v, pos, ks, vs, c, kvh, hd):
    from smelter_tpu_torch.kernels import ragged_decode_attention as rda

    kw = dict(c=c, kv_heads=kvh, scale=hd ** -0.5)
    before = rda.launches
    got = rda.ragged_decode_attention(q, k, v, pos, ks, vs, **kw)
    torch.cuda.synchronize()
    assert rda.launches == before + 1
    ref = rda.ragged_decode_attention_reference(q, k, v, pos, ks, vs, **kw)
    assert got.dtype == q.dtype and got.shape == q.shape
    # f32: the streaming softmax sums in another order; bf16 output: 8 bits.
    tol = 1e-5 if q.dtype == torch.float32 else 1e-2
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err
    return got


# (B, kvh, g, c, hd, L); the last six: the paged test's wide groups and hd 32
@pytest.mark.parametrize("geom", [(8, 8, 2, 1, 128, 512), (3, 2, 1, 5, 128, 64),
                                  (2, 4, 4, 2, 64, 100), (2, 1, 2, 4, 256, 300),
                                  (1, 8, 1, 5, 128, 512),
                                  (8, 8, 2, 5, 128, 512), (2, 4, 4, 4, 128, 300),
                                  (2, 2, 4, 5, 64, 300), (2, 1, 4, 5, 256, 300),
                                  (8, 4, 2, 1, 32, 512), (2, 4, 2, 5, 32, 300)])
@pytest.mark.parametrize("quant,dtype,scale_dtype", [
    (True, torch.bfloat16, torch.bfloat16), (True, torch.float32, torch.float32),
    (True, torch.bfloat16, torch.float32), (False, torch.float32, None),
    (False, torch.bfloat16, None)])
def test_ragged_decode_attention_matches_plain(cuda, geom, quant, dtype, scale_dtype):
    B, kvh, g, c, hd, L = geom
    ops = _ragged_operands(B, kvh, g, c, hd, L, quant, dtype, scale_dtype, cuda)
    _ragged_check(*ops, c, kvh, hd)


@pytest.mark.parametrize("c", [1, 5])
def test_ragged_decode_attention_long_cache(cuda, c):
    """L 4096: the kernel walks 32 row blocks; shared memory does not grow."""
    B, kvh, g, hd, L = 3, 8, 8 // c if c < 8 else 1, 128, 4096
    ops = _ragged_operands(B, kvh, g, c, hd, L, True, torch.bfloat16, torch.bfloat16, cuda,
                           seed=2, pos=[0, 2048 + 77, L - c])
    _ragged_check(*ops, c, kvh, hd)
    ops = _ragged_operands(B, kvh, g, c, hd, L, False, torch.float32, None, cuda, seed=3,
                           pos=[L - c, 1000, 127])
    _ragged_check(*ops, c, kvh, hd)


@pytest.mark.parametrize("c", [1, 3])
def test_ragged_decode_attention_reads_only_live_rows(cuda, c):
    """NaN in every row past a slot's frontier (K, V and their scales)
    changes nothing: the kernel never reads them."""
    from smelter_tpu_torch.kernels import ragged_decode_attention as rda

    B, kvh, g, hd, L = 4, 2, 2, 128, 300
    for quant, dtype, sd in ((False, torch.float32, None), (True, torch.bfloat16, torch.float32)):
        q, k, v, pos, ks, vs = _ragged_operands(B, kvh, g, c, hd, L, quant, dtype, sd, cuda,
                                                seed=5, pos=[0, 127, 128, L - c])
        kw = dict(c=c, kv_heads=kvh, scale=hd ** -0.5)
        ref = rda.ragged_decode_attention(q, k, v, pos, ks, vs, **kw)
        stale = torch.arange(L, device=cuda)[None] > (pos + c - 1)[:, None]  # (B, L)
        if quant:
            k2, v2 = k.clone(), v.clone()  # int8 has no NaN: the scales carry it
            ks2 = torch.where(stale[..., None], float("nan"), ks)
            vs2 = torch.where(stale[..., None], float("nan"), vs)
        else:
            k2 = torch.where(stale[..., None], float("nan"), k)
            v2 = torch.where(stale[..., None], float("nan"), v)
            ks2 = vs2 = None
        got = rda.ragged_decode_attention(q, k2, v2, pos, ks2, vs2, **kw)
        assert torch.equal(got, ref)


# The split kernel at the decode paths' shapes (llama_1b: 8 KV heads, hd
# 128, int8 caches, bf16 q): (label, B, g, c, L, positions)
RAGGED_PATH_CASES = [
    ("b8_l512", 8, 4, 1, 512, [0, 73, 127, 128, 292, 365, 438, 511]),
    ("c5_b1_pos511", 1, 1, 5, 512, [511]),
    ("b8_l4096", 8, 4, 1, 4096, [0, 584, 1016, 1024, 2336, 2920, 3504, 4095]),
    ("b1_l512_pos280", 1, 4, 1, 512, [280]),
]


@pytest.mark.parametrize("case", RAGGED_PATH_CASES, ids=[c[0] for c in RAGGED_PATH_CASES])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ragged_split_at_the_path_shapes(cuda, case, dtype):
    """Against the plain version with NaN in every row past each frontier
    (the scales carry it for int8), bit-equal from call to call, and equal
    to the call on clean caches."""
    from smelter_tpu_torch.kernels import ragged_decode_attention as rda

    _, B, g, c, L, pos = case
    kvh, hd = 8, 128
    q, k, v, pos, ks, vs = _ragged_operands(B, kvh, g, c, hd, L, True, dtype, dtype, cuda,
                                            seed=11, pos=pos)
    clean = _ragged_check(q, k, v, pos, ks, vs, c, kvh, hd)
    stale = torch.arange(L, device=cuda)[None] > (pos + c - 1)[:, None]
    ks2 = torch.where(stale[..., None], float("nan"), ks)
    vs2 = torch.where(stale[..., None], float("nan"), vs)
    kw = dict(c=c, kv_heads=kvh, scale=hd ** -0.5)
    got = rda.ragged_decode_attention(q, k, v, pos, ks2, vs2, **kw)
    again = rda.ragged_decode_attention(q, k, v, pos, ks2, vs2, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got, clean)


def test_ragged_split_graph_replays_at_any_position(cuda):
    """A CUDA graph of one call, captured at one position and replayed after
    pos changes in place (as FusedGenerator replays its step), equals an
    eager call at the new positions: the grid does not depend on pos."""
    from smelter_tpu_torch.kernels import ragged_decode_attention as rda

    B, kvh, g, c, hd, L = 2, 8, 4, 1, 128, 512
    q, k, v, pos, ks, vs = _ragged_operands(B, kvh, g, c, hd, L, True, torch.bfloat16,
                                            torch.bfloat16, cuda, seed=12, pos=[3, 40])
    kw = dict(c=c, kv_heads=kvh, scale=hd ** -0.5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rda.ragged_decode_attention(q, k, v, pos, ks, vs, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = rda.ragged_decode_attention(q, k, v, pos, ks, vs, **kw)
    for new in ([3, 40], [280, 0], [511, 200], [31, 32]):
        pos.copy_(torch.tensor(new, dtype=torch.int64, device=cuda))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, rda.ragged_decode_attention(q, k, v, pos, ks, vs, **kw)), new


@pytest.mark.parametrize("hd", [32, 128, 256])
def test_decode_attention_rows_do_not_depend_on_their_group(cuda, hd):
    """A query row's output is bit-equal whether its block holds 2, 6, 10,
    16 or 20 rows: every row's sums run in one order at every group size,
    so a chunk verify gives what single steps give."""
    from smelter_tpu_torch.kernels import ragged_decode_attention as rda

    B, kvh, L = 3, 2, 512
    q, k, v, pos, ks, vs = _ragged_operands(B, kvh, 20, 1, hd, L, True, torch.float32,
                                            torch.float32, cuda, seed=23, pos=[0, 301, 511])
    kw = dict(c=1, kv_heads=kvh, scale=hd ** -0.5)
    full = rda.ragged_decode_attention(q, k, v, pos, ks, vs, **kw)
    for gc in (2, 6, 10, 16):
        part = rda.ragged_decode_attention(q[:, :, :gc].contiguous(), k, v, pos, ks, vs, **kw)
        assert torch.equal(part, full[:, :, :gc]), gc


def test_vmap_rules_launch_once_for_all_slots(cuda):
    """torch.func.vmap of a per-slot call over 5 slots launches each kernel
    once (the vmap rules fold the slot axis), with the per-slot results."""
    from smelter_tpu_torch.kernels import ragged_decode_attention as rda

    S, kvh, g, hd, L = 5, 2, 2, 128, 200
    q, k, v, pos, ks, vs = _ragged_operands(S, kvh, g, 1, hd, L, True, torch.bfloat16,
                                            torch.bfloat16, cuda, seed=7)
    x, pk, s = _int4_operands(S, 256, 128, 64, torch.bfloat16, cuda, seed=8)
    kw = dict(c=1, kv_heads=kvh, scale=hd ** -0.5)

    def one(q1, k1, v1, p1, ks1, vs1, x1):
        att = rda.ragged_decode_attention(q1[None], k1[None], v1[None], p1.reshape(1),
                                          ks1[None], vs1[None], **kw)[0]
        return att, i4.int4_matmul(x1[None], pk, s, group=64, out_dtype=torch.bfloat16)[0]

    before = (rda.launches, i4.launches)
    att, mm = torch.func.vmap(one)(q, k, v, pos, ks, vs, x)
    torch.cuda.synchronize()
    assert (rda.launches, i4.launches) == (before[0] + 1, before[1] + 1)
    for b in range(S):
        a1, m1 = one(q[b], k[b], v[b], pos[b], ks[b], vs[b], x[b])
        assert torch.equal(att[b], a1) and torch.equal(mm[b], m1)


def _small_llama(kv_quant=True):
    """A 2-layer llama at the int4 gates (dim 256, hd 128), int4-g64 weights."""
    from smelter_tpu_torch.models import llama_style as ls
    from smelter_tpu_torch.passes.pass_manager import run_passes
    from smelter_tpu_torch.quant import quantize_weights

    cfg = dict(vocab=256, dim=256, heads=2, kv_heads=1, ffn=512, layers=2)
    w = ls.make_weights(**cfg, max_len=128, seed=1)

    def q(g):
        quantize_weights(g, "int4-g64", min_elements=1024)
        run_passes(g, ["fuse_dequant_matmul", "dce"])
        return g

    step = q(ls.build_decode_step(w, **cfg, max_len=128, kv_quant=kv_quant)[0])
    pf = q(ls.build_prefill(w, prompt_len=16, max_len=128, kv_quant=kv_quant, **cfg))
    return step, pf


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_generator_graph_matches_generator(cuda, dtype):
    """The CUDA-graph generator gives the host loop's greedy tokens; a
    seeded sampled run repeats; the graph is captured once."""
    import smelter_tpu_torch as stt
    from smelter_tpu_torch.runtime.generate import FusedGenerator, Generator

    step, pf = _small_llama()
    cfg = stt.Config(compute_dtype=dtype, ragged_attention=True)
    prompt = [3, 17, 99, 4, 250, 61, 8]
    want = Generator(step, cfg).generate(prompt, 40)
    gen = FusedGenerator(step, cfg, prefill_graph=[pf])
    assert gen.generate(prompt, 40) == want
    assert gen.generate(prompt[:3], 20) == Generator(step, cfg).generate(prompt[:3], 20)
    assert list(gen.step_launches) == ["greedy"] and gen.step_launches["greedy"] == {
        "int4_matmul": 15, "ragged_decode_attention": 2}
    p16 = list(range(5, 21))  # takes the prefill graph
    assert len(gen.generate(p16, 10)) == 26
    a = gen.generate(prompt, 12, temperature=0.8, top_k=20, seed=4)
    assert a == gen.generate(prompt, 12, temperature=0.8, top_k=20, seed=4)
    assert len(gen._graphs) == 2


# -- layer_norm (fused_layer_norm, residual_layer_norm) -----------------------

def _ln_operands(M, D, dtype, p_dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    x, skip = (torch.from_numpy(rng.standard_normal((M, D), np.float32) * 2 + 0.5).to(device, dtype)
               for _ in range(2))
    g = torch.from_numpy(rng.standard_normal(D).astype(np.float32) * 0.1 + 1).to(device, p_dtype)
    b = torch.from_numpy(rng.standard_normal(D).astype(np.float32) * 0.1).to(device, p_dtype)
    return x, skip, g, b


@pytest.mark.parametrize("M,D", [(8, 128), (24, 768), (1576, 768), (16, 1024), (8, 4096),
                                 (197, 768), (12, 96), (5, 100)])
@pytest.mark.parametrize("dtype,p_dtype", [(torch.bfloat16, torch.float32),
                                           (torch.bfloat16, torch.bfloat16),
                                           (torch.float16, torch.float32),
                                           (torch.float32, torch.float32)])
def test_layer_norm_matches_plain(cuda, M, D, dtype, p_dtype):
    from smelter_tpu_torch.kernels import layer_norm as ln

    x, skip, g, b = _ln_operands(M, D, dtype, p_dtype, cuda)
    before = (ln.fused_launches, ln.residual_launches)
    y = ln.fused_layer_norm(x, g, b, eps=1e-6)
    s, y2 = ln.residual_layer_norm(x, skip, g, b, eps=1e-6)
    torch.cuda.synchronize()
    assert (ln.fused_launches, ln.residual_launches) == (before[0] + 1, before[1] + 1)
    s_ref, y2_ref = ln.residual_layer_norm_plain(x, skip, g, b, eps=1e-6)
    assert torch.equal(s, s_ref)  # the carry: one rounding of an exact f32 sum
    # f32: statistics summed in another order; 16-bit: one output rounding.
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for got, ref in ((y, ln.layer_norm_plain(x, g, b, eps=1e-6)), (y2, y2_ref)):
        assert got.dtype == dtype and got.shape == x.shape
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= tol * ref.float().abs().max().item(), err


def test_layer_norm_shape_rule_and_bad_operands(cuda):
    """Outside the JAX entry points' tiling rule (D % 128, rows % 8) a CUDA
    tensor still launches the kernel; rows the kernel takes not raise."""
    from smelter_tpu_torch.kernels import layer_norm as ln

    x, skip, g, b = _ln_operands(197, 96, torch.bfloat16, torch.float32, cuda)
    before = (ln.fused_launches, ln.residual_launches)
    y = ln.fused_layer_norm(x[1:], g, b)  # a row-offset view: 8-byte aligned rows
    ln.residual_layer_norm(x, skip, g, b)
    assert (ln.fused_launches, ln.residual_launches) == (before[0] + 1, before[1] + 1)
    ref = ln.layer_norm_plain(x[1:], g, b)
    assert (y.float() - ref.float()).abs().max().item() <= 1e-2 * ref.float().abs().max().item()
    for D in (98, 8192):
        x, skip, g, b = _ln_operands(8, D, torch.bfloat16, torch.float32, cuda)
        with pytest.raises(ValueError):
            ln.fused_layer_norm(x, g, b)
        with pytest.raises(ValueError):
            ln.residual_layer_norm(x, skip, g, b)
    x, skip, g, b = _ln_operands(16, 256, torch.bfloat16, torch.float32, cuda)
    with pytest.raises(ValueError):
        ln.residual_layer_norm(x, skip[:1], g, b)
    with pytest.raises(TypeError):
        ln.fused_layer_norm(x, g, b.half())
    with pytest.raises(TypeError):
        ln.residual_layer_norm(x, skip.float(), g, b)
    assert (ln.fused_launches, ln.residual_launches) == (before[0] + 1, before[1] + 1)


# -- vit_attention_block -----------------------------------------------------

def _vit_operands(B, N, D, H, dtype, device, p_dtype=torch.float32, seed=0):
    """The JAX test's operands (tests/test_vit_block.py), packed per head
    group as passes/vit_block.py packs them."""
    from smelter_tpu_torch.passes.vit_block import pack_qkv_weights

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, D)).astype(np.float32) * 0.5
    g = (rng.standard_normal(D) * 0.1 + 1).astype(np.float32)
    b = (rng.standard_normal(D) * 0.1).astype(np.float32)
    wqkv = (rng.standard_normal((D, 3 * D)) / np.sqrt(D)).astype(np.float32)
    bqkv = (rng.standard_normal(3 * D) * 0.02).astype(np.float32)
    wp = (rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32)
    bp = (rng.standard_normal(D) * 0.02).astype(np.float32)
    wpk, bpk = pack_qkv_weights(wqkv, bqkv, H)

    def t(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)

    return (t(x, dtype), t(g, p_dtype), t(b, p_dtype), t(wpk, dtype), t(bpk, p_dtype),
            t(wp, dtype), t(bp, p_dtype))


def _masks(B, N, device, seed=1):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, N + 1, B).astype(np.int32)
    keep = (np.arange(N)[None] < lens[:, None]).astype(np.float32)
    keep[:, 0] = 1.0
    return {"keep2d": torch.from_numpy(keep).to(device),
            "len1d": torch.from_numpy(lens).to(device)}


def _vit_check(args, mask=None, **kw):
    from smelter_tpu_torch.kernels import vit_block as vb

    before = vb.launches
    got = vb.vit_attention_block(*args, mask, **kw)
    torch.cuda.synchronize()
    assert vb.launches == before + 1
    ref = vb.vit_attention_block_plain(*args, mask, **kw)
    assert got.dtype == args[0].dtype and got.shape == args[0].shape
    # f32: every product in full f32, summed in another order; 16-bit: q, k,
    # v, p and the outputs round to 8 or 11 bits after sums in other orders.
    tol = 1e-5 if got.dtype == torch.float32 else 1e-2
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


# (B, N, D, H): the JAX test's cases, ViT-B/16's block, hd 128 over more
# keys than a chunk, hd 16, and hd 48 (the warp-per-row attention kernel);
# SD-UNet's two blocks at batch 8: hd 16 in one head group of 8 (group width
# 128) over 1024 tokens, and hd 32 over 256
VIT_GEOMS = [(2, 197, 128, 4), (1, 64, 128, 2), (2, 50, 192, 6), (2, 197, 768, 12),
             (1, 300, 512, 4), (2, 33, 256, 16), (1, 20, 96, 2), (8, 1024, 128, 8),
             (8, 256, 256, 8)]


@pytest.mark.parametrize("geom", VIT_GEOMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_vit_attention_block_matches_plain(cuda, geom, dtype):
    B, N, D, H = geom
    _vit_check(_vit_operands(B, N, D, H, dtype, cuda), heads=H, eps=1e-6)


@pytest.mark.parametrize("geom", [(2, 197, 128, 4), (2, 50, 192, 6)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("form", ["no_ln", "keep2d", "len1d", "residual", "scale", "bf16_params"])
def test_vit_attention_block_forms(cuda, geom, dtype, form):
    B, N, D, H = geom
    p_dtype = dtype if form == "bf16_params" else torch.float32
    args = _vit_operands(B, N, D, H, dtype, cuda, p_dtype=p_dtype)
    kw = dict(heads=H, eps=1e-6)
    mask = _masks(B, N, cuda).get(form)
    if form == "no_ln":
        kw["pre_ln"] = False
    elif form == "residual":
        kw["residual"] = True
    elif form == "scale":
        kw["scale"] = 0.3
    _vit_check(args, mask, **kw)


# The attention core's forms (kernels/attention_plan.py): one pass over one
# or two 128-key tiles (N <= 256), two passes over more resident tiles, and
# today's kernel past shared memory (hd 64 at N 1,024, hd 128 at N 577 and
# 1,024), at every head dim; the projections on gemm_tma (M >= 128) or
# gemm.cuh (N 1 and 63: M < 128).
# (heads, D) a head dim: group widths of 128, as SD-UNet's and ViT's.
CORE_HEADS = {16: (8, 128), 32: (4, 128), 64: (2, 128), 128: (2, 256)}
CORE_NS = [1, 63, 64, 65, 197, 256, 257, 577, 1024]


@pytest.mark.parametrize("hd", sorted(CORE_HEADS))
@pytest.mark.parametrize("N", CORE_NS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_vit_attention_block_core_forms(cuda, hd, N, dtype):
    """Each of pre_ln 0/1, residual 0/1 and no mask, keep flags or valid
    lengths against the plain version (1e-2 x max|plain|)."""
    H, D = CORE_HEADS[hd]
    args = _vit_operands(2, N, D, H, dtype, cuda)
    masks = _masks(2, N, cuda)
    for pre_ln in (True, False):
        for residual in (False, True):
            for mask in (None, masks["keep2d"], masks["len1d"]):
                _vit_check(args, mask, heads=H, eps=1e-6, pre_ln=pre_ln, residual=residual)


@pytest.mark.parametrize("geom", [(2, 197, 768, 12), (8, 256, 256, 8), (2, 300, 512, 4)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("p_dtype", ["f32", "x"])
@pytest.mark.parametrize("residual", [False, True])
def test_vit_attention_block_gemm_epilogue(cuda, geom, dtype, p_dtype, residual):
    """gemm_tma's block epilogue with an f32 and a 16-bit bias, with and
    without the residual (x + (acc + b), one rounding)."""
    B, N, D, H = geom
    from smelter_tpu_torch.kernels import vit_block as vb

    assert [p.form for p in vb.plans(B, N, D, H, dtype)[:2]] == ["tma", "tma"]
    args = _vit_operands(B, N, D, H, dtype, cuda, p_dtype=torch.float32 if p_dtype == "f32"
                         else dtype)
    _vit_check(args, heads=H, eps=1e-6, residual=residual)


def test_vit_attention_block_raises_on_bad_operands(cuda):
    from smelter_tpu_torch.kernels import vit_block as vb

    x, g, b, wpk, bpk, wp, bp = _vit_operands(1, 16, 128, 4, torch.bfloat16, cuda)
    with pytest.raises(TypeError):  # weights not in x's dtype
        vb.vit_attention_block(x, g, b, wpk.float(), bpk, wp, bp, heads=4)
    with pytest.raises(TypeError):  # params of mixed dtypes
        vb.vit_attention_block(x, g.bfloat16(), b, wpk, bpk, wp, bp, heads=4)
    with pytest.raises(ValueError):  # a projection of another width
        vb.vit_attention_block(x, g, b, wpk, bpk, wp[:64], bp, heads=4)
    with pytest.raises(TypeError):  # a mask of the wrong dtype
        vb.vit_attention_block(x, g, b, wpk, bpk, wp, bp, torch.ones(1, 16, device=cuda,
                                                                     dtype=torch.int64),
                               heads=4)


# -- pixel_conv_rowdot, pixel_conv_rowdot_q (ESRGAN) ---------------------------

# (B, H, C_in, W, C_out): ESRGAN's trunk and tail shapes at batch 1, and
# ragged edges: H not a multiple of the 2-row block, W not a multiple of the
# 128-pixel tile or of the 16-byte vector, C_in not a multiple of the
# channel chunk or of the vector, C_out not a multiple of 16, or above 64.
PIXEL_SHAPES = [(1, 128, 64, 128, 32), (1, 128, 192, 128, 64), (1, 16, 64, 512, 64),
                (2, 7, 16, 100, 8), (1, 9, 40, 131, 24), (2, 5, 24, 37, 72), (1, 3, 5, 7, 3)]


def _pixel_operands(B, H, Cin, W, Cout, device, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, Cin, W), np.float32)
    w = (rng.standard_normal((Cout, Cin, 3, 3)) / (3 * np.sqrt(Cin))).astype(np.float32)
    b = rng.standard_normal(Cout).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (x, w, b))


@pytest.mark.parametrize("shape", PIXEL_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("alpha", [None, 0.2])
def test_pixel_conv_rowdot_matches_plain(cuda, shape, dtype, alpha):
    from smelter_tpu_torch.kernels import pixel_conv as pc

    torch.backends.cudnn.allow_tf32 = False  # the plain version's conv in full f32
    x, w, b = _pixel_operands(*shape, cuda)
    x = x.to(dtype)
    before = pc.launches
    got = pc.pixel_conv_rowdot(x, w, b, alpha=alpha)
    torch.cuda.synchronize()
    assert pc.launches == before + 1
    ref = pc.pixel_conv_rowdot_plain(x, w, b, alpha=alpha)
    assert got.dtype == dtype and got.shape == ref.shape
    # f32: the same products summed in other orders -> 1e-5 of the largest
    # output; bf16/f16: f32 sums in other orders, each rounded once to 8/11
    # mantissa bits -> 1e-2 / 2e-3 of the largest output.
    tol = {torch.bfloat16: 1e-2, torch.float16: 2e-3, torch.float32: 1e-5}[dtype]
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


def test_pixel_conv_rowdot_packed_weight_and_low_precision_bias(cuda):
    """The executor's operands: the weight as an OIHW view over the kernel's
    [3, 3, C_out, C_in] buffer (weights.py), the bias in x's dtype."""
    from smelter_tpu_torch.kernels import pixel_conv as pc

    x, w, b = _pixel_operands(2, 16, 96, 128, 32, cuda, seed=3)
    x, w, b = x.bfloat16(), w.bfloat16(), b.bfloat16()
    packed = w.permute(2, 3, 0, 1).contiguous().permute(2, 3, 0, 1)
    got = pc.pixel_conv_rowdot(x, packed, b, alpha=0.2)
    assert torch.equal(got, pc.pixel_conv_rowdot(x, w, b, alpha=0.2))
    ref = pc.pixel_conv_rowdot_plain(x, w, b, alpha=0.2)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 1e-2 * ref.float().abs().max().item(), err


@pytest.mark.parametrize("shape", PIXEL_SHAPES)
@pytest.mark.parametrize("requant,out_dtype", [(True, torch.int8), (False, torch.bfloat16),
                                               (False, torch.float32)])
def test_pixel_conv_rowdot_q_equals_plain(cuda, shape, requant, out_dtype):
    """Exact int32 sums and the same epilogue roundings: equal outputs."""
    from smelter_tpu_torch.kernels import pixel_conv as pc

    B, H, Cin, W, Cout = shape
    rng = np.random.default_rng(1)
    xq = torch.from_numpy(rng.integers(-127, 128, (B, H, Cin, W), dtype=np.int8)).to(cuda)
    wq = torch.from_numpy(rng.integers(-127, 128, (Cout, Cin, 3, 3), dtype=np.int8)).to(cuda)
    sc = torch.from_numpy(rng.uniform(1e-4, 1e-3, Cout).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(rng.standard_normal(Cout).astype(np.float32)).to(cuda)
    for alpha in (None, 0.2):
        kw = dict(alpha=alpha, inv_sy=5.0, requant=requant, out_dtype=out_dtype)
        before = pc.q_launches
        got = pc.pixel_conv_rowdot_q(xq, wq, sc, bias, **kw)
        torch.cuda.synchronize()
        assert pc.q_launches == before + 1
        ref = pc.pixel_conv_rowdot_q_plain(xq, wq, sc, bias, **kw)
        assert got.dtype == out_dtype and torch.equal(got, ref)


def test_pixel_conv_rowdot_q_sums_past_f32_integers(cuda):
    """Sums beyond 2^24 (all 127s at C_in 192) convert to f32 as the plain
    version's do."""
    from smelter_tpu_torch.kernels import pixel_conv as pc

    xq = torch.full((1, 4, 192, 128), 127, dtype=torch.int8, device=cuda)
    wq = torch.full((64, 192, 3, 3), 127, dtype=torch.int8, device=cuda)
    sc = torch.full((64,), 1.0, device=cuda)
    bias = torch.zeros(64, device=cuda)
    kw = dict(requant=False, out_dtype=torch.float32)
    got = pc.pixel_conv_rowdot_q(xq, wq, sc, bias, **kw)
    assert got.max().item() == 127 * 127 * 9 * 192
    assert torch.equal(got, pc.pixel_conv_rowdot_q_plain(xq, wq, sc, bias, **kw))


# -- pixel_conv_rowdot_q's int8 wgmma form -------------------------------------------

# (B, H, C_in, W, C_out): ESRGAN x4's eight PixelConv shapes at batch 2, then
# edges of the int8 form (a ragged row block and pixel tile, the smallest
# boxes, C_in past the last 32-channel step, a resident weight whose last
# chunk is half zeros) and shapes the plan keeps on mma.sync (W 80 and 72,
# H 5, C_in 24, C_out 48)
Q_ESRGAN = [(2, 128, 64 + 32 * i, 128, 32 if i < 4 else 64) for i in range(5)] + [
    (2, s, 64, s, 64) for s in (128, 256, 512)]
Q_EDGES = [(2, 7, 48, 112, 32), (1, 6, 32, 96, 64), (1, 9, 208, 160, 32), (3, 10, 64, 144, 64),
           (2, 8, 96, 80, 32), (1, 8, 64, 72, 32), (1, 5, 64, 128, 64), (2, 8, 24, 128, 32),
           (1, 8, 64, 128, 48)]
Q_OUTS = {"int8": (True, torch.int8), "bf16": (False, torch.bfloat16),
          "f16": (False, torch.float16), "f32": (False, torch.float32)}


def _q_operands(B, H, Cin, W, Cout, device, seed=0):
    """int8 x and w (the executor's layout: an OIHW view of the packed
    [3][3][C_out][C_in] weight), per-channel scales and an f32 bias."""
    rng = np.random.default_rng(seed)
    xq = torch.from_numpy(rng.integers(-127, 128, (B, H, Cin, W), dtype=np.int8)).to(device)
    wq = torch.from_numpy(rng.integers(-127, 128, (Cout, Cin, 3, 3), dtype=np.int8)).to(device)
    wq = wq.permute(2, 3, 0, 1).contiguous().permute(2, 3, 0, 1)
    sc = torch.from_numpy((rng.uniform(1e-4, 1e-3, Cout) / np.sqrt(Cin)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(Cout).astype(np.float32))
    return xq, wq, sc.to(device), bias.to(device)


# int8 and bf16 out everywhere, f16 and f32 out at the first ESRGAN shape and the edges
Q_CASES = [(shape, out) for shape in Q_ESRGAN + Q_EDGES for out in Q_OUTS
           if out in ("int8", "bf16") or shape not in Q_ESRGAN[1:]]


@pytest.mark.parametrize("shape,out", Q_CASES)
def test_pixel_conv_rowdot_q_forms_equal_plain(cuda, shape, out):
    """Both forms, each out type, LeakyReLU and linear: outputs equal to the
    plain version's and from call to call; the plan takes the int8 wgmma
    form exactly where its boxes and strides can read the maps (int8 or
    16-bit out)."""
    from smelter_tpu_torch.kernels import pixel_conv as pc

    B, H, C, W, co = shape
    requant, out_dtype = Q_OUTS[out]
    xq, wq, sc, bias = _q_operands(*shape, cuda, seed=C + W)
    form = pc.plan(xq, wq, out_dtype=out_dtype).form
    assert form == ("wgmma" if co in (32, 64) and W % 16 == 0 and W >= 96 and H >= 6
                    and C % 16 == 0 and C >= 32 and out != "f32" else "mma"), form
    for alpha in (None, 0.2):
        kw = dict(alpha=alpha, inv_sy=40.0, requant=requant, out_dtype=out_dtype)
        before = pc.q_launches
        got = pc.pixel_conv_rowdot_q(xq, wq, sc, bias, **kw)
        again = pc.pixel_conv_rowdot_q(xq, wq, sc, bias, **kw)
        torch.cuda.synchronize()
        assert pc.q_launches == before + 2
        ref = pc.pixel_conv_rowdot_q_plain(xq, wq, sc, bias, **kw)
        assert got.dtype == out_dtype and torch.equal(got, ref) and torch.equal(got, again)
        if requant:
            assert torch.unique(got).numel() > 50  # the requant's levels are in use


def test_wgmma_forms_raise_rather_than_fall_back(cuda):
    """A launch its form cannot take raises and writes nothing: the int8
    conv's wgmma plan on an x one byte off a 16-byte boundary (no tensor map
    takes it) or with f32 out (no such form), and mlp_block's tma plans on
    an x two bytes off."""
    from smelter_tpu_torch.kernels import mlp_block as mb
    from smelter_tpu_torch.kernels import pixel_conv as pc

    xq, wq, sc, bias = _q_operands(1, 8, 64, 128, 32, cuda)
    p = pc.plan(xq, wq, out_dtype=torch.int8)
    assert p.form == "wgmma"
    buf = torch.zeros(xq.numel() + 1, dtype=torch.int8, device=cuda)
    x_off = buf[1:].view(xq.shape)
    x_off.copy_(xq)
    wp = pc._packed_weight(wq)
    for x, out_dtype in ((x_off, torch.int8), (xq, torch.float32)):
        out = torch.full((1, 8, 32, 128), 7, dtype=out_dtype, device=cuda)
        with pytest.raises(RuntimeError):
            pc._launch(x, wp, bias, sc, out, 0.2, 1.0, out_dtype == torch.int8, p=p)
        torch.cuda.synchronize()
        assert (out == 7).all()
    args = _mlp_operands_gpu(1, 197, 768, 3072, torch.bfloat16, cuda)
    forms = mb.plans(197, 768, 3072, torch.bfloat16)
    assert [f.form for f in forms] == ["tma", "tma"]
    xb = torch.zeros(args[0].numel() + 1, dtype=torch.bfloat16, device=cuda)
    x_off = xb[1:].view(args[0].shape)
    with pytest.raises(RuntimeError):
        mb._launch(x_off, *args[1:], forms, eps=1e-6, approximate=False, residual=True,
                   pre_ln=True)


# -- the wgmma forms of int8_matmul and pixel_conv_rowdot ---------------------------

# int8_plan's test shapes (M, N, K): the tma form where the plan takes it
# (aligned strides, 128-row boxes, tiles enough), the cluster form elsewhere
INT8_FORM_SHAPES = [(m, n, k) for m in (1, 17, 128, 129, 8192) for n in (8, 16, 1000, 4096)
                    for k in (16, 32, 100, 2048)] + [(8192, 4096, 4096), (2000, 1040, 272)]


def _int8_operands(m, n, k, device, seed=0):
    rng = np.random.default_rng(seed)
    xq = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8)).to(device)
    wq = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8)).to(device)
    sr = torch.from_numpy(rng.uniform(1e-3, 1e-2, (m, 1)).astype(np.float32)).to(device)
    sc = torch.from_numpy(rng.uniform(1e-3, 1e-2, n).astype(np.float32)).to(device)
    return xq, wq, sr, sc


def _int8_equal_in_every_dtype(xq, wq, sr, sc):
    for dt in (torch.int32, torch.float32, torch.bfloat16, torch.float16):
        before = im.launches
        got = im.int8_matmul(xq, wq, sr, sc, out_dtype=dt)
        torch.cuda.synchronize()
        assert im.launches == before + 1
        assert got.dtype == dt and torch.equal(got, im.int8_matmul_plain(xq, wq, sr, sc,
                                                                          out_dtype=dt)), dt


@pytest.mark.parametrize("shape", INT8_FORM_SHAPES)
def test_int8_matmul_forms_equal_plain(cuda, shape):
    """Exact int32 sums and the same two f32 multiplies: bit-equal to the
    plain version in every output type, in the form int8_plan picks."""
    m, n, k = shape
    xq, wq, sr, sc = _int8_operands(m, n, k, cuda, seed=m + n + k)
    p = im.plan(xq, wq)
    assert p.form == ("tma" if (k % 16 == 0 and n % 16 == 0 and min(m, n, k) >= 128
                                and -(-m // 128) * -(-n // 128) >= 66) else "cluster")
    _int8_equal_in_every_dtype(xq, wq, sr, sc)


def test_int8_matmul_unaligned_bases_take_the_cluster_form(cuda):
    """Bases 8 bytes off a 16-byte boundary: no TMA map; the cluster form
    with byte loads of x's rows and 4-byte loads of W's."""
    m, n, k = 2048, 4096, 2048
    xq, wq, sr, sc = _int8_operands(m, n, k, cuda)
    xo = torch.empty(m * k + 8, device=cuda, dtype=torch.int8)[8:].view(m, k)
    xo.copy_(xq)
    wo = torch.empty(k * n + 8, device=cuda, dtype=torch.int8)[8:].view(k, n)
    wo.copy_(wq)
    assert xo.data_ptr() % 16 == 8 and im.plan(xo, wo).form == "cluster"
    assert im.plan(xq, wq).form == "tma"
    _int8_equal_in_every_dtype(xo, wo, sr, sc)


# pixel_conv_rowdot at PIXEL_SHAPES plus C_in 96 and 160 and ESRGAN's last
# two map sizes, in both 16-bit types: the wgmma form where pixel_plan takes
# it, the mma.sync kernel elsewhere
PIXEL_FORM_SHAPES = PIXEL_SHAPES + [(1, 16, 96, 128, 32), (1, 16, 160, 128, 32),
                                    (2, 7, 160, 88, 64), (1, 8, 64, 256, 64)]


@pytest.mark.parametrize("shape", PIXEL_FORM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("alpha", [None, 0.0, 0.2])
def test_pixel_conv_rowdot_forms_match_plain(cuda, shape, dtype, alpha):
    from smelter_tpu_torch.kernels import pixel_conv as pc

    torch.backends.cudnn.allow_tf32 = False
    x, w, b = _pixel_operands(*shape, cuda, seed=shape[2])
    x = x.to(dtype)
    B, H, C, W, co = shape
    form = pc.plan(x, w).form
    assert form == ("wgmma" if co in (32, 64) and W % 8 == 0 and W >= 80 and H >= 6
                    and C % 8 == 0 and C >= 16 else "mma")
    before = pc.launches
    got = pc.pixel_conv_rowdot(x, w, b, alpha=alpha)
    again = pc.pixel_conv_rowdot(x, w, b, alpha=alpha)
    torch.cuda.synchronize()
    assert pc.launches == before + 2 and torch.equal(got, again)
    ref = pc.pixel_conv_rowdot_plain(x, w, b, alpha=alpha)
    assert got.dtype == dtype and got.shape == ref.shape
    tol = {torch.bfloat16: 1e-2, torch.float16: 2e-3}[dtype]
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), (form, err)


def test_pixel_conv_rowdot_wgmma_form_at_esrgans_shapes(cuda):
    """ESRGAN x4's eight PixelConv shapes at batch 2, bf16, LeakyReLU 0.2,
    a bf16 bias (the executor's operands: the packed weight's OIHW view)."""
    from smelter_tpu_torch.kernels import pixel_conv as pc

    torch.backends.cudnn.allow_tf32 = False
    shapes = [(2, 128, 64 + 32 * i, 128, 32 if i < 4 else 64) for i in range(5)] + [
        (2, s, 64, s, 64) for s in (128, 256, 512)]
    for shape in shapes:
        x, w, b = _pixel_operands(*shape, cuda, seed=7)
        x, w, b = x.bfloat16(), w.bfloat16(), b.bfloat16()
        packed = w.permute(2, 3, 0, 1).contiguous().permute(2, 3, 0, 1)
        assert pc.plan(x, packed).form == "wgmma"
        got = pc.pixel_conv_rowdot(x, packed, b, alpha=0.2)
        ref = pc.pixel_conv_rowdot_plain(x, w, b, alpha=0.2)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= 1e-2 * ref.float().abs().max().item(), (shape, err)


# (name, call builder, the kernel it launches): what each form of the two
# plans launches, and every "mma" case of pixel_plan on its earlier kernel
def _form_cases(device):
    from smelter_tpu_torch.kernels import pixel_conv as pc

    def int8_call(m, n, k):
        ops = _int8_operands(m, n, k, device)
        return lambda: im.int8_matmul(*ops)

    def pixel_call(shape, dtype):
        x, w, b = _pixel_operands(*shape, device)
        x = x.to(dtype)
        wp = w.to(dtype).permute(2, 3, 0, 1).contiguous().permute(2, 3, 0, 1)
        return lambda: pc.pixel_conv_rowdot(x, wp, b, alpha=0.2)

    def q_call(shape, out):
        ops = _q_operands(*shape, device)
        requant, out_dtype = Q_OUTS[out]
        return lambda: pc.pixel_conv_rowdot_q(*ops, alpha=0.2, requant=requant,
                                              out_dtype=out_dtype)

    def mlp_call(geom):
        from smelter_tpu_torch.kernels import mlp_block as mb

        ops = _mlp_operands_gpu(*geom, torch.bfloat16, device)
        return lambda: mb.mlp_block(*ops)

    bf16 = torch.bfloat16
    return [
        ("q trunk int8", q_call((2, 128, 64, 128, 32), "int8"), "pixel_conv_wgmma_s8"),
        ("q 192 -> 64 bf16", q_call((1, 16, 192, 128, 64), "bf16"), "pixel_conv_wgmma_s8"),
        ("q f32 out", q_call((1, 16, 64, 128, 32), "f32"), "pixel_conv_mma"),
        ("q W 72", q_call((1, 16, 64, 72, 32), "int8"), "pixel_conv_mma"),
        ("mlp ViT-B/16", mlp_call((1, 197, 768, 3072)), ("gemm_tma", "gemm_tma")),
        ("mlp M 21", mlp_call((3, 7, 136, 264)), ("gemm_mma", "gemm_mma")),
        ("int8 head", int8_call(128, 1000, 2048), "gemm_cluster_s8"),
        ("int8 serving", int8_call(8192, 4096, 4096), "gemm_tma_s8"),
        ("int8 odd", int8_call(37, 100, 70), "gemm_cluster_s8"),
        ("pixel trunk", pixel_call((2, 128, 64, 128, 32), bf16), "pixel_conv_wgmma"),
        ("pixel 512 px", pixel_call((1, 16, 64, 512, 64), torch.float16), "pixel_conv_wgmma"),
        ("pixel f32", pixel_call((1, 16, 64, 128, 32), torch.float32), "pixel_conv_f32"),
        ("pixel W 100", pixel_call((2, 7, 16, 100, 8), bf16), "pixel_conv_mma"),
        ("pixel C_out 72", pixel_call((2, 5, 24, 37, 72), bf16), "pixel_conv_mma"),
        ("pixel H 3", pixel_call((1, 3, 16, 128, 32), bf16), "pixel_conv_mma"),
        ("pixel W 64", pixel_call((1, 9, 16, 64, 32), bf16), "pixel_conv_mma"),
        ("pixel C_in 8", pixel_call((1, 9, 8, 128, 32), bf16), "pixel_conv_mma"),
        ("pixel C_in 5", pixel_call((1, 9, 5, 64, 32), bf16), "pixel_conv_mma"),
    ]


def _profile_form_cases(device="cuda"):
    """The kernels of csrc/wgmma_gemm.cuh's int8 forms and of pixel_conv.cu
    that each of _form_cases launches, from one torch.profiler session."""
    from torch.profiler import ProfilerActivity, profile

    cases = _form_cases(device)
    for _, call, _ in cases:
        call()
    torch.cuda.synchronize()
    names = []
    for _, call, _ in cases:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names.append([e.name for e in prof.events() if e.device_type.name == "CUDA"
                      and ("pixel_conv" in e.name or "gemm" in e.name)])
    return names


def test_int8_and_pixel_forms_launch_their_kernels(cuda):
    """The head and odd int8 shapes launch the cluster form, the serving
    GEMM the tma form; 16-bit pixel convs the plan takes launch
    csrc/wgmma_conv.cuh's kernel, and every "mma" case (f32, W % 8, C_out
    outside {32, 64}, H < 6, W < 80, C_in % 8, C_in < 16) its earlier
    kernel; int8 convs the plan takes (int8 or bf16 out) launch
    csrc/wgmma_conv_s8.cuh's, f32 out and W 72 the mma.sync kernel;
    mlp_block at ViT-B/16 runs FC1 and FC2 on gemm_tma, at M 21 on
    gemm.cuh. The profile runs in a
    process of its own (several torch.profiler sessions in one process lose
    kernels)."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    here = Path(__file__).resolve().parent
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); import test_torch_gpu as t; "
            "print('NAMES ' + json.dumps(t._profile_form_cases()))")
    proc = subprocess.run([sys.executable, "-c", code, str(here)], cwd=here.parent,
                          capture_output=True, text=True, timeout=600, check=False)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("NAMES ")]
    assert proc.returncode == 0 and lines, proc.stderr[-3000:]
    names = json.loads(lines[-1][len("NAMES "):])
    for (case, _, kernel), got in zip(_form_cases("meta"), names):
        want = kernel if isinstance(kernel, tuple) else (kernel,)
        assert len(got) == len(want) and all(k in g for k, g in zip(want, got)), (case, got)


# -- pixel_conv_blockdot, pixel_conv_patch ------------------------------------------

@pytest.mark.parametrize("shape", PIXEL_SHAPES + [(1, 7, 24, 100, 40)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("alpha", [None, 0.2])
def test_pixel_conv_variants_match_plain(cuda, shape, dtype, alpha):
    """blockdot (its taller tile: 8 or 4 output rows) on NHCW and patch
    (rowdot's tile at NCHW strides) on the flat NCHW map, each against its
    plain version, in rowdot's tolerances; H 3, 5, 7 and 9 leave the 4-row
    block ragged."""
    from smelter_tpu_torch.kernels import pixel_conv as pc

    torch.backends.cudnn.allow_tf32 = False
    x, w, b = _pixel_operands(*shape, cuda)
    x = x.to(dtype)
    B, H, Cin, W, Cout = shape
    tol = {torch.bfloat16: 1e-2, torch.float16: 2e-3, torch.float32: 1e-5}[dtype]
    before = pc.blockdot_launches
    got = pc.pixel_conv_blockdot(x, w, b, alpha=alpha)
    torch.cuda.synchronize()
    assert pc.blockdot_launches == before + 1
    ref = pc.pixel_conv_blockdot_plain(x, w, b, alpha=alpha)
    assert got.dtype == dtype and got.shape == ref.shape
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err
    xf = x.permute(0, 2, 1, 3).reshape(B, Cin, H * W).contiguous()
    before = pc.patch_launches
    got = pc.pixel_conv_patch(xf, w, b, width=W, alpha=alpha)
    torch.cuda.synchronize()
    assert pc.patch_launches == before + 1
    ref = pc.pixel_conv_patch_plain(xf, w, b, width=W, alpha=alpha)
    assert got.dtype == dtype and got.shape == (B, Cout, H * W)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


# blockdot's tall wgmma form: ESRGAN x4's eight PixelConv shapes at batch 8
# (B, H, C_in, W, C_out), and ragged ones: H 12 (8-row tiles of 12 rows),
# H 7 (below the 10-row box: the 4-row tile), W 88 and 136 (a part pixel
# tile), C_out 64 (the 4-row tile)
BLOCKDOT_ESRGAN = [(8, 128, 64 + 32 * i, 128, 32 if i < 4 else 64) for i in range(5)] + [
    (8, s, 64, s, 64) for s in (128, 256, 512)]
BLOCKDOT_RAGGED = [(2, 12, 96, 88, 32), (1, 12, 128, 136, 32), (1, 12, 96, 136, 64),
                   (2, 7, 96, 88, 32), (1, 7, 64, 136, 64)]


@pytest.mark.parametrize("shape", BLOCKDOT_ESRGAN + BLOCKDOT_RAGGED)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_pixel_conv_blockdot_wgmma_form(cuda, shape, dtype):
    """16-bit blockdot on the wgmma conv core, on the tile height its plan
    chose (8 rows where the 10-row box fits and the plan's rule takes the
    shape, else 4), against the plain
    version; one launch counted a call."""
    from smelter_tpu_torch.kernels import pixel_conv as pc
    from smelter_tpu_torch.kernels import wgmma_plan as wp

    torch.backends.cudnn.allow_tf32 = False
    x, w, b = _pixel_operands(*shape, cuda)
    x = x.to(dtype)
    B, H, Cin, W, Cout = shape
    p = pc.plan(x, w, tall=True)
    assert p.form == "wgmma" and p.rows == (8 if H >= 10 and wp.pixel_tall_takes(Cin, Cout)
                                            else 4)
    before = pc.blockdot_launches
    got = pc.pixel_conv_blockdot(x, w, b, alpha=0.2)
    torch.cuda.synchronize()
    assert pc.blockdot_launches == before + 1
    ref = pc.pixel_conv_blockdot_plain(x, w, b, alpha=0.2)
    assert got.dtype == dtype and got.shape == ref.shape
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 1e-2 * ref.float().abs().max().item(), err


# patch's wgmma form at flat NCHW strides: ESRGAN x4's shapes at batch 8 and
# blockdot's ragged ones; shapes that keep form 0 (f32 runs on each case
# below too): W % 8, W < 80, H < 6, C_out 40
PATCH_FORM0 = [(2, 7, 24, 100, 40), (1, 16, 64, 72, 32), (2, 5, 64, 128, 32),
               (1, 16, 32, 100, 64)]


@pytest.mark.parametrize("shape", BLOCKDOT_ESRGAN + BLOCKDOT_RAGGED + PATCH_FORM0)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pixel_conv_patch_wgmma_form(cuda, shape, dtype):
    """patch on the plan's form: the wgmma conv core reading and storing flat
    NCHW at its strides (blockdot's tile rule), form 0 elsewhere and for f32;
    one launch a call, counted by form; bf16 within 1e-2 x max|plain|, f32
    within 1e-5."""
    from smelter_tpu_torch.kernels import pixel_conv as pc

    torch.backends.cudnn.allow_tf32 = False
    x, w, b = _pixel_operands(*shape, cuda)
    B, H, Cin, W, Cout = shape
    xf = x.permute(0, 2, 1, 3).reshape(B, Cin, H * W).contiguous().to(dtype)
    p = pc.patch_plan(xf, w, W)
    wgmma = dtype != torch.float32 and shape not in PATCH_FORM0
    assert p.form == ("wgmma" if wgmma else "mma")
    before, forms = pc.patch_launches, dict(pc.patch_forms)
    got = pc.pixel_conv_patch(xf, w, b, width=W, alpha=0.2)
    torch.cuda.synchronize()
    assert pc.patch_launches == before + 1
    assert pc.patch_forms[p.form] == forms[p.form] + 1
    ref = pc.pixel_conv_patch_plain(xf, w, b, width=W, alpha=0.2)
    assert got.dtype == dtype and got.shape == (B, Cout, H * W)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


def test_pixel_conv_variants_raise_on_bad_operands(cuda):
    from smelter_tpu_torch.kernels import pixel_conv as pc

    x, w, b = _pixel_operands(1, 8, 16, 32, 8, cuda)
    with pytest.raises(TypeError):  # int8 x
        pc.pixel_conv_blockdot(x.to(torch.int8), w, b)
    with pytest.raises(ValueError):  # a weight of other input channels
        pc.pixel_conv_blockdot(x, w[:, :8], b)
    xf = x.permute(0, 2, 1, 3).reshape(1, 16, 8 * 32).contiguous()
    with pytest.raises(ValueError):  # rows that do not tile the map
        pc.pixel_conv_patch(xf, w, b, width=30)
    with pytest.raises(ValueError):  # an NHCW map in the NCHW form
        pc.pixel_conv_patch(x, w, b, width=32)
    with pytest.raises(TypeError):  # a bias of a third type
        pc.pixel_conv_patch(xf.bfloat16(), w, b.half(), width=32)


# -- dequant_matmul_int8_fused, dequant_matmul_int8_fused2 -----------------------------

# Ragged M, N and K beside the ResNet-50 head (the cluster form); long K;
# the panel form on 8 ranks (2,048 rows x 512 columns, K 4,096 and 6,144).
FUSED_SHAPES = SHAPES + [(17, 72, 200), (64, 300, 4096), (40, 200, 5952), (256, 256, 6144),
                         (2048, 512, 4096), (2048, 512, 6144)]


@pytest.mark.parametrize("shape", FUSED_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_dequant_matmul_int8_fused_equal_plain(cuda, shape, dtype, out_dtype):
    """Both schedules bit-equal to the plain version (quantize_rows, the
    exact int32 sum, two f32 multiplies, one rounding) and to the two-pass
    dequant_matmul_int8."""
    m, n, k = shape
    x, w, s = _operands(m, n, k, dtype, cuda, seed=7)
    x[min(3, m - 1)] = 0  # the 1e-30 floor
    ref = im.dequant_matmul_int8_fused_plain(x, w, s, out_dtype=out_dtype)
    two_pass = im.dequant_matmul_int8(x, w, s, out_dtype=out_dtype)
    assert torch.equal(ref, two_pass)
    for fn, counter in ((im.dequant_matmul_int8_fused, "fused_launches"),
                        (im.dequant_matmul_int8_fused2, "fused2_launches")):
        before = getattr(im, counter)
        got = fn(x, w, s, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert getattr(im, counter) == before + 1
        assert got.dtype == (out_dtype or dtype) and torch.equal(got, ref), fn.__name__


def test_dequant_matmul_int8_fused_raises(cuda):
    """No K is refused any more (the cluster form takes K past the panel's);
    what the kernels do not take still raises."""
    x, w, s = _operands(8, 16, 5953, torch.bfloat16, cuda)
    ref = im.dequant_matmul_int8_fused_plain(x, w, s)
    assert torch.equal(im.dequant_matmul_int8_fused(x, w, s), ref)
    assert torch.equal(im.dequant_matmul_int8_fused2(x, w, s), ref)
    with pytest.raises(TypeError):
        im.dequant_matmul_int8_fused(x, w, s, out_dtype=torch.float16)
    with pytest.raises(TypeError):  # an out_dtype that is neither f32 nor x's
        im.dequant_matmul_int8_fused2(x, w, s, out_dtype=torch.float16)
    with pytest.raises(ValueError):  # K mismatch
        im.dequant_matmul_int8_fused2(x[:, :100], w, s)


# (M, N, K) -> the form and ranks fused_plan picks: the serving GEMM and the
# ResNet-50 head, the panel form on 4 and 8 ranks at 2,048 rows (256 units,
# and 64: too few for 4), a K past 5,952 on the cluster form, the small odd
# shape, and the serving GEMM's size at a K the panel's chunks do not fit
# (the revisit kernel)
FUSED_FORMS = {(8192, 4096, 4096): ("panel", 4), (128, 1000, 2048): ("cluster", 8),
               (2048, 2048, 4096): ("panel", 4), (2048, 512, 4096): ("panel", 8),
               (2048, 512, 6144): ("panel", 8),
               (256, 256, 6144): ("cluster", 8), (17, 72, 200): ("cluster", 2),
               (8192, 4096, 4104): ("revisit", 1)}


@pytest.mark.parametrize("shape", list(FUSED_FORMS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dequant_matmul_int8_fused_forms(cuda, shape, dtype):
    """dequant_matmul_int8_fused on the form its plan names, bit-equal to the
    plain version and to the two-pass dequant_matmul_int8; one launch a
    call, counted by form."""
    m, n, k = shape
    x, w, s = _operands(m, n, k, dtype, cuda, seed=11)
    x[min(3, m - 1)] = 0
    ref = im.dequant_matmul_int8_fused_plain(x, w, s)
    assert torch.equal(ref, im.dequant_matmul_int8(x, w, s))
    p = im.fused_plan(x, w)
    assert (p.form, p.split) == FUSED_FORMS[shape]
    before, forms = im.fused_launches, dict(im.fused_forms)
    got = im.dequant_matmul_int8_fused(x, w, s)
    torch.cuda.synchronize()
    assert im.fused_launches == before + 1 and im.fused_forms[p.form] == forms[p.form] + 1
    assert got.dtype == dtype and torch.equal(got, ref)


# (M, N, K) -> the form dequant_matmul_int8_fused2 takes (revisit_plan): the
# serving GEMM and K 4,104 on the revisit form's 256-column tiles; K off the
# 128 grid with the last tile's second W box wholly past N (4,112); 128-column
# tiles where 256-column ones are too few (M off the grid, N 400 and 272) or
# N is narrower (144); the ResNet-50 head on the cluster form; N % 16 at many
# tiles on the mma.sync kernel
FUSED2_FORMS = {(8192, 4096, 4096): "revisit256", (8192, 4096, 4104): "revisit256",
                (8192, 4112, 1000): "revisit256", (2000, 400, 1000): "revisit128",
                (2000, 272, 1000): "revisit128", (4096, 144, 4104): "revisit128",
                (128, 1000, 2048): "cluster", (1024, 1000, 512): "mma"}


def _form_of(p) -> str:
    return p.form + (str(p.cols) if p.form == "revisit" else "")


@pytest.mark.parametrize("shape", list(FUSED2_FORMS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_dequant_matmul_int8_fused2_forms(cuda, shape, dtype, out_dtype):
    """dequant_matmul_int8_fused2 on the form its plan names, bit-equal to
    the plain version; one launch a call, counted by form."""
    m, n, k = shape
    x, w, s = _operands(m, n, k, dtype, cuda, seed=13)
    x[min(3, m - 1)] = 0  # the 1e-30 floor
    ref = im.dequant_matmul_int8_fused_plain(x, w, s, out_dtype=out_dtype)
    p = im.fused_plan(x, w, fused2=True)
    assert _form_of(p) == FUSED2_FORMS[shape]
    before, forms = im.fused2_launches, dict(im.fused2_forms)
    got = im.dequant_matmul_int8_fused2(x, w, s, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert im.fused2_launches == before + 1 and im.fused2_forms[p.form] == forms[p.form] + 1
    assert got.dtype == (out_dtype or dtype) and torch.equal(got, ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dequant_matmul_int8_fused2_unaligned_base_takes_mma(cuda, dtype):
    """x at a base no TMA map takes (a contiguous view 2 or 4 bytes into its
    buffer) runs the mma.sync kernel, bit-equal to the plain version."""
    m, n, k = 2048, 1024, 1024
    x0, w, s = _operands(m, n, k, dtype, cuda, seed=17)
    x = torch.empty(m * k + 1, dtype=dtype, device=cuda)[1:].view(m, k)
    x.copy_(x0)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    assert im.fused_plan(x, w, fused2=True).form == "mma"
    before = im.fused2_forms["mma"]
    got = im.dequant_matmul_int8_fused2(x, w, s)
    torch.cuda.synchronize()
    assert im.fused2_forms["mma"] == before + 1
    assert torch.equal(got, im.dequant_matmul_int8_fused_plain(x, w, s))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_fused_forms_at_ties(cuda, dtype):
    """Every form of both fused GEMMs (the revisit form on 256- and
    128-column tiles, the panel, cluster and mma.sync forms), forced on the
    same operands, bit-equal to the plain version where x / s_row lies at
    (k + 0.5) and one ulp beside it, at +-127, in a zero row and in a row
    whose scale is below 2^-96, beside random rows."""
    from torch_fused_ties import tie_rows

    from smelter_tpu_torch.kernels import wgmma_plan as wp
    m, n, k = 256, 400, 1024  # the second 256-column tile: a box partly past N
    ties = tie_rows(dtype)
    x, w, s = _operands(m, n, k, dtype, cuda, seed=19)
    x[:ties.shape[0]] = 0
    x[:ties.shape[0], :ties.shape[1]] = ties.to(cuda)
    x[ties.shape[0] + 1, ::7] = ties[0, 1:].to(cuda)[:k // 7 + 1]  # ties among random values
    x[ties.shape[0] + 2] *= 1e-29  # s below 2^-96: the revisit form divides (f16: zeros)
    ref = im.dequant_matmul_int8_fused_plain(x, w, s)
    s_row = im.quantize_rows_scales(x)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    xb = x.element_size()
    plans = {"revisit256": wp.revisit_form(m, n, k, xb, cols=256, sms=sms),
             "revisit128": wp.revisit_form(m, n, k, xb, cols=128, sms=sms),
             "panel": wp._panel_form(m, n, k, 4), "cluster": wp._cluster_form(m, n, k, sms),
             "mma": wp.mma_plan(m, n, k)}
    for name, p in plans.items():
        out = torch.empty(m, n, dtype=dtype, device=cuda)
        im._launch(x, w, s_row, s, out, p, name)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), name


# -- max_unpool2x2 (SegNet) ------------------------------------------------------

# SegNet's three unpools at batch 16, 256 px, base 32, and ragged ones.
UNPOOL_SHAPES = [(16, 128, 32, 32), (16, 64, 64, 64), (16, 32, 128, 128), (2, 3, 5, 7),
                 (1, 1, 1, 1)]


@pytest.mark.parametrize("shape", UNPOOL_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_max_unpool2x2_matches_plain_and_scatter(cuda, shape, dtype):
    import torch.nn.functional as F

    from smelter_tpu_torch.kernels import max_unpool as mu

    B, C, h, w = shape
    gen = torch.Generator(device=cuda).manual_seed(0)
    full = torch.randn(B, C, 2 * h, 2 * w, device=cuda, generator=gen).to(dtype)
    val, plane = F.max_pool2d(full.float(), 2, 2, return_indices=True)
    val = val.to(dtype)
    # per-plane indices -> flat over [N, C, 2h, 2w], as MaxPool's output
    idx = plane + (torch.arange(B * C, device=cuda).reshape(B, C, 1, 1) * 4 * h * w)
    before = mu.launches
    got = mu.max_unpool2x2(val, idx)
    torch.cuda.synchronize()
    assert mu.launches == before + 1 and got.dtype == dtype
    assert torch.equal(got, mu.max_unpool2x2_plain(val, idx))
    scatter = torch.zeros(B * C * 4 * h * w, dtype=dtype, device=cuda)
    scatter[idx.reshape(-1)] = val.reshape(-1)
    assert torch.equal(got, scatter.reshape(got.shape))


def test_image_kernels_raise_on_bad_operands(cuda):
    from smelter_tpu_torch.kernels import max_unpool as mu
    from smelter_tpu_torch.kernels import pixel_conv as pc

    x, w, b = _pixel_operands(1, 8, 16, 32, 8, cuda)
    with pytest.raises(TypeError):  # int8 x in the float form
        pc.pixel_conv_rowdot(x.to(torch.int8), w, b)
    with pytest.raises(ValueError):  # a weight of other input channels
        pc.pixel_conv_rowdot(x, w[:, :8], b)
    with pytest.raises(ValueError):  # a bias of other output channels
        pc.pixel_conv_rowdot(x, w, b[:4])
    with pytest.raises(TypeError):  # float x in the int8 form
        pc.pixel_conv_rowdot_q(x, w.to(torch.int8), b, b)
    with pytest.raises(TypeError):  # an int8 output dtype without requant
        pc.pixel_conv_rowdot_q(x.to(torch.int8), w.to(torch.int8), b, b, requant=False,
                               out_dtype=torch.int8)
    v = torch.randn(1, 2, 4, 4, device=cuda)
    with pytest.raises(ValueError):  # indices of another shape
        mu.max_unpool2x2(v, torch.zeros(1, 2, 4, 3, dtype=torch.int64, device=cuda))
    with pytest.raises(TypeError):  # float indices
        mu.max_unpool2x2(v, torch.zeros_like(v))
    with pytest.raises(TypeError):  # integer values
        mu.max_unpool2x2(v.to(torch.int32), torch.zeros(1, 2, 4, 4, dtype=torch.int64,
                                                        device=cuda))


@pytest.mark.parametrize("model", ["esrgan", "segnet"])
def test_small_image_models_on_the_card_match_the_cpu(cuda, model):
    """The port's small ESRGAN (19 PixelConv a forward) and SegNet (3
    MaxUnpool) compiled on the card against the same graph on the CPU: f32
    within 1e-4 of the largest output (cuDNN and the kernels in full f32),
    bf16 within 3x the CPU bf16's own error against f32 (in bf16 a pool
    window's two largest values may round to a tie, which moves SegNet's
    unpooled values). ESRGAN's int8-pixel graph (calibrated on the CPU) on
    the card against the same graph on the CPU: its int8 edges are equal
    but for flips at a half-way point of the grid, 1e-3 of the largest."""
    import copy

    import smelter_tpu_torch as stt
    from smelter_tpu_torch.kernels import max_unpool as mu
    from smelter_tpu_torch.kernels import pixel_conv as pc
    from smelter_tpu_torch.models import esrgan, segnet

    torch.backends.cudnn.allow_tf32 = False
    if model == "esrgan":
        g, _, shape = esrgan.build(batch=1, image_size=128, nf=16, nb=1, scale=4)
        counter, count = (pc, "launches"), 19
    else:
        g, _, shape = segnet.build(batch=2, image_size=64, base=8)
        counter, count = (mu, "launches"), 3
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    ref = stt.compile(copy.deepcopy(g), device="cpu")(x)[0]
    bf16 = {"compute_dtype": "bfloat16"}
    ref16 = stt.compile(copy.deepcopy(g), stt.Config(**bf16), device="cpu")(x)[0]
    bounds = {"f32": 1e-4 * np.abs(ref).max(), "bf16": 3 * np.abs(ref16 - ref).max()}
    for label, cfg in (("f32", {}), ("bf16", bf16)):
        m = stt.compile(copy.deepcopy(g), stt.Config(**cfg), device="cuda")
        before = getattr(*counter)
        got = m(x)[0]
        assert getattr(*counter) == before + count
        assert got.shape == ref.shape and np.abs(got - ref).max() <= bounds[label], label
    if model == "esrgan":
        gq = stt.compile(copy.deepcopy(g), quant="int8-pixel", calibration_data=[(x,)],
                         device="cpu").graph
        ref_q = stt.CompiledModel(copy.deepcopy(gq), stt.Config(device="cpu"))(x)[0]
        before = pc.q_launches
        got = stt.CompiledModel(gq, stt.Config(device="cuda"))(x)[0]
        assert pc.q_launches == before + count
        assert np.abs(got - ref_q).max() <= 1e-3 * np.abs(ref_q).max()


# -- flash_attention, short_attention, mlp_block (transformer encoder) --------

def _bnhd(B, H, N, hd, dtype, device, seed):
    """A (B, H, N, hd) view of a (B, N, H, hd) tensor, as a graph's Reshape
    -> Transpose hands attention its operands."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((B, N, H, hd), np.float32)).to(device, dtype)
    return a.permute(0, 2, 1, 3)


def _attention_check(fn, plain, counter, q, k, v, scale, tol16):
    """One launch; the output takes q's strides; f32 within 1e-5 of the
    largest plain output (full f32, sums in other orders), 16-bit within
    tol16 of it."""
    before = getattr(*counter)
    got = fn(q, k, v, scale=scale)
    torch.cuda.synchronize()
    assert getattr(*counter) == before + 1
    ref = plain(q, k, v, scale=scale)
    assert got.shape == ref.shape and got.dtype == q.dtype and got.stride() == q.stride()
    tol = 1e-5 if q.dtype == torch.float32 else tol16
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


# (B, H, Nq, Nk, hd): ViT-B/16 384 px at batch 1, Nq != Nk both ways, a KV
# tail of one key, hd 16, 32 and 128, and hd 48 (the warp-per-row kernel)
FLASH_GEOMS = [(1, 12, 577, 577, 64), (1, 2, 300, 600, 64), (2, 2, 130, 65, 32),
               (1, 2, 100, 129, 128), (1, 3, 64, 2048, 16), (1, 2, 70, 90, 48)]


@pytest.mark.parametrize("geom", FLASH_GEOMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("layout", ["bnhd", "contiguous"])
def test_flash_attention_matches_plain(cuda, geom, dtype, layout):
    """16-bit within 1e-2 of the largest output: the kernel rounds p to the
    operands' type before p V, the plain version keeps it in f32."""
    from smelter_tpu_torch.kernels import flash_attention as fa

    B, H, Nq, Nk, hd = geom
    q, k, v = (_bnhd(B, H, n, hd, dtype, cuda, s) for n, s in ((Nq, 0), (Nk, 1), (Nk, 2)))
    if layout == "contiguous":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _attention_check(fa.flash_attention, fa.flash_attention_plain, (fa, "launches"), q, k, v,
                     hd ** -0.5, 1e-2)


# (B, H, N, hd): ViT-B/16 224 px at batch 2, the JAX test's shapes, N at
# the 512 limit, hd 128 and 16, and hd 40 (the warp-per-row kernel)
SHORT_GEOMS = [(2, 12, 197, 64), (2, 4, 64, 64), (1, 2, 30, 32), (1, 2, 512, 64),
               (1, 2, 100, 128), (2, 3, 65, 16), (1, 2, 50, 40)]


@pytest.mark.parametrize("geom", SHORT_GEOMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("layout", ["bnhd", "contiguous"])
def test_short_attention_matches_plain(cuda, geom, dtype, layout):
    """16-bit within 1e-2 of the largest output: p is rounded to the
    operands' type in both, and an f32 p one ulp apart can round apart."""
    from smelter_tpu_torch.kernels import attention_short as sa

    B, H, N, hd = geom
    q, k, v = (_bnhd(B, H, N, hd, dtype, cuda, s) for s in (3, 4, 5))
    if layout == "contiguous":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _attention_check(sa.short_attention, sa.short_attention_plain, (sa, "launches"), q, k, v,
                     hd ** -0.5, 1e-2)


# The wgmma attention core's forms for short_attention and flash_attention
# (kernels/attention_plan.py): at the edges of a 128-key tile and a 128-row
# block, every head dim, both layouts the graph hands over and Nq != Nk.
CORE_EDGE_NS = [1, 127, 128, 129, 200, 256, 257, 512]


def _views(B, H, N, hd, dtype, device, seed, layout):
    t = _bnhd(B, H, N, hd, dtype, device, seed)
    return t.contiguous() if layout == "contiguous" else t


@pytest.mark.parametrize("N", CORE_EDGE_NS)
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("layout", ["bnhd", "contiguous"])
def test_short_attention_core_forms(cuda, N, hd, dtype, layout):
    """The normalised form (one pass to 256 keys, resident tiles past that)
    against the plain version, 1e-2 x max|plain|; hd 128 past 384 keys
    keeps the mma.sync kernel."""
    from smelter_tpu_torch.kernels import attention_short as sa

    q, k, v = (_views(2, 3, N, hd, dtype, cuda, s, layout) for s in (3, 4, 5))
    form = sa.plan(q, k, v, torch.empty_like(q)).form
    assert form == ("mma" if hd == 128 and N > 384 else "one_pass" if N <= 256 else "resident")
    _attention_check(sa.short_attention, sa.short_attention_plain, (sa, "launches"), q, k, v,
                     hd ** -0.5, 1e-2)


@pytest.mark.parametrize("Nq,Nk", [(n, n) for n in CORE_EDGE_NS] + [(1, 512), (577, 65),
                                                                    (129, 1000), (300, 2)])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("layout", ["bnhd", "contiguous"])
def test_flash_attention_core_forms(cuda, Nq, Nk, hd, dtype, layout):
    """The streaming form in one call against the plain version, 1e-2 x
    max|plain| (p rounded to the operands' type before p V)."""
    from smelter_tpu_torch.kernels import flash_attention as fa

    q = _views(2, 3, Nq, hd, dtype, cuda, 0, layout)
    k, v = (_views(2, 3, Nk, hd, dtype, cuda, s, layout) for s in (1, 2))
    assert fa.plan(q, k, v, torch.empty_like(q)).form == "streaming"
    _attention_check(fa.flash_attention, fa.flash_attention_plain, (fa, "launches"), q, k, v,
                     hd ** -0.5, 1e-2)


def _unaligned(B, H, N, hd, dtype, device, seed):
    """(B, H, N, hd) views whose base lies 8 bytes off 16."""
    rng = np.random.default_rng(seed)
    flat = torch.from_numpy(rng.standard_normal(B * N * H * hd + 4, np.float32)).to(device,
                                                                                   dtype)
    return flat[4:].view(B, N, H, hd).permute(0, 2, 1, 3)


def _odd_rows(B, H, N, hd, dtype, device, seed):
    """(B, H, N, hd) views of a (B, N, H, hd + 4) tensor: rows 8 bytes off a
    16-byte multiple apart."""
    return _bnhd(B, H, N, hd + 4, dtype, device, seed)[..., :hd]


# (case, kernel, function, dtype, builder, B, H, Nq, Nk, hd): what the plans
# send to "mma", and the kernel each still launches
MMA_CASES = [
    ("f32", "short", torch.float32, _bnhd, 2, 3, 197, 197, 64, "attention_rows"),
    ("f32", "flash", torch.float32, _bnhd, 2, 3, 577, 300, 64, "attention_rows"),
    ("hd16", "flash", torch.bfloat16, _bnhd, 2, 3, 200, 129, 16, "flash_mma"),
    ("hd80", "short", torch.bfloat16, _bnhd, 1, 2, 100, 100, 80, "attention_rows"),
    ("hd80", "flash", torch.float16, _bnhd, 1, 2, 100, 70, 80, "attention_rows"),
    ("hd128 N512", "short", torch.bfloat16, _bnhd, 1, 2, 512, 512, 128, "short_mma"),
    ("unaligned", "short", torch.bfloat16, _unaligned, 1, 2, 197, 197, 64, "attention_rows"),
    ("unaligned", "flash", torch.bfloat16, _unaligned, 1, 2, 197, 197, 64, "attention_rows"),
    ("odd rows", "short", torch.float16, _odd_rows, 1, 3, 197, 197, 64, "attention_rows"),
    ("odd rows", "flash", torch.bfloat16, _odd_rows, 1, 3, 130, 257, 64, "attention_rows"),
]


@pytest.mark.parametrize("case", MMA_CASES, ids=[f"{c[0]}-{c[1]}" for c in MMA_CASES])
def test_attention_mma_plans_keep_their_kernels(cuda, case):
    """Every "mma" case of short_plan and flash_plan stays within its bound
    on the file's earlier kernels (f32 1e-5, 16-bit 1e-2 x max|plain|);
    test_attention_forms_launch_their_kernels names the kernels."""
    from smelter_tpu_torch.kernels import attention_short as sa
    from smelter_tpu_torch.kernels import flash_attention as fa

    _, which, dtype, build, B, H, Nq, Nk, hd, kernel = case
    mod = sa if which == "short" else fa
    fn = sa.short_attention if which == "short" else fa.flash_attention
    plain = sa.short_attention_plain if which == "short" else fa.flash_attention_plain
    q = build(B, H, Nq, hd, dtype, cuda, 0)
    k, v = (build(B, H, Nk, hd, dtype, cuda, s) for s in (1, 2))
    assert mod.plan(q, k, v, torch.empty_like(q)).form == "mma"
    before = mod.launches
    got = fn(q, k, v, scale=hd ** -0.5)
    torch.cuda.synchronize()
    assert mod.launches == before + 1
    ref = plain(q, k, v, scale=hd ** -0.5)
    assert got.shape == ref.shape and got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


PATH_CASES = [("short", 128, 197), ("flash", 64, 577), ("flash", 2, 2048), ("flash", 2, 4096)]


def _case_call(which, dtype, build, B, H, Nq, Nk, hd, device):
    """The wrapper call of one case on fresh operands."""
    from smelter_tpu_torch.kernels import attention_short as sa
    from smelter_tpu_torch.kernels import flash_attention as fa

    fn = sa.short_attention if which == "short" else fa.flash_attention
    q = build(B, H, Nq, hd, dtype, device, 0)
    k, v = (build(B, H, Nk, hd, dtype, device, s) for s in (1, 2))
    return lambda: fn(q, k, v, scale=hd ** -0.5)


def _profile_cases(device="cuda"):
    """The kernel each of MMA_CASES and PATH_CASES launches, in order, from
    one torch.profiler session (each call launches one kernel)."""
    from torch.profiler import ProfilerActivity, profile

    calls = [_case_call(c[1], c[2], c[3], *c[4:9], device) for c in MMA_CASES] + [
        _case_call(w, torch.bfloat16, _bnhd, B, 12, N, N, 64, device) for w, B, N in PATH_CASES]
    for call in calls:
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for call in calls:
            call()
            torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events() if e.device_type.name == "CUDA"),
                     key=lambda e: e.time_range.start)
    return [e.name for e in kernels]


def test_attention_forms_launch_their_kernels(cuda):
    """Each "mma" case launches its file's earlier kernel (mma.sync or
    warp-per-row) and never the wgmma core; at the paths' shapes (ViT-B/16
    224 px b128 and 384 px b64 in the HF layout, the auto-flash shapes) each
    call launches one kernel of csrc/wgmma_attention.cuh. The profile runs
    in a process of its own: several torch.profiler sessions in one process
    lose kernels."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    here = Path(__file__).resolve().parent
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); import test_torch_gpu as t; "
            "print('NAMES ' + json.dumps(t._profile_cases()))")
    proc = subprocess.run([sys.executable, "-c", code, str(here)], cwd=here.parent,
                          capture_output=True, text=True, timeout=600, check=False)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("NAMES ")]
    assert proc.returncode == 0 and lines, proc.stderr[-3000:]
    names = json.loads(lines[-1][len("NAMES "):])
    assert len(names) == len(MMA_CASES) + len(PATH_CASES), names
    for case, name in zip(MMA_CASES, names):
        assert case[-1] in name and "attn_" not in name, (case[:2], name)
    for (which, _, _), name in zip(PATH_CASES, names[len(MMA_CASES):]):
        assert ("attn_norm" if which == "short" else "attn_stream") in name, (which, name)


@pytest.mark.parametrize("which,B,N", PATH_CASES)
def test_attention_paths_run_the_wgmma_core(cuda, which, B, N):
    """At the paths' shapes each call takes the wgmma core's form and
    matches its plain version."""
    from smelter_tpu_torch.kernels import attention_short as sa
    from smelter_tpu_torch.kernels import flash_attention as fa

    mod = sa if which == "short" else fa
    fn = sa.short_attention if which == "short" else fa.flash_attention
    plain = sa.short_attention_plain if which == "short" else fa.flash_attention_plain
    q, k, v = (_bnhd(B, 12, N, 64, torch.bfloat16, cuda, s) for s in (0, 1, 2))
    assert mod.plan(q, k, v, torch.empty_like(q)).form == (
        "one_pass" if which == "short" else "streaming")
    _attention_check(fn, plain, (mod, "launches"), q, k, v, 0.125, 1e-2)


@pytest.mark.parametrize("geom", [(128, 197, 768, 12), (8, 1024, 128, 8), (8, 256, 256, 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_vit_attention_block_at_the_paths_shapes(cuda, geom, dtype):
    """ViT-B/16 at b128 and SD-UNet's two blocks at b8, on the attention
    core the short form shares, against the plain version."""
    B, N, D, H = geom
    _vit_check(_vit_operands(B, N, D, H, dtype, cuda), heads=H, eps=1e-6)


def test_attention_kernels_raise_on_bad_operands(cuda):
    from smelter_tpu_torch.kernels import attention_short as sa
    from smelter_tpu_torch.kernels import flash_attention as fa

    q = torch.randn(1, 2, 600, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # short: N past the 512 its rows hold
        sa.short_attention(q, q, q, scale=0.125)
    with pytest.raises(ValueError):  # short: unequal shapes
        sa.short_attention(q[:, :, :100], q[:, :, :50], q[:, :, :50], scale=0.125)
    with pytest.raises(ValueError):  # flash: k and v of other lengths
        fa.flash_attention(q, q, q[:, :, :10], scale=0.125)
    with pytest.raises(ValueError):  # flash: a head dim past 256
        big = torch.randn(1, 1, 8, 512, device=cuda, dtype=torch.bfloat16)
        fa.flash_attention(big, big, big)
    with pytest.raises(TypeError):  # mixed dtypes
        fa.flash_attention(q, q.float(), q.float())
    with pytest.raises(ValueError):  # rank 3
        fa.flash_attention(q[0], q[0], q[0])


def _mlp_operands_gpu(B, N, D, F, dtype, device, p_dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)

    def t(a, dt):
        return torch.from_numpy(a.astype(np.float32)).to(device, dt)

    return (t(rng.standard_normal((B, N, D)), dtype),
            t(1 + 0.1 * rng.standard_normal(D), p_dtype), t(0.1 * rng.standard_normal(D), p_dtype),
            t(rng.standard_normal((D, F)) / np.sqrt(D), dtype),
            t(0.1 * rng.standard_normal(F), p_dtype),
            t(rng.standard_normal((F, D)) / np.sqrt(F), dtype),
            t(0.1 * rng.standard_normal(D), p_dtype))


# (B, N, D, F): ViT-B/16's at batch 1, the CPU test's, and ragged rows and
# widths (not multiples of the 128 x 128 tile)
MLP_GEOMS = [(1, 197, 768, 3072), (2, 50, 64, 256), (3, 7, 136, 264)]


@pytest.mark.parametrize("geom", MLP_GEOMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("form", ["default", "post_ln_tanh", "no_residual", "bf16_params"])
def test_mlp_block_matches_plain(cuda, geom, dtype, form):
    """f32 within 1e-5 of the largest output (full f32, sums in other
    orders); 16-bit within 1e-2 (xn and h round to 8 or 11 bits after sums
    in other orders)."""
    from smelter_tpu_torch.kernels import mlp_block as mb

    p_dtype = dtype if form == "bf16_params" else torch.float32
    args = _mlp_operands_gpu(*geom, dtype, cuda, p_dtype)
    kw = dict(eps=1e-6, pre_ln=form != "post_ln_tanh", approximate=form == "post_ln_tanh",
              residual=form != "no_residual")
    before = mb.launches
    got = mb.mlp_block(*args, **kw)
    torch.cuda.synchronize()
    assert mb.launches == before + 1
    ref = mb.mlp_block_plain(*args, **kw)
    assert got.dtype == dtype and got.shape == args[0].shape
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


def test_mlp_block_raises_on_bad_operands(cuda):
    from smelter_tpu_torch.kernels import mlp_block as mb

    x, g, b, w1, b1, w2, b2 = _mlp_operands_gpu(1, 16, 64, 256, torch.bfloat16, cuda)
    with pytest.raises(TypeError):  # weights not in x's dtype
        mb.mlp_block(x, g, b, w1.float(), b1, w2, b2)
    with pytest.raises(ValueError):  # weights that do not chain
        mb.mlp_block(x, g, b, w1, b1, w2[:128], b2)
    with pytest.raises(ValueError):  # a width that is not a multiple of 8
        xs = torch.randn(1, 4, 60, device=cuda, dtype=torch.bfloat16)
        mb.mlp_block(xs, g[:60], b[:60], w1[:60], b1, w2[:, :60], b2[:60])
    with pytest.raises(TypeError):  # params of mixed dtypes
        mb.mlp_block(x, g.bfloat16(), b, w1, b1, w2, b2)


# (B, N, D, F): ViT-B/16 at batch 8 and SD-UNet-like widths, where both
# products take gemm_tma
MLP_TMA_GEOMS = [(8, 197, 768, 3072), (2, 1024, 320, 1280), (2, 256, 640, 2560)]


@pytest.mark.parametrize("geom", MLP_TMA_GEOMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("form", ["default", "post_ln_tanh", "no_residual", "bf16_params"])
def test_mlp_block_tma_form_matches_plain(cuda, geom, dtype, form):
    """FC1 and FC2 on gemm_tma (16-bit) or the full-f32 kernel (f32), as
    `mlp_block.plans` says: f32 within 1e-5 of the largest output, 16-bit
    within 1e-2; two calls equal."""
    from smelter_tpu_torch.kernels import mlp_block as mb

    B, N, D, F = geom
    forms = [p.form for p in mb.plans(B * N, D, F, dtype)]
    assert forms == (["mma"] * 2 if dtype == torch.float32 else ["tma"] * 2)
    p_dtype = dtype if form == "bf16_params" else torch.float32
    args = _mlp_operands_gpu(B, N, D, F, dtype, cuda, p_dtype, seed=D)
    kw = dict(eps=1e-6, pre_ln=form != "post_ln_tanh", approximate=form == "post_ln_tanh",
              residual=form != "no_residual")
    got = mb.mlp_block(*args, **kw)
    again = mb.mlp_block(*args, **kw)
    torch.cuda.synchronize()
    ref = mb.mlp_block_plain(*args, **kw)
    assert got.dtype == dtype and torch.equal(got, again)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


def test_hf_vit_on_the_card_matches_the_cpu(cuda):
    """The small HF-layout ViT (tests/torch_hf_vit.py) under use_pallas on
    the card: 2 short_attention launches a forward at 32 px (N 65), 2
    flash_attention at 96 px (N 577), and with fuse_mlp_block 2 mlp_block;
    f32 within 1e-4 of the CPU's largest logit."""
    import copy
    import sys
    from pathlib import Path

    import smelter_tpu_torch as stt
    from smelter_tpu_torch.frontend.torch_export import export_torch
    from smelter_tpu_torch.kernels import attention_short as sa
    from smelter_tpu_torch.kernels import flash_attention as fa
    from smelter_tpu_torch.kernels import mlp_block as mb
    from smelter_tpu_torch.passes.pass_manager import run_passes
    from smelter_tpu_torch.runtime.executor import CompiledModel

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_hf_vit as hf

    torch.backends.cudnn.allow_tf32 = False
    for image_size, counter in ((32, (sa, "launches")), (96, (fa, "launches"))):
        cfg = dict(image_size=image_size, patch=4, dim=128, depth=2, heads=2, mlp=512,
                   num_classes=10)
        m = hf.create(batch=2, **cfg)
        x = np.random.default_rng(0).standard_normal(hf.input_shape(2, **cfg)).astype(np.float32)
        g = export_torch(m, torch.from_numpy(x))
        ref = stt.compile(copy.deepcopy(g), stt.Config(use_pallas=True), device="cpu")(x)[0]
        model = stt.compile(copy.deepcopy(g), stt.Config(use_pallas=True), device="cuda")
        before = getattr(*counter)
        got = model(x)[0]
        assert getattr(*counter) == before + 2
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
        gm = stt.api._prepare(copy.deepcopy(g), None, True, "nhwc")
        run_passes(gm, ["fuse_mlp_block", "dce"])
        before = mb.launches
        got = CompiledModel(gm, stt.Config(device="cuda"))(x)[0]
        assert mb.launches == before + 2
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("m", [8, 128])
def test_dequant_composites_on_the_card(cuda, m):
    """FusedDequantMatMul's default routes: the int32 sums of
    `int32_matmul` (torch._int_mm, rows below 17 padded) equal the exact
    ones; the composites hold the kernels' plain versions (bf16 within 1e-2
    of the largest output: W * s is rounded to bf16 first)."""
    x, w, s = _operands(m, 1000, 2048, torch.bfloat16, cuda)
    xq, sr = im.quantize_rows(x)
    assert torch.equal(im.int32_matmul(xq, w), im.int8_matmul_plain(xq, w, sr, s,
                                                                    out_dtype=torch.int32))
    got = im.dequant_matmul_int8_reference(x, w, s)
    assert torch.equal(got, im.int8_matmul_plain(xq, w, sr, s, out_dtype=torch.bfloat16))
    got = dm.dequant_matmul_reference(x, w, s)
    ref = dm.dequant_matmul_plain(x, w, s)
    err = (got.float() - ref.float()).abs().max().item()
    assert got.dtype == torch.bfloat16 and err <= 1e-2 * ref.float().abs().max().item()


# -- convnext_block (ConvNeXt-T), cross_attn_block (SD-UNet) -------------------

def _t(a, dtype, device):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device, dtype)


def _cnx_operands(B, H, W, C, dtype, device, p_dtype=torch.float32, seed=0):
    """x, the depthwise weight and bias, LN gamma and beta, w1, b1, w2, b2 and
    a layer scale of 0.5 (not ConvNeXt's 1e-6 init, so the MLP shows)."""
    rng = np.random.default_rng(seed)
    F = 4 * C
    return (_t(rng.standard_normal((B, H, W, C)), dtype, device),
            _t(rng.standard_normal((7, 7, 1, C)) / 7, dtype, device),
            _t(0.1 * rng.standard_normal(C), p_dtype, device),
            _t(1 + 0.1 * rng.standard_normal(C), p_dtype, device),
            _t(0.1 * rng.standard_normal(C), p_dtype, device),
            _t(rng.standard_normal((C, F)) / np.sqrt(C), dtype, device),
            _t(0.1 * rng.standard_normal(F), p_dtype, device),
            _t(rng.standard_normal((F, C)) / np.sqrt(F), dtype, device),
            _t(0.1 * rng.standard_normal(C), p_dtype, device),
            _t(0.5 + 0.1 * rng.standard_normal(C), p_dtype, device))


def _close_to_plain(got, ref, dtype):
    """f32 within 1e-5 of the largest output (full f32, sums in other
    orders); 16-bit within 1e-2 (intermediates round to 8 or 11 bits after
    sums in other orders)."""
    assert got.dtype == dtype and got.shape == ref.shape
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


# (B, H, W, C): ConvNeXt-T's three fused stages at batch 8; stage 4; ragged
# rows (W not a multiple of the 4-pixel strip), and wide C whose f32 tile
# splits a row (3 tiles of 4 pixels and one of 2 at C 2048)
CNX_GEOMS = [(8, 56, 56, 96), (8, 28, 28, 192), (8, 14, 14, 384), (2, 7, 7, 768),
             (2, 9, 13, 40), (1, 3, 14, 2048)]


@pytest.mark.parametrize("geom", CNX_GEOMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("p_dtype", ["f32", "x"])
def test_convnext_block_matches_plain(cuda, geom, dtype, p_dtype):
    from smelter_tpu_torch.kernels import convnext_block as cb

    args = _cnx_operands(*geom, dtype, cuda, torch.float32 if p_dtype == "f32" else dtype)
    before = cb.launches
    got = cb.convnext_block(*args, eps=1e-6)
    torch.cuda.synchronize()
    assert cb.launches == before + 1
    _close_to_plain(got, cb.convnext_block_plain(*args, eps=1e-6), dtype)


@pytest.mark.parametrize("geom", [(64, 56, 56, 96), (64, 28, 28, 192), (64, 14, 14, 384)])
def test_convnext_block_stages_at_batch_64(cuda, geom):
    """ConvNeXt-T's three fused stages at the path's batch: FC1 and FC2 on
    gemm_tma (stage 1's FC2 N 96 too), against the plain version, and two
    calls bit-equal."""
    from smelter_tpu_torch.kernels import convnext_block as cb

    B, H, W, C = geom
    assert [p.form for p in cb.plans(B * H * W, C, 4 * C, torch.bfloat16)] == ["tma", "tma"]
    args = _cnx_operands(*geom, torch.bfloat16, cuda)
    got = cb.convnext_block(*args, eps=1e-6)
    again = cb.convnext_block(*args, eps=1e-6)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close_to_plain(got, cb.convnext_block_plain(*args, eps=1e-6), torch.bfloat16)


def test_convnext_block_raises_on_bad_operands(cuda):
    from smelter_tpu_torch.kernels import convnext_block as cb

    x, dw, db, g, b, w1, b1, w2, b2, gm = _cnx_operands(1, 8, 8, 64, torch.bfloat16, cuda)
    before = cb.launches
    with pytest.raises(ValueError):  # a 3x3 depthwise weight
        cb.convnext_block(x, dw[2:5, 2:5].contiguous(), db, g, b, w1, b1, w2, b2, gm)
    with pytest.raises(ValueError):  # C not a multiple of 8
        xs, dws, dbs, gs, bs, w1s, b1s, w2s, b2s, gms = _cnx_operands(1, 8, 8, 60,
                                                                      torch.bfloat16, cuda)
        cb.convnext_block(xs, dws, dbs, gs, bs, w1s, b1s, w2s, b2s, gms)
    with pytest.raises(TypeError):  # weights not in x's dtype
        cb.convnext_block(x, dw, db, g, b, w1.float(), b1, w2, b2, gm)
    with pytest.raises(TypeError):  # params of mixed dtypes
        cb.convnext_block(x, dw, db, g.bfloat16(), b, w1, b1, w2, b2, gm)
    with pytest.raises(ValueError):  # NCHW strides
        cb.convnext_block(x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), dw, db, g,
                          b, w1, b1, w2, b2, gm)
    assert cb.launches == before


def _xattn_operands(B, N, D, H, S, bk, dtype, device, p_dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    hd = D // H
    return (_t(rng.standard_normal((B, N, D)), dtype, device),
            _t(rng.standard_normal((D, D)) / np.sqrt(D), dtype, device),
            _t(rng.standard_normal((bk, H, S, hd)), dtype, device),
            _t(rng.standard_normal((bk, H, S, hd)), dtype, device),
            _t(rng.standard_normal((D, D)) / np.sqrt(D), dtype, device),
            _t(0.1 * rng.standard_normal(D), p_dtype, device))


# (B, N, D, H, S): SD-UNet's two blocks at batch 8 (hd 16 and 32, 16 keys),
# and ragged ones: rows not a multiple of the 64-row tile, S not a multiple
# of 16, hd 64 over 64 keys, D not a multiple of the 64-column weight pass
XATTN_GEOMS = [(8, 1024, 128, 8, 16), (8, 256, 256, 8, 16), (2, 37, 64, 4, 5),
               (3, 100, 192, 3, 40), (1, 70, 96, 3, 33), (2, 65, 128, 2, 64),
               (1, 10, 80, 5, 1)]


@pytest.mark.parametrize("geom", XATTN_GEOMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("bk", ["B", 1])
def test_cross_attn_block_matches_plain(cuda, geom, dtype, bk):
    from smelter_tpu_torch.kernels import cross_attn_block as xa

    B, N, D, H, S = geom
    args = _xattn_operands(B, N, D, H, S, B if bk == "B" else 1, dtype, cuda)
    for scale in (None, 0.3):
        before = xa.launches
        got = xa.cross_attn_block(*args, heads=H, scale=scale)
        torch.cuda.synchronize()
        assert xa.launches == before + 1
        _close_to_plain(got, xa.cross_attn_block_plain(*args, heads=H, scale=scale), dtype)


def test_cross_attn_block_bf16_bias(cuda):
    from smelter_tpu_torch.kernels import cross_attn_block as xa

    args = _xattn_operands(2, 50, 128, 8, 16, 2, torch.bfloat16, cuda, p_dtype=torch.bfloat16)
    got = xa.cross_attn_block(*args, heads=8)
    _close_to_plain(got, xa.cross_attn_block_plain(*args, heads=8), torch.bfloat16)


def test_cross_attn_block_raises_on_bad_operands(cuda):
    from smelter_tpu_torch.kernels import cross_attn_block as xa

    x, wq, k, v, wp, bp = _xattn_operands(2, 16, 128, 8, 16, 2, torch.bfloat16, cuda)
    before = xa.launches
    with pytest.raises(ValueError):  # hd 8
        x8, wq8, k8, v8, wp8, bp8 = _xattn_operands(2, 16, 64, 8, 16, 2, torch.bfloat16, cuda)
        xa.cross_attn_block(x8, wq8, k8, v8, wp8, bp8, heads=8)
    with pytest.raises(ValueError):  # 65 keys
        _, _, k65, v65, _, _ = _xattn_operands(2, 16, 128, 8, 65, 2, torch.bfloat16, cuda)
        xa.cross_attn_block(x, wq, k65, v65, wp, bp, heads=8)
    with pytest.raises(ValueError):  # Bk neither 1 nor B
        xa.cross_attn_block(x, wq, torch.cat([k, k]), torch.cat([v, v]), wp, bp, heads=8)
    with pytest.raises(ValueError):  # D above 256
        xw, wqw, kw, vw, wpw, bpw = _xattn_operands(1, 8, 512, 8, 16, 1, torch.bfloat16, cuda)
        xa.cross_attn_block(xw, wqw, kw, vw, wpw, bpw, heads=8)
    with pytest.raises(TypeError):  # k not in x's dtype
        xa.cross_attn_block(x, wq, k.float(), v, wp, bp, heads=8)
    assert xa.launches == before


# cross_attn_block's wgmma form at SD-UNet's two b8 shapes (hd 16 and 32),
# 16 keys and 7 (keys padded to 16 score -inf)
XATTN_SD = [(8, 1024, 128, 8), (8, 256, 256, 8)]


@pytest.mark.parametrize("geom", XATTN_SD)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("bk", ["B", 1])
@pytest.mark.parametrize("S", [16, 7])
def test_cross_attn_block_wgmma_form(cuda, geom, dtype, bk, S):
    """The wgmma form (a CTA a 64-row tile x a head group, the groups'
    partials of att Wp summed in a cluster) against the plain version, at
    least 128 CTAs, and the same bits from call to call."""
    from smelter_tpu_torch.kernels import cross_attn_block as xa

    B, N, D, H = geom
    args = _xattn_operands(B, N, D, H, S, B if bk == "B" else 1, dtype, cuda)
    p = xa.plan(args[0], args[2], H)
    assert p.form == "wgmma" and p.ctas >= 128 and p.cluster == D // 64
    before, wg_before = xa.launches, xa.forms["wgmma"]
    got = xa.cross_attn_block(*args, heads=H)
    again = xa.cross_attn_block(*args, heads=H)
    torch.cuda.synchronize()
    assert xa.launches == before + 2 and xa.forms["wgmma"] == wg_before + 2
    assert torch.equal(got, again)
    _close_to_plain(got, xa.cross_attn_block_plain(*args, heads=H), dtype)


@pytest.mark.parametrize("geom", XATTN_SD)
def test_cross_attn_block_rows_do_not_depend_on_batch_position(cuda, geom):
    """Image 3 alone (B 1) and inside B 8 (per-image k and v): equal bits,
    so neither the cluster's sum nor the CTA order depends on the batch."""
    from smelter_tpu_torch.kernels import cross_attn_block as xa

    B, N, D, H = geom
    x, wq, k, v, wp, bp = _xattn_operands(B, N, D, H, 16, B, torch.bfloat16, cuda, seed=5)
    full = xa.cross_attn_block(x, wq, k, v, wp, bp, heads=H)
    one = xa.cross_attn_block(x[3:4].contiguous(), wq, k[3:4].contiguous(),
                              v[3:4].contiguous(), wp, bp, heads=H)
    torch.cuda.synchronize()
    assert torch.equal(full[3:4], one)


def test_cross_attn_block_declined_shape_takes_the_mma_form(cuda):
    """D 96 (3 heads of 32) is no multiple of 64: the plan declines it and
    the mma.sync form runs, within the same tolerance."""
    from smelter_tpu_torch.kernels import cross_attn_block as xa

    args = _xattn_operands(2, 70, 96, 3, 16, 2, torch.bfloat16, cuda)
    assert xa.plan(args[0], args[2], 3).form == "mma"
    before = xa.forms["mma"]
    got = xa.cross_attn_block(*args, heads=3)
    torch.cuda.synchronize()
    assert xa.forms["mma"] == before + 1
    _close_to_plain(got, xa.cross_attn_block_plain(*args, heads=3), torch.bfloat16)


def test_small_convnext_and_sd_unet_on_the_card_match_the_cpu(cuda):
    """A small ConvNeXt with fuse_convnext_block (gate patched to 0: 5
    convnext_block launches a forward) and a small SD-UNet with the cross
    branch on (5 cross_attn_block; no vit_attention_block: D 32 and 64 are
    not multiples of the 128 the self-attention branch asks for); f32
    within 1e-4 of the CPU's largest output."""
    import copy

    import smelter_tpu_torch as stt
    from smelter_tpu_torch.kernels import convnext_block as cb
    from smelter_tpu_torch.kernels import cross_attn_block as xa
    from smelter_tpu_torch.models import convnext, sd_unet
    from smelter_tpu_torch.passes import vit_block as vbp
    from smelter_tpu_torch.passes.pass_manager import run_passes
    from smelter_tpu_torch.runtime.executor import CompiledModel

    torch.backends.cudnn.allow_tf32 = False
    gate, cross = vbp._MIN_TOKENS_X_DIM, vbp._CROSS_ENABLED
    vbp._MIN_TOKENS_X_DIM, vbp._CROSS_ENABLED = 0, True
    try:
        g, _m, shape = convnext.build(batch=2, image_size=64, dims=(32, 64, 128, 256),
                                      depths=(1, 1, 2, 1), num_classes=10)
        rng = np.random.default_rng(7)  # layer scales that show (not the 1e-6 init)
        for name, arr in g.initializers.items():
            if name.endswith("_gamma"):
                g.initializers[name] = rng.uniform(0.2, 0.6, arr.shape).astype(np.float32)
        gm = stt.api._prepare(g, None, True, "nhwc")
        run_passes(gm, ["fuse_convnext_block", "dce"])
        g2, _m, shape2 = sd_unet.build(batch=2, image_size=16, base=32, heads=2)
        gs = stt.api._prepare(g2, None, True, "nhwc")
    finally:
        vbp._MIN_TOKENS_X_DIM, vbp._CROSS_ENABLED = gate, cross
    for graph, shp, counter, n in ((gm, shape, cb, 5), (gs, shape2, xa, 5)):
        x = np.random.default_rng(0).standard_normal(shp).astype(np.float32)
        ref = CompiledModel(copy.deepcopy(graph), stt.Config(device="cpu"))(x)[0]
        before = counter.launches
        got = CompiledModel(graph, stt.Config(device="cuda"))(x)[0]
        assert counter.launches == before + n
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()



# -- qlinear_conv, dequant_conv (int8-static ResNet-50) -----------------------

# (N, C_in, H, W, C_out, k, stride, pad): ResNet-50's stem (C_in 3, 7x7/2),
# the bottleneck's 1x1, 3x3/1 and 3x3/2 and the 1x1/2 downsample at small
# maps, W not a multiple of 8, C_out 64 and not a multiple of 8, uneven pads.
QCONV_GEOMS = [(2, 3, 37, 45, 64, 7, 2, 3), (2, 64, 14, 14, 256, 1, 1, 0),
               (2, 64, 13, 11, 64, 3, 1, 1), (2, 128, 15, 15, 128, 3, 2, 1),
               (2, 256, 14, 14, 512, 1, 2, 0), (1, 48, 9, 10, 37, 3, 1, 1),
               (1, 5, 7, 9, 24, 4, 2, 1)]


def _qconv_operands(geom, device, seed=0, channels_last=True):
    n, cin, h, w, cout, k, _, _ = geom
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-128, 128, (n, cin, h, w), dtype=np.int8)).to(device)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    wq = torch.from_numpy(rng.integers(-127, 128, (cout, cin, k, k), dtype=np.int8)).to(device)
    wq = wq.contiguous(memory_format=torch.channels_last)  # OHWI, as params_from_numpy stores it
    # the sums' spread is about 5400 sqrt(K): outputs span the int8 grid
    m = rng.uniform(0.5, 1.5, cout) * 0.0074 / np.sqrt(cin * k * k)
    m = torch.from_numpy(m.astype(np.float32)).to(device)
    b = torch.from_numpy(rng.uniform(-20, 20, cout).astype(np.float32)).to(device)
    return x, wq, m, b


@pytest.mark.parametrize("geom", QCONV_GEOMS)
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("channels_last", [True, False])
def test_qlinear_conv_equals_plain(cuda, geom, bias, channels_last):
    """One launch, int8 outputs bit-equal to the plain version, channels-last;
    an input in another memory format, or one the plan reads unfolded (C_in
    3 on a wgmma form), is copied once (layout_copies)."""
    from smelter_tpu_torch.kernels import qlinear_conv as qc
    from smelter_tpu_torch.kernels import wgmma_plan

    x, wq, m, b = _qconv_operands(geom, cuda, channels_last=channels_last)
    n, cin, h, w, cout, k, s, p = geom
    kw = dict(stride=(s, s), pads=((p, p), (p, p)))
    unfold = wgmma_plan.qconv_plan(n, h, w, cin, cout, k, k, s, s, kw["pads"]).unfold
    before, copies = qc.launches, qc.layout_copies
    got = qc.qlinear_conv(x, wq, m, b if bias else None, **kw)
    torch.cuda.synchronize()
    assert qc.launches == before + 1
    assert qc.layout_copies == copies + (0 if channels_last and not unfold else 1)
    ref = qc.qlinear_conv_plain(x, wq, m, b if bias else None, **kw)
    assert got.dtype == torch.int8 and got.shape == ref.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, ref)
    assert len(torch.unique(got)) > 50  # the grid, not a clip


def test_qlinear_conv_sums_past_f32_integers_and_rounds_one_fma(cuda):
    """Sums beyond 2^24 (3x3x512 of 127 x 127: 7.4e7) convert to f32 with
    one rounding, and the crafted epilogue cases of the CPU tests (round
    apart as a fused multiply-add and as a product then a sum) round as one
    fused multiply-add."""
    from smelter_tpu_torch.kernels import qlinear_conv as qc

    x = torch.full((1, 512, 3, 3), 127, dtype=torch.int8, device=cuda)
    w = torch.full((8, 512, 3, 3), 127, dtype=torch.int8, device=cuda)
    w[1:] = -127
    m = torch.full((8,), 1.1e-6, device=cuda)
    got = qc.qlinear_conv(x, w, m, torch.zeros(8, device=cuda))
    assert torch.equal(got, qc.qlinear_conv_plain(x, w, m, torch.zeros(8, device=cuda)))
    cases = [(-27653, 3.0384628772735596, 27640), (-27601, 3.0384628772735596, 27640),
             (-28482, 3.3037209510803223, 28454), (-22608, 3.7256858348846436, 22639)]
    x = torch.zeros((len(cases), 256, 1, 1), dtype=torch.int8)
    for r, (acc, _, _) in enumerate(cases):
        rem = acc
        for i in range(256):
            x[r, i] = v = max(-127, min(127, rem))
            rem -= v
    ms = torch.tensor([c[1] for c in cases])
    bs = (torch.tensor([c[2] for c in cases], dtype=torch.float64) * ms.double()).float()
    w = torch.ones((len(cases), 256, 1, 1), dtype=torch.int8)
    got = qc.qlinear_conv(x.to(cuda), w.to(cuda), ms.to(cuda), bs.to(cuda)).cpu()
    assert torch.equal(got, qc.qlinear_conv_plain(x, w, ms, bs))
    acc = torch.tensor([c[0] for c in cases], dtype=torch.float32)
    fused = torch.round((acc.double() * ms.double() + bs.double()).float())
    assert torch.equal(torch.diagonal(got[:, :, 0, 0]).float(), fused)


# -- qlinear_conv's wgmma forms; the residual join ----------------------------

def _resnet50_conv_shapes(size: int = 224) -> list:
    """ResNet-50 v1.5's distinct convs: (C_in, C_out, k, stride, H_in)."""
    shapes = {(3, 64, 7, 2, size)}
    h, cin = size // 4, 64
    for width, blocks, stride in ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)):
        for i in range(blocks):
            s = stride if i == 0 else 1
            h_out = (h - 1) // s + 1
            shapes |= {(cin, width, 1, 1, h), (width, width, 3, s, h),
                       (width, 4 * width, 1, 1, h_out)}
            if i == 0:
                shapes.add((cin, 4 * width, 1, s, h))
            cin, h = 4 * width, h_out
    return sorted(shapes)


def _qconv_form_check(cuda, x, wq, m, b, stride, pads, relu, form):
    """One launch on the plan's `form`, int8 output equal to the plain
    version's, channels-last."""
    from smelter_tpu_torch.kernels import qlinear_conv as qc
    from smelter_tpu_torch.kernels import wgmma_plan

    n, cin, h, w = x.shape
    cout, _, kh, kw = wq.shape
    plan = wgmma_plan.qconv_plan(n, h, w, cin, cout, kh, kw, *stride, pads)
    assert plan.form == form
    before, by_form = qc.launches, dict(qc.forms)
    got = qc.qlinear_conv(x, wq, m, b, stride=stride, pads=pads, relu=relu)
    torch.cuda.synchronize()
    assert qc.launches == before + 1 and qc.forms[form] == by_form[form] + 1
    ref = qc.qlinear_conv_plain(x, wq, m, b, stride=stride, pads=pads, relu=relu)
    assert got.shape == ref.shape and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, ref)
    assert len(torch.unique(ref)) > 40  # the grid, not a clip


@pytest.mark.parametrize("shape", _resnet50_conv_shapes())
@pytest.mark.parametrize("relu", [False, True])
def test_qlinear_conv_wgmma_forms_at_resnet50_shapes(cuda, shape, relu):
    """Each of ResNet-50's 23 distinct convs at batch 4 on its wgmma form
    (1x1 stride 1 "gemm", the rest "im2col", the stem on its unfolded copy),
    with and without the Relu epilogue, equal to the plain version."""
    cin, cout, k, s, h = shape
    x, wq, m, b = _qconv_operands((4, cin, h, h, cout, k, s, k // 2), cuda)
    form = "gemm" if k == 1 and s == 1 else "im2col"
    _qconv_form_check(cuda, x, wq, m, b, (s, s), ((k // 2, k // 2),) * 2, relu, form)


# (N, C_in, H, W, C_out, k, stride, pads, form): the stem at an odd map, C_in
# 24 (mma.sync), odd H at stride 2 with C_out 192, C_out 80 (a 16-channel
# last tile), C_in 96 (K steps of 32), 5 channels unfolded on a 1x1, uneven
# pads at stride 2.
QCONV_ODD = [(2, 3, 37, 45, 64, 7, 2, ((3, 3), (3, 3)), "im2col"),
             (2, 24, 15, 15, 64, 3, 1, ((1, 1), (1, 1)), "mma"),
             (2, 64, 15, 17, 192, 3, 2, ((1, 1), (1, 1)), "im2col"),
             (2, 128, 13, 11, 80, 1, 1, ((0, 0), (0, 0)), "gemm"),
             (3, 96, 9, 9, 128, 3, 1, ((1, 1), (1, 1)), "im2col"),
             (2, 5, 14, 14, 96, 1, 1, ((0, 0), (0, 0)), "gemm"),
             (3, 64, 16, 15, 64, 3, 2, ((0, 1), (1, 0)), "im2col")]


@pytest.mark.parametrize("geom", QCONV_ODD)
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("bias", [True, False])
def test_qlinear_conv_forms_at_odd_shapes(cuda, geom, relu, bias):
    n, cin, h, w, cout, k, s, pads, form = geom
    x, wq, m, b = _qconv_operands((n, cin, h, w, cout, k, s, 0), cuda)
    _qconv_form_check(cuda, x, wq, m, b if bias else None, (s, s), pads, relu, form)


def test_qlinear_conv_takes_a_folded_padded_weight(cuda):
    """The stem with the weight unfolded once (`padded_weight`, as the fold
    makes it) equals the call that unfolds it itself and the plain
    version."""
    from smelter_tpu_torch.kernels import qlinear_conv as qc

    x, wq, m, b = _qconv_operands((2, 3, 64, 64, 64, 7, 2, 3), cuda, channels_last=False)
    kw = dict(stride=(2, 2), pads=((3, 3), (3, 3)))
    wpad = qc.padded_weight(wq)
    got = qc.qlinear_conv(x, wq, m, b, w_padded=wpad, **kw)
    assert torch.equal(got, qc.qlinear_conv(x, wq, m, b, **kw))
    assert torch.equal(got, qc.qlinear_conv_plain(x, wq, m, b, **kw))
    with pytest.raises(ValueError):  # not the unfolded weight
        qc.qlinear_conv(x, wq, m, b, w_padded=wq, **kw)


JOIN_SHAPES = [(2, 256, 56, 56), (2, 512, 28, 28), (2, 1024, 14, 14), (2, 2048, 7, 7),
               (3, 5, 7, 9), (1, 1, 1, 17)]


def _join_operands(shape, device, seed=0):
    rng = np.random.default_rng(seed)
    a, b = (torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8)).to(device)
            .contiguous(memory_format=torch.channels_last) for _ in range(2))
    s_a, s_b, s_y = (float(v) for v in rng.uniform(0.01, 0.08, 3).astype(np.float32))
    return a, b, s_a, s_b, float(np.float32(1 / np.float64(np.float32(s_y))))


@pytest.mark.parametrize("shape", JOIN_SHAPES)
@pytest.mark.parametrize("out", ["int8", "f32"])
def test_int8_join_equals_plain(cuda, shape, out):
    """The join kernel at ResNet-50's four join shapes (batch 2) and odd
    sizes (a tail past the 16-element chunks): one launch, equal to the
    plain version, in the inputs' channels-last layout."""
    from smelter_tpu_torch.kernels import int8_join as ij

    a, b, s_a, s_b, inv = _join_operands(shape, cuda)
    inv = inv if out == "int8" else None
    before, copies = ij.launches, ij.layout_copies
    got = ij.int8_join(a, b, s_a, s_b, inv)
    torch.cuda.synchronize()
    assert ij.launches == before + 1 and ij.layout_copies == copies
    ref = ij.int8_join_plain(a, b, s_a, s_b, inv)
    assert got.dtype == (torch.int8 if inv is not None else torch.float32)
    assert got.stride() == a.stride() and torch.equal(got, ref)


def test_int8_join_misaligned_and_mixed_layouts(cuda):
    """Bases off 16 bytes take the kernel's scalar loop; inputs of two
    layouts are brought to one (a counted copy); both equal the plain
    version."""
    from smelter_tpu_torch.kernels import int8_join as ij

    a, b, s_a, s_b, inv = _join_operands((2, 64, 9, 11), cuda, seed=1)
    flat_a = torch.cat([a.new_zeros(1), a.flatten()])[1:]
    flat_b = torch.cat([b.new_zeros(3), b.flatten()])[3:]
    assert flat_a.data_ptr() % 16 and flat_b.data_ptr() % 16
    for f32 in (False, True):
        inv_ = None if f32 else inv
        got = ij.int8_join(flat_a, flat_b, s_a, s_b, inv_)
        assert torch.equal(got, ij.int8_join_plain(flat_a, flat_b, s_a, s_b, inv_))
    copies = ij.layout_copies
    got = ij.int8_join(a, b.contiguous(), s_a, s_b, inv)
    assert ij.layout_copies == copies + 1
    assert torch.equal(got, ij.int8_join_plain(a, b, s_a, s_b, inv))


def test_int8_join_raises_on_bad_operands(cuda):
    """What the kernel does not take raises on the card; nothing falls back
    to the plain version."""
    from smelter_tpu_torch.kernels import int8_join as ij

    a, b, s_a, s_b, inv = _join_operands((2, 16, 4, 4), cuda)
    before = ij.launches
    with pytest.raises(TypeError):
        ij.int8_join(a.to(torch.float16), b, s_a, s_b, inv)
    with pytest.raises(ValueError):
        ij.int8_join(a, b[:, :8], s_a, s_b, inv)
    with pytest.raises(ValueError):
        ij.int8_join(a, b.cpu(), s_a, s_b, inv)
    assert ij.launches == before


def test_small_resnet_int8_static_fused_walk_on_the_card(cuda):
    """The port's small ResNet at width 64 and 64 px (its convs on the wgmma
    forms and, at the last stage's 2 x 2 maps, mma.sync) quantized on the
    CPU: the card's fused walk launches one qlinear_conv a QLinearConv and
    one int8_join a join, and every int8 edge it makes, the chain ends
    among them, equals the CPU's node-by-node walk."""
    import copy

    import smelter_tpu_torch as stt
    from smelter_tpu_torch.kernels import int8_join as ij
    from smelter_tpu_torch.kernels import qlinear_conv as qc
    from smelter_tpu_torch.models import resnet50
    from smelter_tpu_torch.runtime import chains
    from smelter_tpu_torch.runtime.executor import Executor

    g, _, shape = resnet50.build(batch=2, image_size=64, layers=(1, 1, 1, 1), width=64,
                                 num_classes=16)
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    gq = stt.compile(g, quant="int8-static", calibration_data=[(x,)], device="cpu").graph
    n_conv = sum(n.op_type == "QLinearConv" for n in gq.nodes)
    joins = sum(isinstance(grp, chains.Join) for grp in chains.groups(gq))
    assert joins == 4
    ex = Executor(copy.deepcopy(gq), stt.Config(device="cpu"))
    ref = ex.build_fn(return_all_edges=True)(ex.cast_params(ex.init_params()), x)
    ex = Executor(copy.deepcopy(gq), stt.Config(device="cuda"))
    before, j_before, by_form = qc.launches, ij.launches, dict(qc.forms)
    env = ex.build_fn(return_all_edges=True, fuse=True)(ex.cast_params(ex.init_params()), x)
    torch.cuda.synchronize()
    assert qc.launches == before + n_conv and ij.launches == j_before + joins
    assert qc.forms["gemm"] > by_form["gemm"] and qc.forms["im2col"] > by_form["im2col"]
    int8 = [k for k, v in env.items() if isinstance(v, torch.Tensor)
            and v.dtype == torch.int8 and k not in gq.initializers]
    assert len(int8) >= 20
    for k in int8:
        assert torch.equal(env[k].cpu(), ref[k]), k
    out = gq.output_names[0]
    assert (env[out].cpu() - ref[out]).abs().max() <= 1e-5 * ref[out].abs().max()


# (N, H, W, C_in, C_out, k, (ph0, ph1), (pw0, pw1)): ResNet-50's stride-1
# 3x3 at a small batch, the JAX tests' odd cases (5x5, VALID 11x9, W 28 with
# pad 1), C_in 3, C_out 64 and one not a multiple of 16, uneven pads.
DCONV_GEOMS = [(2, 14, 14, 64, 64, 3, (1, 1), (1, 1)), (2, 12, 12, 128, 128, 5, (2, 2), (2, 2)),
               (2, 11, 9, 128, 128, 3, (0, 0), (0, 0)), (1, 28, 28, 128, 128, 3, (1, 1), (1, 1)),
               (2, 17, 19, 3, 64, 3, (1, 1), (1, 1)), (1, 9, 10, 40, 37, 3, (0, 2), (1, 0))]


@pytest.mark.parametrize("geom", DCONV_GEOMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_dequant_conv_matches_plain(cuda, geom, dtype):
    """One launch; f32 within 1e-5 of the largest plain output (full f32,
    TF32 off in the plain conv), 16-bit within 1e-2 (f32 sums of exact
    products in other orders, one rounding each)."""
    from smelter_tpu_torch.kernels import dequant_conv as dc

    torch.backends.cudnn.allow_tf32 = False
    n, h, w, cin, cout, k, ph, pw = geom
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((n, h, w, cin), np.float32)).to(cuda, dtype)
    wq = torch.from_numpy(rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8)).to(cuda)
    s = torch.from_numpy(rng.uniform(1e-3, 1e-2, cout).astype(np.float32)).to(cuda)
    before = dc.launches
    got = dc.dequant_conv(x, wq, s, pads=(ph, pw))
    torch.cuda.synchronize()
    assert dc.launches == before + 1
    ref = dc.dequant_conv_plain(x, wq, s, pads=(ph, pw))
    assert got.dtype == dtype and got.shape == ref.shape
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err
    torch.backends.cudnn.allow_tf32 = True


# (N, H, W, C_in, C_out, k, (ph0, ph1), (pw0, pw1)) that take the wgmma form
# beyond ResNet-50's: uneven pads on a map that is not square (BN 128 and
# BN 64), 5x5 with C_in 64, and M 300 with 256-pixel tiles, whose last
# tile's second box starts past the last pixel.
DCONV_WGMMA_GEOMS = [(2, 9, 13, 64, 128, 3, (0, 2), (1, 0)),
                     (3, 10, 15, 128, 64, 3, (2, 0), (0, 1)),
                     (2, 12, 12, 64, 128, 5, (2, 2), (2, 2)),
                     (3, 10, 10, 64, 64, 3, (1, 1), (1, 1))]
RESNET_DCONV = [(8, 56, 56, 64, 64), (8, 28, 28, 128, 128), (8, 14, 14, 256, 256),
                (8, 7, 7, 512, 512)]


def _dconv_case(geom, dtype, device, unaligned=False, seed=3):
    n, h, w, cin, cout, k, ph, pw = geom
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, h, w, cin), np.float32)).to(device, dtype)
    if unaligned:  # the same values 2 bytes past a 16-byte boundary
        buf = torch.empty(x.numel() + 1, dtype=dtype, device=device)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(x.shape)
        assert x.data_ptr() % 16 != 0
    wq = torch.from_numpy(rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8)).to(device)
    s = torch.from_numpy(rng.uniform(1e-3, 1e-2, cout).astype(np.float32)).to(device)
    return x, wq, s, (ph, pw)


def _dconv_agrees(x, wq, s, pads):
    from smelter_tpu_torch.kernels import dequant_conv as dc

    torch.backends.cudnn.allow_tf32 = False
    before = dc.launches
    got = dc.dequant_conv(x, wq, s, pads=pads)
    torch.cuda.synchronize()
    assert dc.launches == before + 1
    ref = dc.dequant_conv_plain(x, wq, s, pads=pads)
    assert got.dtype == x.dtype and got.shape == ref.shape
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 1e-2 * ref.float().abs().max().item(), err
    torch.backends.cudnn.allow_tf32 = True
    return got


@pytest.mark.parametrize("shape", RESNET_DCONV)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("form", ["wgmma", "mma"])
def test_dequant_conv_resnet_shapes_in_both_forms(cuda, shape, dtype, form):
    """ResNet-50's four stride-1 3x3 convs at batch 8: aligned bases take
    the wgmma form (BN 64 at C_out 64, else 128), x 2 bytes off a 16-byte
    boundary the mma.sync form; both within 1e-2 of the largest plain
    output, and two calls bit-equal."""
    from smelter_tpu_torch.kernels import dequant_conv as dc
    from smelter_tpu_torch.kernels import wgmma_plan as wp

    n, h, w, cin, cout = shape
    geom = (n, h, w, cin, cout, 3, (1, 1), (1, 1))
    x, wq, s, pads = _dconv_case(geom, dtype, cuda, unaligned=form == "mma")
    p = wp.conv_plan(n, h, w, cin, cout, 3, 3, pads, aligned=form == "wgmma")
    assert p.form == form and (form == "mma" or p.bn == (64 if cout == 64 else 128))
    got = _dconv_agrees(x, wq, s, pads)
    assert torch.equal(got, dc.dequant_conv(x, wq, s, pads=pads))


@pytest.mark.parametrize("geom", DCONV_WGMMA_GEOMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_dequant_conv_wgmma_form_edges(cuda, geom, dtype):
    """Uneven pads, a 5x5 kernel and a last box past the last pixel on the
    wgmma form: within 1e-2 of the largest plain output."""
    from smelter_tpu_torch.kernels import wgmma_plan as wp

    n, h, w, cin, cout, k, ph, pw = geom
    assert wp.conv_plan(n, h, w, cin, cout, k, k, (ph, pw)).form == "wgmma"
    _dconv_agrees(*_dconv_case(geom, dtype, cuda))


def test_conv_kernels_raise_on_bad_operands(cuda):
    """A CUDA tensor of a form the kernels or QLinearConv's lowering do not
    take raises; it never falls back to a plain version."""
    import smelter_tpu_torch as stt
    from smelter_tpu_torch.ir.build import GraphBuilder
    from smelter_tpu_torch.ir.errors import NotSupportedError
    from smelter_tpu_torch.kernels import dequant_conv as dc
    from smelter_tpu_torch.kernels import qlinear_conv as qc

    x, wq, m, b = _qconv_operands((1, 16, 8, 8, 32, 3, 1, 1), cuda)
    before = qc.launches
    with pytest.raises(TypeError):  # uint8 activations
        qc.qlinear_conv(x.to(torch.uint8), wq, m, b)
    with pytest.raises(TypeError):  # scales of another length
        qc.qlinear_conv(x, wq, m[:5], b)
    with pytest.raises(ValueError):  # weights on the CPU
        qc.qlinear_conv(x, wq.cpu(), m, b)
    with pytest.raises(ValueError):  # an empty output
        qc.qlinear_conv(x, wq, m, b, stride=(1, 1), pads=((0, 0), (-8, 0)))
    assert qc.launches == before
    xf = torch.zeros(1, 8, 8, 16, device=cuda, dtype=torch.bfloat16)
    w8 = torch.zeros(3, 3, 16, 32, dtype=torch.int8, device=cuda)
    s = torch.ones(32, device=cuda)
    with pytest.raises(TypeError):  # int8 activations
        dc.dequant_conv(xf.to(torch.int8), w8, s)
    with pytest.raises(ValueError):  # C_in mismatch
        dc.dequant_conv(xf, w8[:, :, :8], s)
    with pytest.raises(TypeError):  # bf16 scales
        dc.dequant_conv(xf, w8, s.to(torch.bfloat16))
    # QLinearConv with groups 2 on the card
    bld = GraphBuilder("q", opset=17)
    xin = bld.input("x", (1, 8, 6, 6), 3)
    ins = [xin, bld.init(np.float32(0.1)), bld.init(np.int8(0)),
           bld.init(np.ones((8, 4, 3, 3), np.int8)), bld.init(np.ones(8, np.float32)),
           bld.init(np.zeros(8, np.int8)), bld.init(np.float32(0.1)), bld.init(np.int8(0))]
    g = bld.finish([bld.node("QLinearConv", ins, kernel_shape=[3, 3], group=2)])
    model = stt.CompiledModel(g, stt.Config(device="cuda"))
    with pytest.raises(NotSupportedError):
        model(np.zeros((1, 8, 6, 6), np.int8))


@pytest.mark.parametrize("op,attrs", [("Relu", {}),
                                      ("MaxPool", {"kernel_shape": [3, 3], "strides": [2, 2],
                                                   "pads": [1, 1, 1, 1]})])
def test_int8_relu_and_max_pool_on_channels_last_memory(cuda, op, attrs):
    """The int8 twins on channels-last CUDA memory, as the int8 convs hand it
    over (a 112 x 112 map, as after ResNet-50's stem): equal to the CPU,
    and the output stays channels-last."""
    from smelter_tpu_torch.ir.graph import Graph, Node
    from smelter_tpu_torch.ops.registry import Ctx, lower_node

    x = torch.from_numpy(np.random.default_rng(2).integers(-128, 128, (2, 64, 112, 112),
                                                          dtype=np.int8))
    outs = {}
    for dev in ("cpu", cuda):
        xd = x.to(dev).contiguous(memory_format=torch.channels_last)
        ctx = Ctx(Graph(), {"x": xd}, None, device=dev)
        lower_node(ctx, Node(op, ["x"], ["y"], attrs=dict(attrs)))
        outs[str(dev)] = ctx.get("y")
    got = outs[str(cuda)]
    assert got.dtype == torch.int8 and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got.cpu(), outs["cpu"])


def test_small_resnet_int8_static_on_the_card_matches_the_cpu(cuda):
    """The port's small ResNet at width 32 (17 QLinearConv, one a 4x4/2
    packed conv; every conv quantized, so no float conv sums in another
    order) compiled with quant="int8-static" on the CPU, then the same
    quantized graph on the card: every int8 edge equal (the kernel's sums
    are exact, its epilogue rounds the plain version's fused multiply-add,
    and the float ops between are elementwise in f32); the logits within
    1e-5 of the largest (the global pool's order). One qlinear_conv launch
    a QLinearConv; the stem's NCHW input is copied to channels-last."""
    import copy

    import smelter_tpu_torch as stt
    from smelter_tpu_torch.kernels import qlinear_conv as qc
    from smelter_tpu_torch.models import resnet50
    from smelter_tpu_torch.runtime.executor import Executor

    g, _, shape = resnet50.build(batch=2, image_size=32, layers=(1, 1, 1, 1), width=32,
                                 num_classes=16)
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    gq = stt.compile(g, quant="int8-static", calibration_data=[(x,)], device="cpu").graph
    assert "Conv" not in [n.op_type for n in gq.nodes]
    n_conv = sum(n.op_type == "QLinearConv" for n in gq.nodes)
    envs = {}
    for dev in ("cpu", "cuda"):
        ex = Executor(copy.deepcopy(gq), stt.Config(device=dev))
        before, copies = qc.launches, qc.layout_copies
        env = ex.build_fn(return_all_edges=True)(ex.cast_params(ex.init_params()), x)
        envs[dev] = {k: v.cpu() for k, v in env.items() if isinstance(v, torch.Tensor)}
        if dev == "cuda":
            assert qc.launches == before + n_conv and qc.layout_copies >= copies + 1
    int8 = [k for k, v in envs["cpu"].items() if v.dtype == torch.int8 and k not in gq.initializers]
    assert len(int8) >= 30
    for k in int8:
        assert torch.equal(envs["cpu"][k], envs["cuda"][k]), k
    out = gq.output_names[0]
    ref, got = envs["cpu"][out], envs["cuda"][out]
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("to", [torch.int8, torch.uint8, torch.int16, torch.int32])
def test_saturating_cast_on_the_card_matches_the_cpu(cuda, dtype, to):
    """Cast / CastLike's clamp (XLA's convert): CUDA's own float-to-int
    conversion need not agree with the CPU's past the range, so the card
    takes the same clamp first."""
    from smelter_tpu_torch.utils.dtypes import saturating_cast

    nan, inf = float("nan"), float("inf")
    x = torch.tensor([1e3, -1e3, 300.0, 3e9, -3e9, nan, inf, -inf, 126.9, -128.7, -0.5, 0.0,
                      65504.0, 2.5e38]).to(dtype)
    x = torch.cat([x, torch.from_numpy(np.random.default_rng(0).standard_normal(4096) * 3e4)
                   .to(dtype)])
    got = saturating_cast(x.to(cuda), to)
    assert got.dtype == to and torch.equal(got.cpu(), saturating_cast(x, to))


# -- the ring kernels: W ranks on one card ----------------------------------

_RING_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 2e-3}


def _ring_on_card(W):
    from smelter_tpu_torch.parallel import Mesh

    return Mesh(["cuda:0"] * W, ("tp",)).rings("tp")[0]


def _ring_shards(W, shape_x, shape_w, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == torch.int8:
        def draw(shape):
            return torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)).cuda()
    else:
        def draw(shape):
            return torch.from_numpy(rng.standard_normal(shape, np.float32)).to("cuda", dtype)
    return [draw(shape_x) for _ in range(W)], [draw(shape_w) for _ in range(W)]


def _agree(got, ref, dtype):
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        if dtype == torch.int8:
            assert torch.equal(g, r)
        else:
            err = (g.float() - r.float()).abs().max().item()
            assert err <= _RING_TOL[dtype] * r.float().abs().max().item(), err


@pytest.mark.parametrize("W", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.int8])
@pytest.mark.parametrize("ml,k,nl", [(37, 70, 33), (64, 128, 96)])
def test_collective_matmul_ag_matches_plain(cuda, W, dtype, ml, k, nl):
    """Odd and aligned shard shapes; int8 exact, including sums that wrap."""
    from smelter_tpu_torch.kernels import collective_matmul as cm

    ring = _ring_on_card(W)
    xs, ws = _ring_shards(W, (ml, k), (k, nl), dtype, seed=W)
    before = cm.ag_launches
    got = cm.collective_matmul_ag(xs, ws, ring)
    assert cm.ag_launches == before + W * W
    _agree(got, cm.collective_matmul_ag_plain(xs, ws, ring), dtype)


@pytest.mark.parametrize("W", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.int8])
@pytest.mark.parametrize("mc,kl,n", [(37, 70, 33), (64, 128, 96)])
def test_collective_matmul_rs_matches_plain(cuda, W, dtype, mc, kl, n):
    """int8 exact: the int32 sums, f32 on the wire, clamped at the end."""
    from smelter_tpu_torch.kernels import collective_matmul as cm

    ring = _ring_on_card(W)
    xs, ws = _ring_shards(W, (mc * W, kl), (kl, n), dtype, seed=10 + W)
    before = cm.rs_launches
    got = cm.collective_matmul_rs(xs, ws, ring)
    assert cm.rs_launches == before + W * W
    _agree(got, cm.collective_matmul_rs_plain(xs, ws, ring), dtype)


# Both model widths of phase 13 (the full M over W ranks): ViT-B/16 b128's
# MLP up (25,216 x 768 @ 768 x 3,072) and llama_1b's FFN (4,096 x 2,048 @
# 2,048 x 5,632); their steps take the persistent TMA kernel.
AG_WIDTHS = {"vit_b16": (25216, 768, 3072), "llama_1b": (4096, 2048, 5632)}


@pytest.mark.parametrize("W", [1, 2, 4, 8])
@pytest.mark.parametrize("model", list(AG_WIDTHS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_collective_matmul_ag_at_model_widths(cuda, W, model, dtype):
    """Against the plain version, and two calls bit-equal."""
    from smelter_tpu_torch.kernels import collective_matmul as cm

    M, K, N = AG_WIDTHS[model]
    ring = _ring_on_card(W)
    xs, ws = _ring_shards(W, (M // W, K), (K, N // W), dtype, seed=W)
    ws = [w * K ** -0.5 for w in ws]
    got = cm.collective_matmul_ag(xs, ws, ring)
    _agree(got, cm.collective_matmul_ag_plain(xs, ws, ring), dtype)
    again = cm.collective_matmul_ag(xs, ws, ring)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("W", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_collective_matmul_ag_odd_shapes_repeat_bit_for_bit(cuda, W, dtype):
    """Phase 13's odd shards (37 x 70 @ 70 x 33) take the cluster form, its
    K split summed in a fixed order: two calls agree bit for bit."""
    from smelter_tpu_torch.kernels import collective_matmul as cm

    ring = _ring_on_card(W)
    xs, ws = _ring_shards(W, (37, 70), (70, 33), dtype, seed=30 + W)
    got = cm.collective_matmul_ag(xs, ws, ring)
    again = cm.collective_matmul_ag(xs, ws, ring)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _agree(got, cm.collective_matmul_ag_plain(xs, ws, ring), dtype)


# Both model widths of phase 13 for rs (the full x over W ranks): ViT-B/16
# b128's MLP down (25,216 x 3,072 @ 3,072 x 768) and llama_1b's FFN down
# (4,096 x 5,632 @ 5,632 x 2,048); over 4 ranks their steps take the
# persistent TMA kernel.
RS_WIDTHS = {"vit_b16": (25216, 3072, 768), "llama_1b": (4096, 5632, 2048)}


@pytest.mark.parametrize("W", [1, 2, 4, 8])
@pytest.mark.parametrize("model", list(RS_WIDTHS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_collective_matmul_rs_at_model_widths(cuda, W, model, dtype):
    """Against the plain version, and two calls bit-equal; at 4 ranks each
    step takes the tma form."""
    from smelter_tpu_torch.kernels import collective_matmul as cm
    from smelter_tpu_torch.kernels import wgmma_plan as wp

    M, K, N = RS_WIDTHS[model]
    if W == 4:
        assert wp.plan(M // W, N, K // W, int8_b=False).form == "tma"
    ring = _ring_on_card(W)
    xs, ws = _ring_shards(W, (M, K // W), (K // W, N), dtype, seed=40 + W)
    ws = [w * K ** -0.5 for w in ws]
    got = cm.collective_matmul_rs(xs, ws, ring)
    _agree(got, cm.collective_matmul_rs_plain(xs, ws, ring), dtype)
    again = cm.collective_matmul_rs(xs, ws, ring)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("W", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_collective_matmul_rs_odd_shapes_repeat_bit_for_bit(cuda, W, dtype):
    """Phase 13's odd shards (37 W x 70 @ 70 x 33) take the cluster form:
    two calls agree bit for bit, and with the plain version."""
    from smelter_tpu_torch.kernels import collective_matmul as cm
    from smelter_tpu_torch.kernels import wgmma_plan as wp

    assert wp.plan(37, 33, 70, int8_b=False).form == "cluster"
    ring = _ring_on_card(W)
    xs, ws = _ring_shards(W, (37 * W, 70), (70, 33), dtype, seed=50 + W)
    got = cm.collective_matmul_rs(xs, ws, ring)
    again = cm.collective_matmul_rs(xs, ws, ring)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _agree(got, cm.collective_matmul_rs_plain(xs, ws, ring), dtype)


# One rs step's shapes (M, N, K) in each form of the wgmma core.
RS_STEP_FORMS = {"tma": (1024, 1152, 768), "cluster": (37, 33, 70)}


@pytest.mark.parametrize("form", list(RS_STEP_FORMS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_rs_step_recv_may_alias_out(cuda, form, dtype):
    """out = recv + a @ b in f32 with out and recv one buffer (the ring's
    middle steps) equals the step with two buffers, bit for bit."""
    from smelter_tpu_torch.kernels import _build
    from smelter_tpu_torch.kernels import collective_matmul as cm
    from smelter_tpu_torch.kernels import wgmma_plan as wp

    M, N, K = RS_STEP_FORMS[form]
    assert wp.plan(M, N, K, int8_b=False).form == form
    rng = np.random.default_rng(60)
    a = torch.from_numpy(rng.standard_normal((M, K), np.float32)).to(cuda, dtype)
    b = torch.from_numpy(rng.standard_normal((K, N), np.float32)).to(cuda, dtype)
    recv = torch.from_numpy(rng.standard_normal((M, N), np.float32) * 8).to(cuda)
    lib = _build.library("collective_matmul")
    apart = torch.empty_like(recv)
    cm._launch(lib, a, b, recv, apart, True, "rs step")
    held = recv.clone()
    cm._launch(lib, a, b, held, held, True, "rs step")
    torch.cuda.synchronize()
    assert torch.equal(held, apart)
    ref = recv + a.float() @ b.float()
    assert (apart - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("form", list(RS_STEP_FORMS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_rs_last_step_rounds_once(cuda, form, dtype):
    """Integer-valued shards keep every f32 sum exact, so the last step's
    output must equal the plain version's f32 sum rounded once; rounding
    the step's own product to x's type before the add (twice) differs."""
    from smelter_tpu_torch.kernels import collective_matmul as cm

    W = 4
    M, N, K = RS_STEP_FORMS[form]
    r = int((3e4 / (W * K) ** 0.5) ** 0.5)  # sums about 1e4: past both types' integers
    rng = np.random.default_rng(61)
    xs = [torch.from_numpy(rng.integers(-r, r + 1, (M * W, K)).astype(np.float32))
          .to(cuda, dtype) for _ in range(W)]
    ws = [torch.from_numpy(rng.integers(-r, r + 1, (K, N)).astype(np.float32)).to(cuda, dtype)
          for _ in range(W)]
    ring = _ring_on_card(W)
    got = cm.collective_matmul_rs(xs, ws, ring)
    torch.cuda.synchronize()
    twice = 0
    for i in range(W):
        rows = slice(i * M, (i + 1) * M)
        parts = [xs[j][rows].double() @ ws[j].double() for j in range(W)]
        exact = sum(parts)
        assert exact.abs().max().item() < 2 ** 24  # every f32 partial sum exact
        assert torch.equal(got[i], exact.float().to(dtype))
        recv = (exact - parts[i]).float()  # rank i adds chunk i's last partial
        twice += int((recv + parts[i].float().to(dtype).float()).to(dtype)
                     .ne(exact.float().to(dtype)).sum())
    assert twice > 0


@pytest.mark.parametrize("W", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_ring_attention_rdma_matches_plain(cuda, W, dtype, D):
    """B 2, H 3, odd Nl (37): each rank's output against the plain ring."""
    from smelter_tpu_torch.kernels import ring_attention_rdma as ra

    ring = _ring_on_card(W)
    rng = np.random.default_rng(W * D)
    qs, ks, vs = ([torch.from_numpy(rng.standard_normal((2, 3, 37, D), np.float32))
                   .to("cuda", dtype) for _ in range(W)] for _ in range(3))
    before = ra.launches
    got = ra.ring_attention_rdma(qs, ks, vs, ring, scale=D ** -0.5)
    assert ra.launches == before + W * W
    _agree(got, ra.ring_attention_rdma_plain(qs, ks, vs, ring, scale=D ** -0.5), dtype)


@pytest.mark.parametrize("W", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_ring_attention_rdma_streaming_tiles(cuda, W, dtype, D):
    """The streaming form over Nl 300 (two full 128-key tiles and a ragged
    one, 128-row CTAs, the last part-empty), B 2, H 3: the f32 state
    carried across W steps, each rank's output against the plain ring."""
    from smelter_tpu_torch.kernels import attention_plan as ap
    from smelter_tpu_torch.kernels import ring_attention_rdma as ra

    assert ap.ring_plan(300, 6, D, sixteen_bit=True).form == "streaming"
    ring = _ring_on_card(W)
    rng = np.random.default_rng(W * D + 1)
    qs, ks, vs = ([torch.from_numpy(rng.standard_normal((2, 3, 300, D), np.float32) * 2)
                   .to("cuda", dtype) for _ in range(W)] for _ in range(3))
    before = ra.launches
    got = ra.ring_attention_rdma(qs, ks, vs, ring, scale=D ** -0.5)
    assert ra.launches == before + W * W
    _agree(got, ra.ring_attention_rdma_plain(qs, ks, vs, ring, scale=D ** -0.5), dtype)


def test_ring_kernels_refuse_what_they_do_not_take(cuda):
    from smelter_tpu_torch.kernels import collective_matmul as cm
    from smelter_tpu_torch.kernels import ring_attention_rdma as ra

    ring = _ring_on_card(2)
    xs, ws = _ring_shards(2, (8, 16), (16, 8), torch.bfloat16, seed=0)
    with pytest.raises(TypeError):
        cm.collective_matmul_ag(xs, [w.float() for w in ws], ring)
    with pytest.raises(TypeError):  # int8 x needs an int8 w
        cm.collective_matmul_rs([x.to(torch.int8) for x in xs], ws, ring)
    with pytest.raises(ValueError, match="does not split"):
        cm.collective_matmul_rs([x[:7] for x in xs], ws, ring)
    with pytest.raises(ValueError, match="contiguous"):
        cm.collective_matmul_ag([x.t().contiguous().t() for x in xs], ws, ring)
    with pytest.raises(ValueError, match="lie on"):
        cm.collective_matmul_ag([xs[0], xs[1].cpu()], ws, ring)
    qs = [torch.zeros(1, 2, 8, 48, device="cuda", dtype=torch.bfloat16)] * 2
    with pytest.raises(ValueError, match="head dim 48"):
        ra.ring_attention_rdma(qs, qs, qs, ring)
    qs = [torch.zeros(1, 2, 8, 64, device="cuda", dtype=torch.bfloat16)] * 2
    with pytest.raises(TypeError):
        ra.ring_attention_rdma(qs, [q.float() for q in qs], qs, ring)
