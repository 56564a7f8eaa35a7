"""The plain versions of the port's kernels against the JAX package's.

On the CPU the port's wrappers take their plain versions; the JAX side runs
its Pallas kernels in interpret mode (as its own tests do) and its XLA
references. Shapes include ragged edges: M, N and K not multiples of the
tiles of either implementation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smelter_tpu.kernels import convnext_block as jcb
from smelter_tpu.kernels import dequant_conv as jdc
from smelter_tpu.kernels import dequant_matmul as jdm
from smelter_tpu.kernels import int8_matmul as jim
from smelter_tpu.kernels import layer_norm as jln
from smelter_tpu.kernels import max_unpool as jmu
from smelter_tpu.kernels import pixel_conv as jpc
from smelter_tpu.kernels import vit_block as jvb
from smelter_tpu_torch.kernels import convnext_block as cb
from smelter_tpu_torch.kernels import cross_attn_block as xa
from smelter_tpu_torch.kernels import dequant_conv as dc
from smelter_tpu_torch.kernels import dequant_matmul as dm
from smelter_tpu_torch.kernels import int8_matmul as im
from smelter_tpu_torch.kernels import layer_norm as ln
from smelter_tpu_torch.kernels import max_unpool as mu
from smelter_tpu_torch.kernels import pixel_conv as pc
from smelter_tpu_torch.kernels import qlinear_conv as qc
from smelter_tpu_torch.kernels import vit_block as vb
from smelter_tpu_torch.passes.vit_block import pack_qkv_weights

SHAPES = [(2, 16, 64), (37, 100, 70), (130, 257, 300), (8, 1000, 2048)]


def _operands(m, n, k, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.integers(-127, 128, (k, n), dtype=np.int8)
    s = rng.uniform(1e-3, 2e-2, n).astype(np.float32)
    return x, w, s


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequant_matmul_plain_matches_jax(shape, dtype):
    m, n, k = shape
    x, w, s = _operands(m, n, k)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = dm.dequant_matmul(xt, torch.from_numpy(w), torch.from_numpy(s))
    assert dm.launches == 0  # CPU tensors never reach the kernel
    assert got.dtype == xt.dtype and got.shape == (m, n)
    got = got.float().numpy()
    xj = jnp.asarray(x).astype(dtype)
    # f32: both sum in f32 in other orders -> 1e-5 of the largest output.
    # bf16: the outputs round to 8 mantissa bits after sums in other orders
    # (the reference rounds W*s to bf16 first) -> 1e-2 of the largest.
    tol = {"float32": 1e-5, "bfloat16": 1e-2}[dtype]
    for ref in (jdm.dequant_matmul(xj, jnp.asarray(w), jnp.asarray(s), interpret=True),
                jdm.dequant_matmul_reference(xj, jnp.asarray(w), jnp.asarray(s))):
        ref = np.asarray(ref.astype(jnp.float32))
        assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_bit_equal(dtype):
    x, _, _ = _operands(33, 1, 300, seed=1)
    x[3] = 0.0  # an all-zero row takes the 1e-30 floor
    x[5, :4] = [0.5, -1.5, 2.5, 127.0]  # half-way values round to even
    q, s = im.quantize_rows(torch.from_numpy(x).to(getattr(torch, dtype)))
    qj, sj = jim.quantize_rows(jnp.asarray(x).astype(dtype))
    assert np.array_equal(q.numpy(), np.asarray(qj))
    assert s.numpy().tobytes() == np.asarray(sj).tobytes()


@pytest.mark.parametrize("shape", SHAPES)
def test_int8_matmul_plain_matches_jax(shape):
    m, n, k = shape
    x, w, s = _operands(m, n, k, seed=2)
    xq, sr = im.quantize_rows(torch.from_numpy(x))
    wt, st_ = torch.from_numpy(w), torch.from_numpy(s)
    acc = im.int8_matmul(xq, wt, sr, st_, out_dtype=torch.int32)
    acc_j = np.matmul(xq.numpy().astype(np.int64), w.astype(np.int64))
    assert acc.dtype == torch.int32 and np.array_equal(acc.numpy(), acc_j)
    got = im.int8_matmul(xq, wt, sr, st_, out_dtype=torch.float32).numpy()
    args = (jnp.asarray(xq.numpy()), jnp.asarray(w), jnp.asarray(sr.numpy()), jnp.asarray(s))
    ref_kernel = np.asarray(jim.int8_matmul(*args, out_dtype=jnp.float32, interpret=True))
    ref_plain = np.asarray(jim.int8_matmul_reference(*args, out_dtype=jnp.float32))
    # exact integer sums and the same two f32 multiplies: equal outputs
    assert np.array_equal(got, ref_kernel) and np.array_equal(got, ref_plain)
    assert im.launches == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequant_matmul_int8_matches_jax(dtype):
    x, w, s = _operands(19, 130, 257, seed=4)
    got = im.dequant_matmul_int8(torch.from_numpy(x).to(getattr(torch, dtype)),
                                 torch.from_numpy(w), torch.from_numpy(s))
    xj = jnp.asarray(x).astype(dtype)
    for ref in (jim.dequant_matmul_int8(xj, jnp.asarray(w), jnp.asarray(s), interpret=True),
                jim.dequant_matmul_int8_xla(xj, jnp.asarray(w), jnp.asarray(s))):
        assert np.array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_meta_tensors_take_the_plain_version():
    x = torch.empty(5, 64, device="meta", dtype=torch.bfloat16)
    w = torch.empty(64, 10, device="meta", dtype=torch.int8)
    s = torch.empty(10, device="meta")
    assert dm.dequant_matmul(x, w, s).shape == (5, 10)
    assert im.dequant_matmul_int8(x, w, s).shape == (5, 10)
    assert dm.launches == 0 and im.launches == 0
    xv = torch.empty(2, 16, 128, device="meta", dtype=torch.bfloat16)
    p = torch.empty(128, device="meta", dtype=torch.bfloat16)
    assert ln.fused_layer_norm(xv, p, p).shape == xv.shape
    assert ln.residual_layer_norm(xv, xv, p, p)[1].shape == xv.shape
    wpk = torch.empty(3, 128, 128, device="meta", dtype=torch.bfloat16)
    out = vb.vit_attention_block(xv, p, p, wpk, torch.empty(1, 3, 128, device="meta"),
                                 torch.empty(128, 128, device="meta", dtype=torch.bfloat16), p,
                                 heads=4)
    assert out.shape == xv.shape and out.dtype == torch.bfloat16
    assert ln.fused_launches == 0 and ln.residual_launches == 0 and vb.launches == 0


# -- LayerNorm ---------------------------------------------------------------

def _ln_operands(m, d, seed=5):
    rng = np.random.default_rng(seed)
    x, skip = ((rng.standard_normal((m, d)) * 2 + 0.5).astype(np.float32) for _ in range(2))
    g = (rng.standard_normal(d) * 0.1 + 1).astype(np.float32)
    b = (rng.standard_normal(d) * 0.1).astype(np.float32)
    return x, skip, g, b


@pytest.mark.parametrize("shape", [(16, 128), (24, 768), (2, 4, 384)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_plain_matches_pallas(shape, dtype):
    """Both kernels' plain versions against the Pallas kernels in interpret
    mode, inside the entry points' shape rule."""
    x, skip, g, b = _ln_operands(int(np.prod(shape[:-1])), shape[-1])
    x, skip = x.reshape(shape), skip.reshape(shape)
    tdt = getattr(torch, dtype)
    xt, st_ = (torch.from_numpy(a).to(tdt) for a in (x, skip))
    xj, sj = (jnp.asarray(a).astype(dtype) for a in (x, skip))
    gt, bt, gj, bj = torch.from_numpy(g), torch.from_numpy(b), jnp.asarray(g), jnp.asarray(b)
    y = ln.fused_layer_norm(xt, gt, bt, eps=1e-6)
    s, y2 = ln.residual_layer_norm(xt, st_, gt, bt, eps=1e-6)
    assert ln.fused_launches == 0 and ln.residual_launches == 0
    yj = jln.fused_layer_norm(xj, gj, bj, eps=1e-6, interpret=True)
    sj2, y2j = jln.residual_layer_norm(xj, sj, gj, bj, eps=1e-6, interpret=True)
    # the carry: one rounding of the exact f32 sum in both
    assert np.array_equal(s.float().numpy(), np.asarray(sj2.astype(jnp.float32)))
    # f32: statistics summed in other orders -> 1e-5 of the largest output;
    # bf16: one rounding of outputs that agree to f32 precision -> 1e-2.
    tol = {"float32": 1e-5, "bfloat16": 1e-2}[dtype]
    for got, want in ((y, yj), (y2, y2j)):
        assert got.dtype == tdt and tuple(got.shape) == shape
        want = np.asarray(want.astype(jnp.float32))
        assert np.abs(got.float().numpy() - want).max() <= tol * np.abs(want).max()


def test_layer_norm_outside_the_shape_rule_takes_the_composite():
    """D % 128 != 0 or a row count that is not a multiple of 8: the JAX
    entry points take their composite, whose arithmetic the port's plain
    version (the CPU's route at every shape) shares."""
    for m, d in ((12, 96), (6, 128)):
        x, skip, g, b = _ln_operands(m, d)
        y = ln.fused_layer_norm(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b))
        yj = np.asarray(jln.fused_layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                                             interpret=True))
        assert np.abs(y.numpy() - yj).max() <= 1e-5 * np.abs(yj).max()
        s, y2 = ln.residual_layer_norm(*(torch.from_numpy(a) for a in (x, skip, g, b)))
        sj, y2j = jln.residual_layer_norm(*(jnp.asarray(a) for a in (x, skip, g, b)),
                                          interpret=True)
        assert np.array_equal(s.numpy(), np.asarray(sj))
        assert np.abs(y2.numpy() - np.asarray(y2j)).max() <= 1e-5 * np.abs(y2j).max()


# -- vit_attention_block -----------------------------------------------------

def _vit_operands(B, N, D, H, seed=0):
    """tests/test_vit_block.py's operands (f32 on the host), packed."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, N, D)) * 0.5).astype(np.float32)
    g = (rng.standard_normal(D) * 0.1 + 1).astype(np.float32)
    b = (rng.standard_normal(D) * 0.1).astype(np.float32)
    wqkv = (rng.standard_normal((D, 3 * D)) / np.sqrt(D)).astype(np.float32)
    bqkv = (rng.standard_normal(3 * D) * 0.02).astype(np.float32)
    wp = (rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32)
    bp = (rng.standard_normal(D) * 0.02).astype(np.float32)
    wpk, bpk = pack_qkv_weights(wqkv, bqkv, H)
    wj, bj = jvb.pack_qkv_weights(wqkv, bqkv, H)
    assert np.array_equal(wpk, wj) and np.array_equal(bpk, bj)
    lens = rng.integers(1, N + 1, B).astype(np.int32)
    keep = (np.arange(N)[None] < lens[:, None]).astype(np.float32)
    return (x, g, b, wpk, bpk, wp, bp), {"keep2d": keep, "len1d": lens}


# (B, N, D, H): the JAX test's cases, and SD-UNet's geometries at few tokens
# (hd 16 in one head group of 8, hd 32 in groups of 4)
@pytest.mark.parametrize("geom", [(2, 197, 128, 4), (1, 64, 128, 2), (2, 50, 192, 6),
                                  (2, 40, 128, 8), (1, 24, 256, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["pre_ln", "no_ln", "keep2d", "len1d"])
def test_vit_block_plain_matches_pallas(geom, dtype, form):
    """The plain version against `_vit_block_impl` in interpret mode, with the
    op's arguments: residual outside, the node's epsilon (1e-6 for ViT)."""
    B, N, D, H = geom
    (x, g, b, wpk, bpk, wp, bp), masks = _vit_operands(B, N, D, H)
    mask = masks.get(form)
    pre_ln = form != "no_ln"
    tdt = getattr(torch, dtype)
    got = vb.vit_attention_block(
        torch.from_numpy(x).to(tdt), torch.from_numpy(g), torch.from_numpy(b),
        torch.from_numpy(wpk).to(tdt), torch.from_numpy(bpk), torch.from_numpy(wp).to(tdt),
        torch.from_numpy(bp), None if mask is None else torch.from_numpy(mask), heads=H,
        eps=1e-6, pre_ln=pre_ln)
    assert vb.launches == 0 and got.dtype == tdt and tuple(got.shape) == (B, N, D)
    want = jvb._vit_block_impl(
        jnp.asarray(x).astype(dtype), jnp.asarray(g), jnp.asarray(b),
        jnp.asarray(wpk).astype(dtype), jnp.asarray(bpk), jnp.asarray(wp).astype(dtype),
        jnp.asarray(bp), None if mask is None else jnp.asarray(mask), heads=H,
        interpret=True, eps=1e-6, residual=False, pre_ln=pre_ln)
    want = np.asarray(want.astype(jnp.float32))
    # f32: every product summed in f32 in other orders -> 1e-5 of the largest
    # output; bf16: q, k, v, p and the outputs round to 8 bits -> 3e-2, the
    # JAX package's own kernel test bound.
    tol = {"float32": 1e-5, "bfloat16": 3e-2}[dtype]
    assert np.abs(got.float().numpy() - want).max() <= tol * np.abs(want).max()


def test_vit_block_residual_and_scale_match_pallas():
    (x, g, b, wpk, bpk, wp, bp), _ = _vit_operands(2, 33, 64, 2, seed=3)
    got = vb.vit_attention_block(*(torch.from_numpy(a) for a in (x, g, b, wpk, bpk, wp, bp)),
                                 heads=2, scale=0.3, residual=True)
    want = np.asarray(jvb._vit_block_impl(*(jnp.asarray(a) for a in (x, g, b, wpk, bpk, wp, bp)),
                                          heads=2, scale=0.3, residual=True, interpret=True))
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


# -- pixel_conv_rowdot, pixel_conv_rowdot_q ----------------------------------

def _pixel_operands(b, h, cin, w, cout, seed=0):
    """tests/test_pixel_conv.py's operands, NHCW."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, cin, w)).astype(np.float32)
    wt = (rng.standard_normal((cout, cin, 3, 3)) / (3 * np.sqrt(cin))).astype(np.float32)
    bias = rng.standard_normal((cout,)).astype(np.float32)
    return x, wt, bias


@pytest.mark.parametrize("geom", [(2, 16, 16, 128, 8), (1, 8, 32, 128, 16), (1, 16, 48, 256, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("alpha", [None, 0.2])
def test_pixel_conv_rowdot_plain_matches_pallas(geom, dtype, alpha):
    """The plain version against the Pallas kernel in interpret mode: f32
    within 1e-5 of the largest output (sums in other orders), bf16 within
    1e-2 (f32 sums of the same bf16 products, each rounded once)."""
    x, wt, bias = _pixel_operands(*geom)
    tdt = getattr(torch, dtype)
    got = pc.pixel_conv_rowdot(torch.from_numpy(x).to(tdt), torch.from_numpy(wt),
                               torch.from_numpy(bias), alpha=alpha)
    assert pc.launches == 0 and got.dtype == tdt
    want = jpc.pixel_conv_rowdot(jnp.asarray(x).astype(dtype), jnp.asarray(wt),
                                 jnp.asarray(bias), alpha=alpha, rows=8, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    tol = {"float32": 1e-5, "bfloat16": 1e-2}[dtype]
    assert got.shape == want.shape
    assert np.abs(got.float().numpy() - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("requant", [True, False])
@pytest.mark.parametrize("alpha", [None, 0.2])
def test_pixel_conv_rowdot_q_plain_matches_pallas(requant, alpha):
    """tests/test_pixel_conv.py's int8 case: exact int32 sums, then the
    epilogue. The int8 outputs are bit-equal; the float ones (requant off)
    within 1e-6 of the largest, since XLA on the CPU contracts
    acc * scale + bias into one fused multiply-add."""
    rng = np.random.default_rng(11)
    b, h, w, cin, cout = 2, 16, 128, 16, 8
    xq = rng.integers(-127, 128, (b, h, cin, w), dtype=np.int8)
    wq = rng.integers(-127, 128, (cout, cin, 3, 3), dtype=np.int8)
    sx, sw = 0.02, rng.uniform(0.001, 0.01, cout).astype(np.float32)
    scales = (sx * sw).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    kw = dict(alpha=alpha, inv_sy=1 / 0.05, requant=requant)
    got = pc.pixel_conv_rowdot_q(*(torch.from_numpy(a) for a in (xq, wq, scales, bias)),
                                 out_dtype=torch.float32, **kw)
    want = np.asarray(jpc.pixel_conv_rowdot_q(*(jnp.asarray(a) for a in (xq, wq, scales, bias)),
                                              out_dtype=jnp.float32, rows=8, interpret=True, **kw))
    assert pc.q_launches == 0 and got.numpy().dtype == want.dtype
    if requant:
        assert np.array_equal(got.numpy(), want) and len(np.unique(want)) > 100
    else:
        assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


# -- max_unpool2x2 -------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 4, 8, 16), (1, 3, 4, 256), (2, 32, 16, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_max_unpool2x2_plain_matches_pallas(shape, dtype):
    """tests/test_max_unpool.py's geometries, values from a 2x2 pool of a
    random map: equal outputs (the kernel moves values, it computes none)."""
    import torch.nn.functional as F

    B, C, H, W = shape
    full = torch.from_numpy(np.random.default_rng(0).standard_normal(shape).astype(np.float32))
    val, plane = F.max_pool2d(full, 2, 2, return_indices=True)
    idx = plane + torch.arange(B * C).reshape(B, C, 1, 1) * H * W
    tdt = getattr(torch, dtype)
    got = mu.max_unpool2x2(val.to(tdt), idx)
    assert mu.launches == 0 and got.dtype == tdt
    want = jmu.max_unpool2x2(jnp.asarray(val.numpy()).astype(dtype), jnp.asarray(idx.numpy()),
                             interpret=True)
    assert np.array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_image_kernels_take_the_plain_version_on_meta():
    x = torch.empty(2, 16, 32, 128, device="meta", dtype=torch.bfloat16)
    w = torch.empty(64, 32, 3, 3, device="meta")
    v = torch.empty(64, device="meta")
    assert pc.pixel_conv_rowdot(x, w, v, alpha=0.2).shape == (2, 16, 64, 128)
    xq = torch.empty(2, 16, 32, 128, device="meta", dtype=torch.int8)
    out = pc.pixel_conv_rowdot_q(xq, w.to(torch.int8), v, v, requant=False,
                                 out_dtype=torch.bfloat16)
    assert out.shape == (2, 16, 64, 128) and out.dtype == torch.bfloat16
    assert pc.pixel_conv_rowdot_q(xq, w.to(torch.int8), v, v).dtype == torch.int8
    up = mu.max_unpool2x2(torch.empty(2, 4, 8, 8, device="meta"),
                          torch.empty(2, 4, 8, 8, device="meta", dtype=torch.int64))
    assert up.shape == (2, 4, 16, 16)
    assert pc.launches == 0 and pc.q_launches == 0 and mu.launches == 0


# -- convnext_block, cross_attn_block ----------------------------------------

def _cnx_operands(B, H, W, C, seed=0):
    """x, dw (7, 7, 1, C), dw_b, LN gamma and beta, w1, b1, w2, b2 and a
    layer scale of 0.5 (ConvNeXt's 1e-6 init would hide the MLP)."""
    rng = np.random.default_rng(seed)
    F = 4 * C
    return tuple(a.astype(np.float32) for a in (
        rng.standard_normal((B, H, W, C)), rng.standard_normal((7, 7, 1, C)) / 7,
        0.1 * rng.standard_normal(C), 1 + 0.1 * rng.standard_normal(C),
        0.1 * rng.standard_normal(C), rng.standard_normal((C, F)) / np.sqrt(C),
        0.1 * rng.standard_normal(F), rng.standard_normal((F, C)) / np.sqrt(F),
        0.1 * rng.standard_normal(C), 0.5 + 0.1 * rng.standard_normal(C)))


@pytest.mark.parametrize("geom", [(2, 9, 11, 32), (1, 7, 7, 64), (1, 4, 13, 24)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convnext_block_plain_matches_pallas(geom, dtype):
    """The plain version against the Pallas kernel in interpret mode, with
    the op's casts: the conv and MLP weights in x's dtype, the rest f32."""
    args = _cnx_operands(*geom)
    tdt = getattr(torch, dtype)
    cast = (0, 1, 5, 7)  # x, dw, w1, w2
    got = cb.convnext_block(*(torch.from_numpy(a).to(tdt) if i in cast else torch.from_numpy(a)
                              for i, a in enumerate(args)), eps=1e-6)
    assert cb.launches == 0 and got.dtype == tdt and tuple(got.shape) == geom
    want = jcb.convnext_block(*(jnp.asarray(a).astype(dtype) if i in cast else jnp.asarray(a)
                                for i, a in enumerate(args)), eps=1e-6, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    # f32: the taps and both products summed in f32 in other orders -> 1e-5
    # of the largest output; bf16: xn, h and the output round to 8 bits ->
    # 1e-2.
    tol = {"float32": 1e-5, "bfloat16": 1e-2}[dtype]
    assert np.abs(got.float().numpy() - want).max() <= tol * np.abs(want).max()


def _xattn_operands(B, N, D, H, S, bk, seed=0):
    rng = np.random.default_rng(seed)
    hd = D // H
    return tuple(a.astype(np.float32) for a in (
        rng.standard_normal((B, N, D)), rng.standard_normal((D, D)) / np.sqrt(D),
        rng.standard_normal((bk, H, S, hd)), rng.standard_normal((bk, H, S, hd)),
        rng.standard_normal((D, D)) / np.sqrt(D), 0.1 * rng.standard_normal(D)))


# (B, N, D, H, S): SD-UNet's hd 16 and hd 32 at few tokens, and hd 64
@pytest.mark.parametrize("geom", [(2, 40, 128, 8, 16), (2, 24, 256, 8, 16), (1, 9, 128, 2, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bk", ["B", 1])
def test_cross_attn_block_plain_matches_pallas(geom, dtype, bk):
    B, N, D, H, S = geom
    args = _xattn_operands(B, N, D, H, S, B if bk == "B" else 1)
    tdt = getattr(torch, dtype)
    for scale in (None, 0.3):
        got = xa.cross_attn_block(*(torch.from_numpy(a).to(tdt) for a in args[:5]),
                                  torch.from_numpy(args[5]), heads=H, scale=scale)
        assert xa.launches == 0 and got.dtype == tdt and tuple(got.shape) == (B, N, D)
        want = jvb.cross_attn_block(*(jnp.asarray(a).astype(dtype) for a in args[:5]),
                                    jnp.asarray(args[5]), heads=H, scale=scale, interpret=True)
        want = np.asarray(want.astype(jnp.float32))
        # f32: sums in other orders -> 1e-5; bf16: q, p, the attention output
        # and the result round to 8 bits -> 1e-2 of the largest output.
        tol = {"float32": 1e-5, "bfloat16": 1e-2}[dtype]
        assert np.abs(got.float().numpy() - want).max() <= tol * np.abs(want).max()


def test_block_kernels_take_the_plain_version_on_meta():
    x = torch.empty(2, 14, 14, 64, device="meta", dtype=torch.bfloat16)
    c, f = torch.empty(64, device="meta"), torch.empty(256, device="meta")
    w1 = torch.empty(64, 256, device="meta", dtype=torch.bfloat16)
    out = cb.convnext_block(x, torch.empty(7, 7, 1, 64, device="meta", dtype=torch.bfloat16), c,
                            c, c, w1, f, w1.t(), c, c)
    assert out.shape == x.shape and out.dtype == x.dtype
    xs = torch.empty(2, 40, 128, device="meta", dtype=torch.bfloat16)
    w = torch.empty(128, 128, device="meta", dtype=torch.bfloat16)
    kv = torch.empty(1, 8, 16, 16, device="meta", dtype=torch.bfloat16)
    out = xa.cross_attn_block(xs, w, kv, kv, w, torch.empty(128, device="meta"), heads=8)
    assert out.shape == xs.shape and out.dtype == xs.dtype
    assert cb.launches == 0 and xa.launches == 0



# -- dequant_conv, qlinear_conv ------------------------------------------------

# The JAX package's own dequant_conv cases (tests/test_kernels.py): (h, w,
# C_in, C_out, k, pad) at batch 2.
DEQUANT_CONV = [(8, 8, 128, 128, 3, 1), (14, 14, 128, 256, 3, 1), (10, 10, 128, 128, 1, 0),
                (12, 12, 128, 128, 5, 2), (11, 9, 128, 128, 3, 0), (28, 28, 128, 128, 3, 1)]


def _dequant_conv_operands(h, w, cin, cout, k, seed=0):
    from smelter_tpu_torch.quant import quantize_array

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, h, w, cin)).astype(np.float32)
    q, s = quantize_array(rng.standard_normal((cout, cin, k, k)).astype(np.float32) * 0.1, 0)
    return x, np.ascontiguousarray(q.transpose(2, 3, 1, 0)), s.reshape(-1)


@pytest.mark.parametrize("geom", DEQUANT_CONV)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequant_conv_plain_matches_pallas(geom, dtype):
    """Against the Pallas kernel in interpret mode. f32: sums in other
    orders, 1e-5 of the largest output; bf16: the same f32 sums of exact
    products, each side rounding once to bf16, 1e-2 of the largest."""
    h, w, cin, cout, k, pad = geom
    x, q, s = _dequant_conv_operands(h, w, cin, cout, k)
    pads = ((pad, pad), (pad, pad))
    tdt = getattr(torch, dtype)
    got = dc.dequant_conv(torch.from_numpy(x).to(tdt), torch.from_numpy(q), torch.from_numpy(s),
                          pads=pads)
    assert dc.launches == 0 and got.dtype == tdt
    want = jdc.dequant_conv(jnp.asarray(x).astype(dtype), jnp.asarray(q), jnp.asarray(s),
                            pads=pads, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    assert tuple(got.shape) == want.shape == (2, h + 2 * pad - k + 1, w + 2 * pad - k + 1, cout)
    tol = {"float32": 1e-5, "bfloat16": 1e-2}[dtype]
    assert np.abs(got.float().numpy() - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequant_conv_plain_against_the_reference(dtype):
    """The JAX reference rounds w * s to x's dtype before its conv, the
    kernel (and its plain version) scales the f32 sum: in f32 they agree to
    sum order (1.2e-6 of the largest output here, held to 1e-5); in bf16 the
    reference's rounded weights move the output by 4.5e-3 of the largest
    here, held to 2e-2."""
    x, q, s = _dequant_conv_operands(14, 14, 128, 256, 3, seed=1)
    pads = ((1, 1), (1, 1))
    tdt = getattr(torch, dtype)
    got = dc.dequant_conv(torch.from_numpy(x).to(tdt), torch.from_numpy(q), torch.from_numpy(s),
                          pads=pads).float().numpy()
    ref = np.asarray(jdc.dequant_conv_reference(jnp.asarray(x).astype(dtype), jnp.asarray(q),
                                                jnp.asarray(s), pads=pads).astype(jnp.float32))
    gap = np.abs(got - ref).max() / np.abs(ref).max()
    assert gap <= {"float32": 1e-5, "bfloat16": 2e-2}[dtype], gap


def test_conv_kernels_take_the_plain_version_on_meta():
    x = torch.empty(2, 14, 14, 64, device="meta", dtype=torch.bfloat16)
    out = dc.dequant_conv(x, torch.empty(3, 3, 64, 32, device="meta", dtype=torch.int8),
                          torch.empty(32, device="meta"), pads=((1, 1), (0, 2)))
    assert out.shape == (2, 14, 14, 32) and out.dtype == x.dtype
    xq = torch.empty(2, 3, 224, 224, device="meta", dtype=torch.int8)
    wq = torch.empty(64, 3, 7, 7, device="meta", dtype=torch.int8)
    v = torch.empty(64, device="meta")
    out = qc.qlinear_conv(xq, wq, v, v, stride=(2, 2), pads=((3, 3), (3, 3)))
    assert out.shape == (2, 64, 112, 112) and out.dtype == torch.int8
    assert dc.launches == 0 and qc.launches == 0
