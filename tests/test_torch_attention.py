"""A transformer encoder's attention and MLP in smelter_tpu_torch against smelter_tpu.

The plain versions of `flash_attention`, `short_attention` and `mlp_block`
against the JAX package's Pallas kernels in interpret mode; FusedAttention
on each of its routes and MlpBlock one node at a time against the JAX
lowerings; FusedDequantMatMul on its default and `use_pallas` routes; ViT
written as Hugging Face writes it (`torch_hf_vit.py`) through both packages'
exporters, pipelines, `compile` and `serve`; and `fuse_mlp_block` on whole
models. Inputs come from numpy seeds. On the CPU the port's wrappers take
their plain versions.
"""

import copy
import functools
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smelter_tpu as st
import smelter_tpu_torch as stt
import torch_hf_vit as hf
from smelter_tpu.frontend.torch_export import export_torch as jax_export
from smelter_tpu.kernels import attention_short as jas
from smelter_tpu.kernels import dequant_matmul as jdm
from smelter_tpu.kernels import flash_attention as jfa
from smelter_tpu.kernels import int8_matmul as jim
from smelter_tpu.kernels import mlp_block as jmb
from smelter_tpu.models import vit as jvit
from smelter_tpu.passes.pass_manager import run_passes as jax_run_passes
from smelter_tpu_torch.frontend.torch_export import export_torch
from smelter_tpu_torch.kernels import attention_short as sa
from smelter_tpu_torch.kernels import flash_attention as fa
from smelter_tpu_torch.kernels import mlp_block as mb
from smelter_tpu_torch.models import vit
from smelter_tpu_torch.ops import fused_ops
from smelter_tpu_torch.passes.pass_manager import run_passes
from torch_port_common import _close, _one_op, assert_graphs_equal

BF16_STEP = 2.0 ** -8  # one bf16 rounding step, relative to the value


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _err(got, want) -> tuple[float, float]:
    """(max-abs difference, max|want|) in float64."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max()), float(np.abs(want).max())


def _jax(t: torch.Tensor):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# -- plain versions against the Pallas kernels (interpret mode) ----------------

FLASH_CASES = [((1, 2, 600, 64), 600),   # a KV tail that is not a multiple of 128
               ((1, 2, 300, 64), 600),   # Nq != Nk
               ((2, 2, 130, 32), 130)]   # head dim 32


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_plain_matches_pallas(case, dtype):
    """f32 within 1e-5 of the largest output (sums in other orders); bf16
    within one bf16 step of it: both round the same f32 result once."""
    (B, H, Nq, hd), Nk = case
    q = torch.from_numpy(_rand((B, H, Nq, hd), 0)).to(dtype)
    k = torch.from_numpy(_rand((B, H, Nk, hd), 1)).to(dtype)
    v = torch.from_numpy(_rand((B, H, Nk, hd), 2)).to(dtype)
    scale = hd ** -0.5
    got = fa.flash_attention(q, k, v, scale=scale)
    assert got.dtype == dtype and got.shape == (B, H, Nq, hd) and fa.launches == 0
    want = jfa.flash_attention(_jax(q), _jax(k), _jax(v), scale=scale, interpret=True)
    err, top = _err(got.float(), _np(want))
    assert err <= (1e-5 if dtype == torch.float32 else BF16_STEP) * top, err


SHORT_SHAPES = [(2, 4, 64, 64), (2, 3, 197, 64), (1, 2, 30, 32)]


@pytest.mark.parametrize("shape", SHORT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_short_attention_plain_matches_pallas(shape, dtype):
    """f32 within 1e-5 of the largest output; bf16 within 1e-2 of it: p is
    rounded to bf16 in both, and an f32 p one ulp apart can round to
    neighbouring bf16 values."""
    q, k, v = (torch.from_numpy(_rand(shape, s)).to(dtype) for s in (3, 4, 5))
    scale = shape[-1] ** -0.5
    got = sa.short_attention(q, k, v, scale=scale)
    assert got.dtype == dtype and sa.launches == 0
    want = jas.short_attention(_jax(q), _jax(k), _jax(v), scale=scale, interpret=True)
    err, top = _err(got.float(), _np(want))
    assert err <= (1e-5 if dtype == torch.float32 else 1e-2) * top, err


def _mlp_operands(B, N, D, F, seed=6):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, N, D)).astype(np.float32),
            (1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
            (0.1 * rng.standard_normal(D)).astype(np.float32),
            (rng.standard_normal((D, F)) / np.sqrt(D)).astype(np.float32),
            (0.1 * rng.standard_normal(F)).astype(np.float32),
            (rng.standard_normal((F, D)) / np.sqrt(F)).astype(np.float32),
            (0.1 * rng.standard_normal(D)).astype(np.float32))


@pytest.mark.parametrize("pre_ln", [True, False])
@pytest.mark.parametrize("approximate", [False, True])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlp_block_plain_matches_pallas(pre_ln, approximate, residual, dtype):
    """The kernel's rounding (x @ w1 summed in f32 before b1; the exact GELU
    as the polynomial over exp), not mlp_block_reference's. f32 within 1e-5
    of the largest output; bf16 within 1e-2 of it (h is rounded to bf16 in
    both, and neighbouring f32 values can round apart)."""
    x, g, b, w1, b1, w2, b2 = _mlp_operands(2, 50, 64, 256)
    xt, w1t, w2t = (torch.from_numpy(a).to(dtype) for a in (x, w1, w2))
    kw = dict(eps=1e-6, approximate=approximate, residual=residual, pre_ln=pre_ln)
    got = mb.mlp_block(xt, *(torch.from_numpy(a) for a in (g, b)), w1t, torch.from_numpy(b1),
                       w2t, torch.from_numpy(b2), **kw)
    assert got.dtype == dtype and got.shape == xt.shape and mb.launches == 0
    want = jmb.mlp_block(_jax(xt), jnp.asarray(g), jnp.asarray(b), _jax(w1t), jnp.asarray(b1),
                         _jax(w2t), jnp.asarray(b2), interpret=True, **kw)
    err, top = _err(got.float(), _np(want))
    assert err <= (1e-5 if dtype == torch.float32 else 1e-2) * top, err


def test_exact_gelu_polynomial_is_erf_below_bf16_resolution():
    """The polynomial's erf is within 1.5e-7, so GELU = h (1 + erf) / 2 over
    |h| <= 8 is within 6e-7 plus f32 rounding: 2e-6, far below a bf16 step."""
    h = torch.linspace(-8, 8, 4001)
    err = (mb.gelu_kernel_form(h, False) - torch.nn.functional.gelu(h)).abs().max().item()
    assert err < 2e-6


# -- one node at a time ---------------------------------------------------------

class _Routes:
    """Which of FusedAttention's routes a run took: spies on the two kernel
    wrappers and the library attention of ops/fused_ops.py."""

    def __init__(self, monkeypatch):
        self.taken = []
        for name in ("flash_attention", "short_attention", "_library_attention"):
            fn = getattr(fused_ops, name)

            def spy(*a, _fn=fn, _name=name, **kw):
                self.taken.append(_name)
                return _fn(*a, **kw)

            monkeypatch.setattr(fused_ops, name, spy)


@pytest.mark.parametrize("case", [
    # (label, q, k/v shape, config, route)
    ("library", (2, 3, 40, 16), (2, 3, 40, 16), {}, "_library_attention"),
    ("library_use_pallas_unequal", (1, 2, 40, 16), (1, 2, 70, 16), {"use_pallas": True},
     "_library_attention"),
    ("auto_flash", (1, 2, 2048, 64), (1, 2, 2048, 64), {}, "flash_attention"),
    ("flash_use_pallas", (1, 2, 520, 32), (1, 2, 300, 32), {"use_pallas": True},
     "flash_attention"),
    ("short_use_pallas", (2, 3, 65, 16), (2, 3, 65, 16), {"use_pallas": True},
     "short_attention"),
    ("short_use_pallas_bf16", (2, 3, 65, 16), (2, 3, 65, 16),
     {"use_pallas": True, "compute_dtype": "bfloat16"}, "short_attention"),
])
def test_fused_attention_routes_match_jax(case, monkeypatch):
    """Each route against the JAX lowering on the same node: f32 within 1e-5
    of the largest output, bf16 within 1e-2 of it."""
    label, qs, ks, config, route = case
    routes = _Routes(monkeypatch)
    inputs = {"q": _rand(qs, 7), "k": _rand(ks, 8), "v": _rand(ks, 9)}
    got, want = _one_op("FusedAttention", inputs, {"scale": qs[-1] ** -0.5}, **config)
    assert routes.taken == [route], routes.taken
    _close(got, want, 1e-2 if config.get("compute_dtype") else 1e-5)


@pytest.mark.parametrize("form", ["native_broadcast_out_shape", "native_q_only", "bias",
                                  "rank3", "rank3_bias"])
def test_fused_attention_forms_match_jax(form, monkeypatch):
    """The forms outside the kernels: native-layout operands with batch-1
    K/V broadcast and out_shape, the additive bias (which keeps even a
    use_pallas node off the kernels), and rank 3."""
    routes = _Routes(monkeypatch)
    attrs = {"scale": 0.25}
    config = {}
    if form == "native_broadcast_out_shape":
        inputs = {"q": _rand((2, 12, 3, 16), 10), "k": _rand((1, 20, 3, 16), 11),
                  "v": _rand((1, 20, 3, 16), 12)}
        attrs.update(q_native=1, k_native=1, v_native=1, out_shape=[2, 12, 48])
    elif form == "native_q_only":
        inputs = {"q": _rand((2, 12, 3, 16), 10), "k": _rand((2, 3, 20, 16), 11),
                  "v": _rand((2, 3, 20, 16), 12)}
        attrs.update(q_native=1)
    elif form == "bias":
        inputs = {"q": _rand((2, 3, 600, 16), 10), "k": _rand((2, 3, 600, 16), 11),
                  "v": _rand((2, 3, 600, 16), 12), "bias": _rand((1, 3, 600, 600), 13)}
        config = {"use_pallas": True}
    else:
        inputs = {"q": _rand((2, 24, 16), 10), "k": _rand((2, 30, 16), 11),
                  "v": _rand((2, 30, 16), 12)}
        if form == "rank3_bias":
            inputs["bias"] = _rand((2, 1, 24, 30), 13)
    got, want = _one_op("FusedAttention", inputs, attrs, **config)
    assert routes.taken == ["_library_attention"], routes.taken
    _close(got, want)


@pytest.mark.parametrize("pre_ln", [1, 0])
@pytest.mark.parametrize("approximate", [0, 1])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_mlp_block_op_matches_jax(pre_ln, approximate, compute_dtype):
    x, g, b, w1, b1, w2, b2 = _mlp_operands(2, 20, 128, 256, seed=14)
    inits = {"g": g, "b": b, "w1": w1, "b1": b1, "w2": w2, "b2": b2}
    attrs = {"epsilon": 1e-6, "approximate": approximate, "residual": pre_ln,
             "pre_ln": pre_ln}
    got, want = _one_op("MlpBlock", {"x": x}, attrs, inits, compute_dtype=compute_dtype)
    _close(got, want, 1e-5 if compute_dtype == "float32" else 1e-2)
    assert mb.launches == 0


@pytest.mark.parametrize("int8_activations", [False, True])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_fused_dequant_matmul_routes_match_jax(int8_activations, use_pallas, compute_dtype):
    """The JAX lowering's routing: the Pallas kernels (interpret mode) under
    use_pallas, `dequant_matmul_reference` / `dequant_matmul_int8_xla`
    without. Each route against the JAX function it stands for: f32 within
    1e-5 of the largest output (bit-equal int32 sums under int8
    activations), bf16 within 1e-2."""
    rng = np.random.default_rng(15)
    x = rng.standard_normal((2, 9, 96)).astype(np.float32)
    w = rng.integers(-127, 128, (96, 40), dtype=np.int8)
    s = rng.uniform(1e-3, 2e-2, 40).astype(np.float32)
    got, _ = _one_op("FusedDequantMatMul", {"x": x}, {}, {"w": w, "s": s},
                     compute_dtype=compute_dtype, use_pallas=use_pallas,
                     int8_activations=int8_activations)
    jdt = jnp.bfloat16 if compute_dtype == "bfloat16" else jnp.float32
    xj = jnp.asarray(x.reshape(18, 96)).astype(jdt)
    if int8_activations:
        fn = (functools.partial(jim.dequant_matmul_int8, interpret=True) if use_pallas
              else jim.dequant_matmul_int8_xla)
    else:
        fn = (functools.partial(jdm.dequant_matmul, interpret=True) if use_pallas
              else jdm.dequant_matmul_reference)
    want = _np(fn(xj, jnp.asarray(w), jnp.asarray(s))).reshape(2, 9, 40)
    _close(got, [want], 1e-5 if compute_dtype == "float32" else 1e-2)


def test_dequant_composites_match_jax_references():
    from smelter_tpu_torch.kernels import dequant_matmul as dm
    from smelter_tpu_torch.kernels import int8_matmul as im

    rng = np.random.default_rng(16)
    x = rng.standard_normal((5, 24)).astype(np.float32)
    w = rng.integers(-127, 128, (24, 16), dtype=np.int8)
    s = rng.uniform(1e-3, 2e-2, 16).astype(np.float32)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        xt = torch.from_numpy(x).to(dt)
        xj = jnp.asarray(x).astype(jdt)
        got = dm.dequant_matmul_reference(xt, torch.from_numpy(w), torch.from_numpy(s))
        want = jdm.dequant_matmul_reference(xj, jnp.asarray(w), jnp.asarray(s))
        assert got.dtype == dt
        _close([got.float().numpy()], [_np(want)], 1e-5 if dt == torch.float32 else 1e-2)
        got = im.dequant_matmul_int8_reference(xt, torch.from_numpy(w), torch.from_numpy(s))
        want = jim.dequant_matmul_int8_xla(xj, jnp.asarray(w), jnp.asarray(s))
        _close([got.float().numpy()], [_np(want)], 1e-5 if dt == torch.float32 else 1e-2)
    xq, _ = im.quantize_rows(torch.from_numpy(x))
    assert torch.equal(im.int32_matmul(xq, torch.from_numpy(w)),
                       torch.matmul(xq.long(), torch.from_numpy(w).long()).int())


# -- ViT in the Hugging Face layout -------------------------------------------------

HF_SMALL = dict(patch=4, dim=64, depth=2, heads=2, mlp=256, num_classes=10)
HF_SIZES = {"short": 32, "flash": 96}  # N 65 and N 577 tokens


@functools.lru_cache(maxsize=None)
def _hf_exports(image_size: int, sdpa: bool = False):
    """(JAX graph, port graph, input shape) of the small HF-layout ViT at
    batch 2, each exported by its own package's exporter. Callers copy
    before they compile: the passes rewrite a graph in place."""
    cfg = {**HF_SMALL, "image_size": image_size}
    m = hf.create(batch=2, sdpa=sdpa, **cfg)
    shape = hf.input_shape(2, **cfg)
    ex = torch.from_numpy(_rand(shape, 17))
    return jax_export(m, ex), export_torch(m, ex), shape


def _fused_attention_nodes(g) -> list:
    return [n for n in g.nodes if n.op_type == "FusedAttention"]


@pytest.mark.parametrize("size", list(HF_SIZES))
@pytest.mark.parametrize("sdpa", [False, True])
def test_hf_vit_graph_matches_jax(size, sdpa):
    """Both exporters and pipelines give one graph, node for node, with one
    unmarked FusedAttention a layer (no native marks: the kernels' routes)
    between Reshape/Transpose nodes, and each residual + LayerNorm fused into
    SkipLayerNormalization. The SDPA form gives the eager form's ops in the
    eager form's order."""
    def prepared(sd):
        gj, gt, _ = _hf_exports(HF_SIZES[size], sd)
        return (st.api._prepare(copy.deepcopy(gj), None, True, "nhwc"),
                stt.api._prepare(copy.deepcopy(gt), None, True, "nhwc"))

    gj, gt = prepared(sdpa)
    assert_graphs_equal(gj, gt)
    fa_nodes = _fused_attention_nodes(gt)
    assert len(fa_nodes) == HF_SMALL["depth"]
    assert all(not any(k.endswith("_native") for k in n.attrs) for n in fa_nodes)
    producers = gt.producers()
    assert all(producers[e].op_type == "Transpose" for n in fa_nodes for e in n.inputs)
    ops = [n.op_type for n in gt.nodes]
    assert ops.count("SkipLayerNormalization") == 2 * HF_SMALL["depth"]
    assert "Softmax" not in ops
    if sdpa:
        assert ops == [n.op_type for n in prepared(False)[1].nodes]


@pytest.mark.parametrize("size", list(HF_SIZES))
@pytest.mark.parametrize("config", [{}, {"use_pallas": True}, {"compute_dtype": "bfloat16"},
                                    {"compute_dtype": "bfloat16", "use_pallas": True}])
def test_hf_vit_compile_matches_jax(size, config, monkeypatch):
    """compile(graph) against the JAX package's compile of its own export:
    f32 within 1e-4 of the largest logit, bf16 within 3e-2 of it with top-1
    equal where the top-2 gap exceeds twice the error. use_pallas routes the
    attention to short_attention (N 65) or flash_attention (N 577), the
    default config to the library attention."""
    routes = _Routes(monkeypatch)
    gj, gt, shape = _hf_exports(HF_SIZES[size])
    x = _rand(shape, 18)
    want = np.asarray(st.compile(copy.deepcopy(gj), st.Config(**config))(x)[0], np.float32)
    model = stt.compile(copy.deepcopy(gt), stt.Config(**config), device="cpu")
    routes.taken.clear()  # what compile ran to trace shapes
    got = model(x)[0]
    route = ({"short": "short_attention", "flash": "flash_attention"}[size]
             if config.get("use_pallas") else "_library_attention")
    assert routes.taken == [route] * HF_SMALL["depth"], routes.taken
    err, scale = _err(got, want)
    if not config.get("compute_dtype"):
        assert err <= 1e-4 * scale, err
        return
    assert err <= 3e-2 * scale, err
    top2 = np.sort(want, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * err
    assert (got.argmax(1) == want.argmax(1))[clear].all()


def test_hf_vit_sdpa_form_compiles_as_the_eager_form():
    """The SDPA form's graph computes the eager form's logits (f32)."""
    x = _rand(_hf_exports(HF_SIZES["short"])[2], 19)
    outs = [stt.compile(copy.deepcopy(_hf_exports(HF_SIZES["short"], sdpa)[1]),
                        stt.Config(use_pallas=True), device="cpu")(x)[0]
            for sdpa in (False, True)]
    err, scale = _err(outs[1], outs[0])
    assert err <= 1e-5 * scale, err


def test_hf_vit_serve_matches_jax():
    """serve(graph, use_pallas) at the graph's pinned batch answers threaded
    requests with the JAX package's logits (f32, within 1e-4)."""
    gj, gt, shape = _hf_exports(HF_SIZES["short"])
    xs = _rand((4,) + shape[1:], 20)
    jm = st.compile(copy.deepcopy(gj), st.Config(use_pallas=True))
    want = np.concatenate([np.asarray(jm(xs[:2])[0]), np.asarray(jm(xs[2:])[0])])
    server = stt.serve(copy.deepcopy(gt), stt.Config(use_pallas=True), device="cpu",
                       max_batch=2, buckets=(2,))
    got = [None] * len(xs)
    try:
        assert server.wait_ready(120)

        def ask(i):
            got[i] = server.infer(xs[i])[0]

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        stats = server.stats()
    finally:
        server.shutdown()
    assert stats["requests"] == 4 and stats["errors"] == 0
    err, scale = _err(np.stack(got), want)
    assert err <= 1e-4 * scale, err


# -- fuse_mlp_block on whole models ---------------------------------------------

def _mlp_graphs(model: str):
    """(JAX graph, port graph, unfused JAX graph, input shape) after the
    default pipeline, then fuse_mlp_block and dce, as the JAX package's own
    test runs it. The zoo ViT at test_torch_vit.py's size (dim 256, 4 heads,
    depth 2, 224 px); the HF layout at dim 128 (fuse_mlp_block takes widths
    that are multiples of 128)."""
    if model == "zoo":
        cfg = dict(batch=2, image_size=224, dim=256, depth=2, heads=4, num_classes=10)
        gj0, _m, shape = jvit.build(**cfg)
        gt0 = vit.build(**cfg)[0]
    else:
        cfg = {**HF_SMALL, "image_size": 32, "dim": 128, "mlp": 512}
        m = hf.create(batch=2, **cfg)
        shape = hf.input_shape(2, **cfg)
        ex = torch.from_numpy(_rand(shape, 21))
        gj0, gt0 = jax_export(m, ex), export_torch(m, ex)
    gj, gt = copy.deepcopy(gj0), gt0
    ref = jax_run_passes(gj0)
    jax_run_passes(gj)
    run_passes(gt)
    jax_run_passes(gj, ["fuse_mlp_block", "dce"])
    run_passes(gt, ["fuse_mlp_block", "dce"])
    return gj, gt, ref, shape


@pytest.mark.parametrize("model", ["zoo", "hf"])
def test_fuse_mlp_block_matches_jax(model):
    """Both packages fuse both MLPs into MlpBlock, node for node; the port's
    CompiledModel holds the JAX one (Pallas kernel in interpret mode) within
    1e-4 of the largest f32 output, and the unfused graph within 1e-3 (the
    JAX package's own bound: the kernel's GELU polynomial and rounding)."""
    gj, gt, ref, shape = _mlp_graphs(model)
    assert_graphs_equal(gj, gt)
    assert [n.op_type for n in gt.nodes].count("MlpBlock") == 2
    x = _rand(shape, 22, 0.5)
    want = np.asarray(st.CompiledModel(gj, st.Config())(x)[0])
    got = stt.CompiledModel(gt, stt.Config(device="cpu"))(x)[0]
    err, scale = _err(got, want)
    assert err <= 1e-4 * scale, err
    unfused = np.asarray(st.CompiledModel(ref, st.Config())(x)[0])
    err, scale = _err(got, unfused)
    assert err <= 1e-3 * scale, err
