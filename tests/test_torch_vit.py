"""The ViT-B/16 compile-and-serve slice of smelter_tpu_torch against smelter_tpu.

The new op lowerings one node at a time (Concat, Slice, Squeeze, Unsqueeze,
Expand, Gelu, LayerNormalization, SkipLayerNormalization, FusedQKVAttention,
VitAttnBlock), under the configurations that route them; the port's ViT
builder and `_prepare` on the JAX package's ViT bytes, node for node with
bit-equal packed initializers; and the whole small ViT through `compile`
and `serve` against the JAX package's `CompiledModel`. The JAX side runs its
Pallas kernels in interpret mode on the CPU, as its own tests do; the port
takes its kernels' plain versions.
"""

import functools
import threading

import numpy as np
import pytest
import torch

import smelter_tpu as st
import smelter_tpu_torch as stt
from smelter_tpu.api import _prepare as jax_prepare
from smelter_tpu.kernels import vit_block as jvb
from smelter_tpu.models import vit as jvit
from smelter_tpu_torch.api import _prepare as torch_prepare
from smelter_tpu_torch.kernels import layer_norm as ln
from smelter_tpu_torch.kernels import vit_block as vb
from smelter_tpu_torch.models import vit
from torch_port_common import _close, _one_op, assert_graphs_equal

# ViT at test size: 224 px, patch 16 (197 tokens), dim 256 in 4 heads, 2
# layers; 197 x 256 = 50,432 clears fuse_vit_block's 50,000 gate.
SMALL = dict(batch=2, image_size=224, dim=256, depth=2, heads=4, num_classes=10)


@functools.lru_cache(maxsize=None)
def _vit_bytes() -> tuple[bytes, tuple[int, ...]]:
    g, _m, shape = jvit.build(**SMALL)
    return st.export_model(g), shape


def _image(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# -- op lowerings ----------------------------------------------------------------

def test_concat_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((2, 1, 8)).astype(np.float32)
    c = rng.standard_normal((2, 5, 8)).astype(np.float32)
    got, want = _one_op("Concat", {"a": a, "c": c}, {"axis": 1, "_order": ["a", "k", "c"]},
                        {"k": rng.standard_normal((2, 3, 8)).astype(np.float32)})
    assert np.array_equal(got[0], want[0])


@pytest.mark.parametrize("case", [
    ([1], [3], [1], None),                   # one axis
    ([0], [2 ** 31 - 1], [2], None),         # an open end
    ([-3, 0], [-1, 4], [2, 0], None),        # negative starts and ends, two axes
    ([0], [9], [2], [3]),                    # step 3
    ([-1], [-2 ** 31], [2], [-1]),           # the whole axis backwards
    ([5, 1], [0, 9], [2, 1], [-2, 2]),       # a negative and a positive step
])
def test_slice_matches_jax(case):
    starts, ends, axes, steps = case
    x = np.random.default_rng(1).standard_normal((3, 6, 9)).astype(np.float32)
    inits = {"s": np.array(starts, np.int64), "e": np.array(ends, np.int64),
             "a": np.array(axes, np.int64)}
    if steps is not None:
        inits["st"] = np.array(steps, np.int64)
    got, want = _one_op("Slice", {"x": x}, {}, inits)
    assert np.array_equal(got[0], want[0])


def test_squeeze_unsqueeze_expand_match_jax():
    x = np.random.default_rng(2).standard_normal((2, 1, 5, 1)).astype(np.float32)
    for axes in ([1], [-1, 1]):
        got, want = _one_op("Squeeze", {"x": x}, {}, {"axes": np.array(axes, np.int64)})
        assert np.array_equal(got[0], want[0])
    got, want = _one_op("Squeeze", {"x": x}, {})  # no axes: every unit dim
    assert np.array_equal(got[0], want[0])
    y = x[:, 0, :, 0]
    got, want = _one_op("Unsqueeze", {"y": y}, {}, {"axes": np.array([0, -1], np.int64)})
    assert np.array_equal(got[0], want[0]) and got[0].shape == (1, 2, 5, 1)
    cls = np.random.default_rng(3).standard_normal((1, 1, 8)).astype(np.float32)
    for shape in ([3, 1, 8], [4, 1, 1], [2, 3, 1, 1]):
        got, want = _one_op("Expand", {"c": cls}, {}, {"shape": np.array(shape, np.int64)})
        assert np.array_equal(got[0], want[0])


@pytest.mark.parametrize("approximate", ["none", "tanh"])
@pytest.mark.parametrize("config", [{}, {"compute_dtype": "bfloat16"},
                                    {"compute_dtype": "bfloat16", "gelu": "exact"},
                                    {"gelu": "tanh"}])
def test_gelu_matches_jax(approximate, config):
    """Config.gelu="auto" takes the tanh form under a reduced compute dtype;
    "exact"/"tanh" force a form."""
    x = (np.random.default_rng(4).standard_normal((4, 64)) * 3).astype(np.float32)
    got, want = _one_op("Gelu", {"x": x}, {"approximate": approximate}, **config)
    rel = 1e-6 if not config.get("compute_dtype") else 1e-2
    _close(got, want, rel)
    if config.get("compute_dtype") and config.get("gelu") is None:
        tanh = torch.nn.functional.gelu(torch.from_numpy(x).bfloat16(), approximate="tanh")
        assert np.array_equal(got[0], tanh.float().numpy())


_LN_CONFIGS = [{}, {"fused_layernorm": True}, {"use_pallas": True},
               {"use_pallas": True, "fused_layernorm": False}, {"fused_layernorm": "auto"}]


@pytest.mark.parametrize("shape", [(2, 8, 128), (3, 5, 96)])
@pytest.mark.parametrize("config", _LN_CONFIGS)
def test_layer_norm_matches_jax(shape, config):
    """The JAX routing: the kernel (its plain version here; the Pallas kernel
    in interpret mode there) under fused_layernorm=True or use_pallas unless
    fused_layernorm is False, the composite otherwise and outside the
    kernel's shape rule. "auto" engages only on the card (JAX: the TPU)."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(shape) * 2 + 1).astype(np.float32)
    g = (rng.standard_normal(shape[-1]) * 0.1 + 1).astype(np.float32)
    b = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    got, want = _one_op("LayerNormalization", {"x": x}, {"epsilon": 1e-6}, {"g": g, "b": b},
                        **config)
    _close(got, want)
    got, want = _one_op("LayerNormalization", {"x": x}, {"epsilon": 1e-6}, {"g": g}, **config)
    _close(got, want)
    got, want = _one_op("LayerNormalization", {"x": x}, {"epsilon": 1e-6}, {"g": g, "b": b},
                        compute_dtype="bfloat16", **config)
    _close(got, want, 1e-2)
    assert ln.fused_launches == 0


def test_layer_norm_over_two_axes_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    g = rng.standard_normal((3, 16)).astype(np.float32)
    for config in ({}, {"fused_layernorm": True}):  # axis 1: the composite
        _close(*_one_op("LayerNormalization", {"x": x}, {"axis": 1}, {"g": g}, **config))


@pytest.mark.parametrize("config", [{}, {"use_pallas": True}, {"fused_layernorm": True}])
@pytest.mark.parametrize("form", ["plain", "sum_out", "no_beta", "bias", "bf16"])
def test_skip_layer_norm_matches_jax(config, form):
    rng = np.random.default_rng(7)
    x, skip = ((rng.standard_normal((2, 8, 128)) * 2).astype(np.float32) for _ in range(2))
    g = (rng.standard_normal(128) * 0.1 + 1).astype(np.float32)
    inits = {"g": g, "b": (rng.standard_normal(128) * 0.1).astype(np.float32)}
    n_out = 1
    if form == "sum_out":
        n_out = ["y", "", "", "sum"]
    elif form == "no_beta":
        del inits["b"]
    elif form == "bias":  # a bias input: the composite in both packages
        inits["bias"] = (rng.standard_normal(128) * 0.1).astype(np.float32)
    if form == "bf16":
        config = dict(config, compute_dtype="bfloat16")
    got, want = _one_op("SkipLayerNormalization", {"x": x, "skip": skip}, {"epsilon": 1e-6},
                        inits, n_out=n_out, **config)
    _close(got, want, 1e-2 if form == "bf16" else 1e-5)
    if form == "sum_out":
        assert np.array_equal(got[1], want[1])
    assert ln.residual_launches == 0


@pytest.mark.parametrize("scale", [1.0, 0.125])
def test_fused_qkv_attention_matches_jax(scale):
    x = np.random.default_rng(8).standard_normal((2, 10, 3 * 32)).astype(np.float32)
    _close(*_one_op("FusedQKVAttention", {"x": x}, {"num_heads": 4, "scale": scale}))
    _close(*_one_op("FusedQKVAttention", {"x": x}, {"num_heads": 4, "scale": scale},
                    compute_dtype="bfloat16"), 2e-2)


@pytest.mark.parametrize("form", ["pre_ln", "post_ln_scale0", "keep2d", "len1d", "bf16"])
def test_vit_attn_block_op_matches_jax(form):
    """The op with its attributes: scale 0.0 means 1/sqrt(hd), the node's
    epsilon, pre_ln, the mask input and mask_filter."""
    B, N, D, H = 2, 20, 128, 4
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((B, N, D)) * 0.5).astype(np.float32)
    wqkv = (rng.standard_normal((D, 3 * D)) / np.sqrt(D)).astype(np.float32)
    bqkv = (rng.standard_normal(3 * D) * 0.02).astype(np.float32)
    wpk, bpk = jvb.pack_qkv_weights(wqkv, bqkv, H)
    inits = {"g": (rng.standard_normal(D) * 0.1 + 1).astype(np.float32),
             "b": (rng.standard_normal(D) * 0.1).astype(np.float32),
             "wpk": wpk.astype(np.float32), "bpk": bpk.astype(np.float32),
             "wp": (rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32),
             "bp": (rng.standard_normal(D) * 0.02).astype(np.float32)}
    attrs = {"num_heads": H, "scale": 0.125, "epsilon": 1e-6}
    inputs = {"x": x}
    order = ["x", "g", "b", "wpk", "bpk", "wp", "bp"]
    if form == "post_ln_scale0":
        attrs.update(scale=0.0, pre_ln=0)
    elif form in ("keep2d", "len1d"):
        lens = np.array([7, N], np.int32)
        inputs["m"] = (lens if form == "len1d"
                       else (np.arange(N)[None] < lens[:, None]).astype(np.float32))
        attrs["mask_filter"] = -1000.0
        order.append("m")
    config = {"compute_dtype": "bfloat16"} if form == "bf16" else {}
    got, want = _one_op("VitAttnBlock", inputs, dict(attrs, _order=order), inits, **config)
    _close(got, want, 3e-2 if form == "bf16" else 1e-5)
    assert vb.launches == 0


def test_config_keeps_the_jax_defaults():
    for field in ("gelu", "fused_layernorm", "use_pallas", "compute_dtype"):
        assert getattr(stt.Config(), field) == getattr(st.Config(), field), field


# -- graphs ----------------------------------------------------------------------

def test_vit_builder_matches_jax():
    g, _m, shape = vit.build(**SMALL)
    gj, _mj, shape_j = jvit.build(**SMALL)
    assert shape == shape_j
    assert_graphs_equal(gj, g)


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_prepared_vit_graph_matches_jax(layout):
    """On the JAX package's ViT bytes, the port's pipeline produces the JAX
    graph node for node: a VitAttnBlock a layer (packed initializers
    bit-equal) and a SkipLayerNormalization for each residual + LN."""
    data, _ = _vit_bytes()
    gj = jax_prepare(st.import_model(data), None, True, layout)
    gt = torch_prepare(stt.import_model(data), None, True, layout)
    assert_graphs_equal(gj, gt)
    ops = [n.op_type for n in gt.nodes]
    assert ops.count("VitAttnBlock") == SMALL["depth"]
    assert ops.count("SkipLayerNormalization") == SMALL["depth"] + 1
    assert "LayerNormalization" not in ops and "FusedQKVAttention" not in ops


def test_small_vit_blocks_stay_unfused_as_in_jax():
    """Below the 50,000 tokens x dim gate the attention stays
    FusedQKVAttention in both packages."""
    g, _m, _ = jvit.build(batch=1, image_size=64, dim=128, depth=1, heads=2, num_classes=4)
    data = st.export_model(g)
    gj = jax_prepare(st.import_model(data), None, True, "nhwc")
    gt = torch_prepare(stt.import_model(data), None, True, "nhwc")
    assert_graphs_equal(gj, gt)
    assert [n.op_type for n in gt.nodes].count("FusedQKVAttention") == 1


@pytest.mark.parametrize("config", [{}, {"compute_dtype": "bfloat16"},
                                    {"compute_dtype": "bfloat16", "use_pallas": True}])
def test_small_vit_compile_matches_jax(config):
    """compile(..., device="cpu") against the JAX package's CompiledModel on
    the same bytes: f32 within 1e-4 of the largest logit; bf16 within 3e-2 of
    it, with top-1 equal on every row whose top-2 gap exceeds twice the
    error."""
    data, shape = _vit_bytes()
    x = _image(shape)
    want = np.asarray(st.compile(st.import_model(data), st.Config(**config))(x)[0], np.float32)
    model = stt.compile(stt.import_model(data), stt.Config(**config), device="cpu")
    got = model(x)[0]
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    if not config:
        assert err <= 1e-4 * scale, err
        return
    assert err <= 3e-2 * scale, err
    top2 = np.sort(want, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * err
    assert (got.argmax(1) == want.argmax(1))[clear].all()


def test_raw_vit_graph_with_fused_layernorm_matches_jax():
    """bench.py's baseline form: the graph without passes, every
    LayerNormalization routed to the LayerNorm kernel."""
    data, shape = _vit_bytes()
    x = _image(shape, seed=1)
    cfg = dict(fused_layernorm=True)
    want = np.asarray(st.CompiledModel(st.import_model(data), st.Config(**cfg))(x)[0])
    got = stt.CompiledModel(stt.import_model(data), stt.Config(device="cpu", **cfg))(x)[0]
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_small_vit_serve_matches_jax():
    """serve(...) at the graph's pinned batch (one bucket of 2) answers
    threaded requests with the JAX package's logits."""
    import threading

    data, shape = _vit_bytes()
    xs = _image((4,) + shape[1:], seed=2)
    jm = st.compile(st.import_model(data), st.Config())
    want = np.concatenate([np.asarray(jm(xs[:2])[0]), np.asarray(jm(xs[2:])[0])])
    server = stt.serve(stt.import_model(data), stt.Config(), device="cpu", max_batch=2,
                       buckets=(2,))
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
    got = np.stack(got)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()

