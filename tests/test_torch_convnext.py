"""The ConvNeXt compile-and-serve slice of smelter_tpu_torch against smelter_tpu.

The new op lowerings one node at a time (OptimizationBarrier, ReduceMean,
ConvNeXtBlock); the port's ConvNeXt builder graph-equal to the JAX
package's; `_prepare` node for node with its barriers, then
`fuse_convnext_block` run explicitly on both packages (its gate patched to 0,
and once unpatched at the real gate), which a missing lowering would turn
into a silent no-op; and the small ConvNeXt through `compile` and `serve`
against the JAX package's `CompiledModel`, also under quant="int8" with the
fused pass folding the dequant wrappers. The JAX side runs its Pallas kernel
in interpret mode on the CPU, as its own tests do; the port takes its
kernels' plain versions.
"""

import copy
import functools
import threading

import numpy as np
import pytest

import smelter_tpu as st
import smelter_tpu.passes.vit_block as jvbp
import smelter_tpu_torch as stt
import smelter_tpu_torch.passes.vit_block as tvbp
from smelter_tpu.api import _prepare as jax_prepare
from smelter_tpu.models import convnext as jconvnext
from smelter_tpu.passes.pass_manager import run_passes as jax_run_passes
from smelter_tpu_torch.api import _prepare as torch_prepare
from smelter_tpu_torch.kernels import convnext_block as cb
from smelter_tpu_torch.models import convnext
from smelter_tpu_torch.passes.pass_manager import run_passes as torch_run_passes
from torch_port_common import _close, _one_op, assert_graphs_equal

# ConvNeXt at test size: 64 px, dims 32/64/128/256, depths 1/1/2/1, 10
# classes (5 blocks, each below the 50,000 tokens x dim gate).
SMALL = dict(batch=2, image_size=64, dims=(32, 64, 128, 256), depths=(1, 1, 2, 1),
             num_classes=10)
N_BLOCKS = sum(SMALL["depths"])


@functools.lru_cache(maxsize=None)
def _convnext_bytes(**overrides) -> tuple[bytes, tuple[int, ...]]:
    """The JAX package's graph with its layer scales drawn from [0.2, 0.6):
    at the 1e-6 init every block adds too little to show in the outputs."""
    g, _m, shape = jconvnext.build(**{**SMALL, **overrides})
    rng = np.random.default_rng(7)
    for name, arr in g.initializers.items():
        if name.endswith("_gamma"):
            g.initializers[name] = rng.uniform(0.2, 0.6, arr.shape).astype(np.float32)
    return st.export_model(g), shape


def _image(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture
def gate_open(monkeypatch):
    """fuse_convnext_block's tokens x dim gate at 0 in both packages."""
    monkeypatch.setattr(jvbp, "_MIN_TOKENS_X_DIM", 0)
    monkeypatch.setattr(tvbp, "_MIN_TOKENS_X_DIM", 0)


def _fused_pair(quant=None, **overrides):
    """(JAX graph, port graph): `_prepare` and then fuse_convnext_block and
    dce, as tests/test_vit_block_pass.py runs it explicitly."""
    data, shape = _convnext_bytes(**overrides)
    gj = jax_prepare(st.import_model(data), quant, True, "nhwc")
    gt = torch_prepare(stt.import_model(data), quant, True, "nhwc")
    jax_run_passes(gj, ["fuse_convnext_block", "dce"])
    torch_run_passes(gt, ["fuse_convnext_block", "dce"])
    return gj, gt, shape


def _count(g, op: str) -> int:
    return sum(n.op_type == op for n in g.nodes)


# -- op lowerings ----------------------------------------------------------------

def test_optimization_barrier_is_the_identity_as_in_jax():
    x = np.random.default_rng(0).standard_normal((2, 5, 7, 8)).astype(np.float32)
    got, want = _one_op("OptimizationBarrier", {"x": x}, {})
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[0], x)


@pytest.mark.parametrize("axes,keepdims,opset", [
    ([1, 2], 0, 17),     # the global pool after the layout pass, axes as an attribute
    ([1, 2], 1, 18),     # axes as an input (opset 18)
    ([-1], 1, 17),       # a negative axis
    (None, 0, 17),       # every axis
])
@pytest.mark.parametrize("config", [{}, {"compute_dtype": "bfloat16"}])
def test_reduce_mean_matches_jax(axes, keepdims, opset, config):
    x = (np.random.default_rng(1).standard_normal((2, 7, 7, 16)) * 3 + 1).astype(np.float32)
    attrs, inits = {"keepdims": keepdims}, {}
    if axes is not None and opset >= 18:
        inits["axes"] = np.array(axes, np.int64)
    elif axes is not None:
        attrs["axes"] = axes
    got, want = _one_op("ReduceMean", {"x": x}, attrs, inits, opset=opset, **config)
    _close(got, want, 1e-2 if config else 1e-6)


def _block_inits(C, seed=0):
    rng = np.random.default_rng(seed)
    F = 4 * C
    return {"dw": (rng.standard_normal((7, 7, 1, C)) / 7).astype(np.float32),
            "db": (0.1 * rng.standard_normal(C)).astype(np.float32),
            "g": (1 + 0.1 * rng.standard_normal(C)).astype(np.float32),
            "b": (0.1 * rng.standard_normal(C)).astype(np.float32),
            "w1": (rng.standard_normal((C, F)) / np.sqrt(C)).astype(np.float32),
            "b1": (0.1 * rng.standard_normal(F)).astype(np.float32),
            "w2": (rng.standard_normal((F, C)) / np.sqrt(F)).astype(np.float32),
            "b2": (0.1 * rng.standard_normal(C)).astype(np.float32),
            "gm": (0.5 + 0.1 * rng.standard_normal(C)).astype(np.float32)}


@pytest.mark.parametrize("shape", [(2, 9, 11, 32), (1, 14, 14, 24)])
@pytest.mark.parametrize("config", [{}, {"compute_dtype": "bfloat16"}])
def test_convnext_block_op_matches_jax(shape, config):
    """The op against the JAX op, which runs the Pallas kernel in interpret
    mode: f32 within 1e-5 of the largest output, bf16 within 1e-2."""
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    got, want = _one_op("ConvNeXtBlock", {"x": x}, {"epsilon": 1e-6},
                        _block_inits(shape[-1]), **config)
    _close(got, want, 1e-2 if config else 1e-5)
    assert cb.launches == 0


# -- graphs ----------------------------------------------------------------------

def test_convnext_builder_matches_jax():
    g, _m, shape = convnext.build(**SMALL)
    gj, _mj, shape_j = jconvnext.build(**SMALL)
    assert shape == shape_j
    assert_graphs_equal(gj, g)


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_prepared_convnext_matches_jax(layout):
    """The default passes, node for node: an OptimizationBarrier after each
    block's depthwise conv under the NHWC pipeline, and no ConvNeXtBlock
    (the fusion is off by default)."""
    data, _ = _convnext_bytes()
    gj = jax_prepare(st.import_model(data), None, True, layout)
    gt = torch_prepare(stt.import_model(data), None, True, layout)
    assert_graphs_equal(gj, gt)
    assert _count(gt, "OptimizationBarrier") == (N_BLOCKS if layout == "nhwc" else 0)
    assert _count(gt, "ReduceMean") == 1 and _count(gt, "ConvNeXtBlock") == 0


@pytest.mark.parametrize("quant", [None, "int8"])
def test_fused_convnext_graph_matches_jax(gate_open, quant):
    """fuse_convnext_block after `_prepare`, gate at 0: every block fuses in
    both packages (int8: the dequant wrappers folded to f32 initializers),
    node for node, and the barriers go with the blocks."""
    gj, gt, _ = _fused_pair(quant)
    assert_graphs_equal(gj, gt)
    assert _count(gt, "ConvNeXtBlock") == N_BLOCKS
    assert _count(gt, "OptimizationBarrier") == 0


def test_fused_weights_upload_as_the_op_expects(gate_open):
    """The pass's fresh f32 initializers (the depthwise `*_f32` and
    `cnx_w1_f32` / `cnx_w2_f32`) reach the device as stored: no NHWC Conv
    reads them, so `params_from_numpy` leaves them out of its HWIO relayout
    and hands them over contiguous, in their (7, 7, 1, C), (C, 4C) and
    (4C, C) shapes and values."""
    import torch

    from smelter_tpu_torch.weights import hwio_conv_weights, params_from_numpy

    _, gt, _ = _fused_pair()
    blocks = [n for n in gt.nodes if n.op_type == "ConvNeXtBlock"]
    fresh = {n.inputs[i] for n in blocks for i in (1, 5, 7)}
    assert all("_f32" in name for name in fresh) and len(fresh) == 3 * N_BLOCKS
    assert not fresh & hwio_conv_weights(gt)
    params = params_from_numpy({k: gt.initializers[k] for k in fresh}, "cpu", graph=gt)
    for n in blocks:
        c = gt.initializers[n.inputs[2]].size
        for i, shape in ((1, (7, 7, 1, c)), (5, (c, 4 * c)), (7, (4 * c, c))):
            t = params[n.inputs[i]]
            assert tuple(t.shape) == shape and t.is_contiguous() and t.dtype == torch.float32
            assert np.array_equal(t.numpy(), gt.initializers[n.inputs[i]])


def test_fusion_at_the_real_gate_matches_jax():
    """Unpatched: at 128 px with dim 64 the stage-1 block (32 x 32 x 64 =
    65,536 >= 50,000) fuses and the stage-2 block (16 x 16 x 128) does not."""
    gj, gt, _ = _fused_pair(image_size=128, dims=(64, 128, 256, 512), depths=(1, 1, 1, 1))
    assert_graphs_equal(gj, gt)
    assert _count(gt, "ConvNeXtBlock") == 1 and _count(gt, "OptimizationBarrier") == 3


# -- compile and serve -------------------------------------------------------------

def _assert_logits_close(got, want, config):
    """f32 within 1e-4 of the largest logit; bf16 within 3e-2 of it, top-1
    equal on every row whose top-2 gap exceeds twice the error."""
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    if not config.get("compute_dtype"):
        assert err <= 1e-4 * scale, err
        return
    assert err <= 3e-2 * scale, err
    top2 = np.sort(want, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * err
    assert (got.argmax(1) == want.argmax(1))[clear].all()


@pytest.mark.parametrize("config", [{}, {"compute_dtype": "bfloat16"}])
def test_small_convnext_compile_matches_jax(config):
    data, shape = _convnext_bytes()
    x = _image(shape)
    want = np.asarray(st.compile(st.import_model(data), st.Config(**config))(x)[0], np.float32)
    got = stt.compile(stt.import_model(data), stt.Config(**config), device="cpu")(x)[0]
    _assert_logits_close(got, want, config)


@pytest.mark.parametrize("quant,config", [(None, {}), (None, {"compute_dtype": "bfloat16"}),
                                          ("int8", {})])
def test_fused_convnext_matches_jax(gate_open, quant, config):
    """The fused graphs through both packages' CompiledModel: ConvNeXtBlock
    on the Pallas kernel (interpret mode) against the port's plain version."""
    gj, gt, shape = _fused_pair(quant)
    x = _image(shape, seed=1)
    want = np.asarray(st.CompiledModel(gj, st.Config(**config))(x)[0], np.float32)
    got = stt.CompiledModel(gt, stt.Config(device="cpu", **config))(x)[0]
    _assert_logits_close(got, want, config)
    assert cb.launches == 0


def test_fused_convnext_serve_matches_jax(gate_open):
    """serve(...) of the fused graph (optimize=False) at its pinned batch of
    2 answers threaded requests, one short batch padded, with the JAX
    package's logits."""
    gj, gt, shape = _fused_pair()
    xs = _image((3,) + shape[1:], seed=2)
    jm = st.CompiledModel(gj, st.Config())
    want = np.concatenate([np.asarray(jm(xs[:2])[0]),
                           np.asarray(jm(np.concatenate([xs[2:], xs[:1]]))[0])[:1]])
    server = stt.serve(copy.deepcopy(gt), stt.Config(), optimize=False, device="cpu",
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
    assert stats["requests"] == 3 and stats["errors"] == 0
    assert np.abs(np.stack(got) - want).max() <= 1e-4 * np.abs(want).max()
