"""The SegNet compile-and-serve slice of smelter_tpu_torch against smelter_tpu.

MaxPool's indices output and MaxUnpool one node at a time against the JAX
lowerings (both MaxPool forms, ties, the unpool kernel's gate and the dense
and scatter forms); the port's SegNet builder and `_prepare` on the JAX
package's SegNet bytes, node for node; and the small SegNet through
`compile` and `serve` against the JAX package's `CompiledModel`. The JAX
package runs with 64-bit types off, so its indices are int32 where the
port's are ONNX's int64: the values are compared, not the types. The JAX
side runs its Pallas kernel in interpret mode on the CPU; the port takes its
kernel's plain version.
"""

import functools
import threading

import numpy as np
import pytest

import smelter_tpu as st
import smelter_tpu_torch as stt
from smelter_tpu.api import _prepare as jax_prepare
from smelter_tpu.models import segnet as jsegnet
from smelter_tpu_torch.api import _prepare as torch_prepare
from smelter_tpu_torch.ir.errors import NotSupportedError
from smelter_tpu_torch.kernels import max_unpool as mu
from smelter_tpu_torch.models import segnet
from torch_port_common import _one_op, assert_graphs_equal, image

SMALL = dict(batch=2, image_size=64, base=8)


@functools.lru_cache(maxsize=None)
def _bytes(**overrides) -> tuple[bytes, tuple[int, ...]]:
    g, _m, shape = jsegnet.build(**{**SMALL, **overrides})
    return st.export_model(g), shape


def _pool_input(shape, ties: bool, seed=0):
    rng = np.random.default_rng(seed)
    if ties:  # few distinct values: most windows hold their max more than once
        return rng.integers(-2, 3, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


# -- MaxPool with indices -----------------------------------------------------------

@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape,attrs", [
    ((2, 3, 8, 10), {"kernel_shape": [2, 2], "strides": [2, 2]}),       # SegNet's
    ((2, 3, 7, 11), {"kernel_shape": [2, 3], "strides": [2, 3]}),       # cropped edges
    ((1, 2, 9), {"kernel_shape": [3], "strides": [3]}),                 # 1-D
    ((1, 2, 4, 6, 6), {"kernel_shape": [2, 2, 3], "strides": [2, 2, 3]}),  # 3-D
    ((2, 3, 8, 10), {"kernel_shape": [3, 3], "strides": [2, 2], "pads": [1, 1, 1, 1]}),
    ((2, 2, 7, 9), {"kernel_shape": [2, 2], "strides": [1, 1]}),        # overlapping
    ((1, 2, 9, 9), {"kernel_shape": [2, 2], "strides": [2, 2], "dilations": [2, 2]}),
    ((1, 2, 7, 7), {"kernel_shape": [2, 2], "strides": [2, 2], "ceil_mode": 1}),
    ((1, 2, 6, 7), {"kernel_shape": [3, 2], "strides": [2, 1], "pads": [0, 1, 2, 0]}),
])
def test_max_pool_indices_match_jax(shape, attrs, ties):
    """Values and indices equal, the first max in row-major tap order on
    ties, over both forms of the lowering."""
    x = _pool_input(shape, ties)
    got, want = _one_op("MaxPool", {"x": x}, dict(attrs), n_out=2)
    assert np.array_equal(got[0], want[0])
    assert got[1].dtype == np.int64 and got[1].shape == want[1].shape
    assert np.array_equal(got[1], want[1].astype(np.int64))


def test_max_pool_indices_match_torch_per_plane():
    """ONNX's flat [N, C, H, W] indices are torch's per-plane ones plus the
    plane's offset."""
    import torch
    import torch.nn.functional as F

    x = _pool_input((2, 3, 8, 10), ties=False, seed=1)
    got, _ = _one_op("MaxPool", {"x": x}, {"kernel_shape": [2, 2], "strides": [2, 2]}, n_out=2)
    _, plane = F.max_pool2d(torch.from_numpy(x), 2, 2, return_indices=True)
    offs = np.arange(6).reshape(2, 3, 1, 1) * 80
    assert np.array_equal(got[1], plane.numpy() + offs)


@pytest.mark.parametrize("attrs", [{"data_layout": "NHWC"}, {"storage_order": 1}])
def test_max_pool_indices_unsupported_forms_raise(attrs):
    from smelter_tpu_torch.ir.build import GraphBuilder
    from smelter_tpu_torch.runtime.executor import Executor

    b = GraphBuilder("op", opset=17)
    b.input("x", (1, 2, 4, 4), 1)
    outs = b.node("MaxPool", ["x"], kernel_shape=[2, 2], strides=[2, 2], outputs=2, **attrs)
    ex = Executor(b.finish(outs), stt.Config(device="cpu"))
    with pytest.raises(NotSupportedError):
        ex.build_fn()(ex.init_params(), np.zeros((1, 2, 4, 4), np.float32))


# -- MaxUnpool ----------------------------------------------------------------------

def _pooled(shape, kernel, strides, seed=2):
    """x pooled by MaxPool with indices (the JAX lowering's outputs)."""
    x = _pool_input(shape, ties=False, seed=seed)
    _, (val, idx) = _one_op("MaxPool", {"x": x}, {"kernel_shape": kernel, "strides": strides},
                            n_out=2)
    return val, idx.astype(np.int64)


@pytest.mark.parametrize("form", ["kernel", "kernel_bf16", "dense_odd", "dense_3x3",
                                  "scatter"])
def test_max_unpool_matches_jax(form):
    """Under the 2x2/s2 gate the kernel (its plain version here, the Pallas
    kernel in interpret mode there); an output with an odd extra row and
    column or 3x3 windows the dense form; overlapping windows the scatter."""
    config = {"compute_dtype": "bfloat16"} if form == "kernel_bf16" else {}
    shape, kernel, strides = {
        "kernel": ((2, 3, 8, 10), [2, 2], [2, 2]),
        "kernel_bf16": ((2, 3, 8, 10), [2, 2], [2, 2]),
        "dense_odd": ((2, 3, 9, 11), [2, 2], [2, 2]),
        "dense_3x3": ((1, 2, 9, 12), [3, 3], [3, 3]),
        "scatter": ((1, 2, 9, 9), [3, 3], [2, 2]),
    }[form]
    val, idx = _pooled(shape, kernel, strides)
    out_shape = np.array(shape, np.int64)
    got, want = _one_op("MaxUnpool", {"v": val, "i": idx},
                        {"kernel_shape": kernel, "strides": strides,
                         "_order": ["v", "i", "shape"]},
                        {"shape": out_shape}, **config)
    assert got[0].shape == tuple(shape) and np.array_equal(got[0], want[0])
    assert mu.launches == 0


def test_max_unpool_without_output_shape_matches_jax():
    val, idx = _pooled((2, 3, 8, 10), [2, 2], [2, 2])
    got, want = _one_op("MaxUnpool", {"v": val, "i": idx},
                        {"kernel_shape": [2, 2], "strides": [2, 2]})
    assert got[0].shape == (2, 3, 8, 10) and np.array_equal(got[0], want[0])


def test_unpool_gate_is_the_jax_gate():
    from smelter_tpu.ops.nn import _unpool2x2_kernel_ok as jax_gate
    from smelter_tpu_torch.ops.nn import _unpool2x2_kernel_ok as gate

    cases = [((2, 3, 4, 5), (2, 3, 8, 10), [2, 2], [2, 2], [0] * 4, 2),
             ((2, 3, 4, 5), (2, 3, 9, 10), [2, 2], [2, 2], [0] * 4, 2),
             ((2, 3, 4, 5), (2, 3, 8, 10), [2, 2], [2, 2], [1, 0, 0, 0], 2),
             ((2, 3, 4, 5), (2, 3, 12, 15), [3, 3], [3, 3], [0] * 4, 2),
             ((1, 1024, 1024, 1024), (1, 1024, 2048, 2048), [2, 2], [2, 2], [0] * 4, 2)]
    for case in cases:
        assert gate(*case) == jax_gate(*case), case
    assert [gate(*c) for c in cases] == [True, False, False, False, False]


# -- Conv's bias ------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("group", [1, 2])
def test_conv_bias_adds_after_the_rounding_as_jax_does(layout, group):
    """A bf16 Conv with a bias, one node, bit-equal to the JAX lowering: the
    conv rounds to bf16, then the bias adds in bf16 (added inside the conv,
    before the rounding, hundreds of outputs land an ulp apart). Small
    integer inputs and weights in eighths make every f32 sum exact, so the
    two libraries' summation orders cannot tell the outputs apart (on
    normal draws an output in 10^4 or 10^5 rounds to another bf16 there)."""
    rng = np.random.default_rng(8)
    x = rng.integers(-3, 4, (2, 16, 32, 32)).astype(np.float32)
    w = (rng.integers(-8, 9, (32, 16 // group, 3, 3)) / 8).astype(np.float32)
    b = (rng.standard_normal(32) * 3).astype(np.float32)
    attrs = {"kernel_shape": [3, 3], "pads": [1, 1, 1, 1], "group": group}
    if layout == "NHWC":
        x, w = x.transpose(0, 2, 3, 1).copy(), w.transpose(2, 3, 1, 0).copy()  # HWIO
        attrs["data_layout"] = "NHWC"
    got, want = _one_op("Conv", {"x": x}, attrs, {"w": w, "b": b}, compute_dtype="bfloat16")
    assert got[0].shape == want[0].shape and np.isfinite(got[0]).all()
    assert np.array_equal(got[0], want[0])


# -- graphs ----------------------------------------------------------------------

def test_segnet_builder_matches_jax():
    g, _m, shape = segnet.build(**SMALL)
    gj, _mj, shape_j = jsegnet.build(**SMALL)
    assert shape == shape_j
    assert_graphs_equal(gj, g)


@pytest.mark.parametrize("overrides", [{}, {"image_size": 32, "base": 16},
                                       {"image_size": 128, "base": 32}])
@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_prepared_segnet_graph_matches_jax(overrides, layout):
    """The port's pipeline on the JAX package's bytes gives the JAX graph
    node for node: 3 MaxPool with indices and 3 MaxUnpool."""
    data, _ = _bytes(**overrides)
    gj = jax_prepare(st.import_model(data), None, True, layout)
    gt = torch_prepare(stt.import_model(data), None, True, layout)
    assert_graphs_equal(gj, gt)
    ops = [n.op_type for n in gt.nodes]
    assert ops.count("MaxUnpool") == 3 and ops.count("MaxPool") == 3


@functools.lru_cache(maxsize=None)
def _jax_logits(compute_dtype: str):
    data, shape = _bytes()
    return np.asarray(st.compile(st.import_model(data), st.Config(compute_dtype=compute_dtype))(
        image(shape))[0], np.float32)


def _port_logits(compute_dtype: str):
    data, shape = _bytes()
    return stt.compile(stt.import_model(data), stt.Config(compute_dtype=compute_dtype),
                       device="cpu")(image(shape))[0]


def test_small_segnet_compile_matches_jax():
    """compile(..., device="cpu") in f32 against the JAX package's
    CompiledModel on the same bytes: within 1e-5 of the largest logit."""
    want, got = _jax_logits("float32"), _port_logits("float32")
    assert got.shape == want.shape == (2, 2, 64, 64) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert mu.launches == 0


def test_small_segnet_bf16_matches_jax():
    """bf16: where a pool window's two largest values lie within a bf16
    rounding of each other, the rounding picks the index, and the unpooled
    value moves inside its window, so a sum taken in another order can move
    it (the two packages' bf16 runs agree here, since Conv rounds before
    its bias in both). Bounds: the port's bf16 error against the JAX f32
    within 1.5x the JAX bf16's own, and the two bf16 runs within twice
    that error of each other."""
    f32, want, got = _jax_logits("float32"), _jax_logits("bfloat16"), _port_logits("bfloat16")
    assert got.shape == want.shape and np.isfinite(got).all()
    err_jax = np.abs(want - f32).max()
    assert np.abs(got - f32).max() <= 1.5 * err_jax
    assert np.abs(got - want).max() <= 2 * err_jax


def test_small_segnet_serve_matches_jax():
    """serve(...) at the graph's batch of 2 answers threaded requests with the
    JAX package's logits."""
    data, shape = _bytes()
    xs = image((4,) + shape[1:], seed=3)
    jm = st.compile(st.import_model(data))
    want = np.concatenate([np.asarray(jm(xs[:2])[0]), np.asarray(jm(xs[2:])[0])])
    server = stt.serve(stt.import_model(data), device="cpu", max_batch=2, buckets=(2,))
    got = [None] * 4
    try:
        assert server.wait_ready(120)
        threads = [threading.Thread(target=lambda i=i: got.__setitem__(
            i, server.infer(xs[i])[0])) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        stats = server.stats()
    finally:
        server.shutdown()
    assert stats["requests"] == 4 and stats["errors"] == 0
    assert np.abs(np.stack(got) - want).max() <= 1e-5 * np.abs(want).max()
