"""The ESRGAN compile-and-serve slice of smelter_tpu_torch against smelter_tpu.

The new op lowerings one node at a time (LeakyRelu, nearest Resize,
PixelNearestUp, PixelConv, PixelConvQ) against the JAX lowerings; the port's
RRDBNet builder and `_prepare` on the JAX package's ESRGAN bytes, node for
node, with at least one PixelConv (pixel_conv_regions fires only when every
op of the graph has a lowering: its type inference runs the lowerings);
the small ESRGAN through `compile` and `serve` against the JAX package's
`CompiledModel`; and int8-pixel: calibration, the quantized graph and its
outputs. The JAX side runs its Pallas kernels in interpret mode on the CPU,
as its own tests do; the port takes its kernels' plain versions.
"""

import functools
import threading

import numpy as np
import pytest

import smelter_tpu as st
import smelter_tpu_torch as stt
from smelter_tpu.api import _prepare as jax_prepare
from smelter_tpu.models import esrgan as jesrgan
from smelter_tpu.passes.pass_manager import run_passes as jax_run_passes
from smelter_tpu.quant import calibrate as jax_calibrate
from smelter_tpu.quant import quantize_pixel_regions as jax_quantize_pixel_regions
from smelter_tpu_torch.api import _prepare as torch_prepare
from smelter_tpu_torch.ir.errors import NotSupportedError
from smelter_tpu_torch.kernels import pixel_conv as pc
from smelter_tpu_torch.models import esrgan
from smelter_tpu_torch.passes.pass_manager import run_passes
from smelter_tpu_torch.quant import calibrate, quantize_pixel_regions
from torch_port_common import _close, _one_op, assert_graphs_equal, image

# ESRGAN at test size: nf 16, one RRDB (3 dense blocks of 5 convs), 128 px,
# batch 1. Every trunk conv (W 128) and the tail's (W 256) are eligible for
# PixelConv: 15 + conv_body + upconv1 + conv_hr = 18 at scale 2, 19 at 4.
SMALL = dict(batch=1, image_size=128, nf=16, nb=1, scale=2)


@functools.lru_cache(maxsize=None)
def _bytes(scale: int = 2) -> tuple[bytes, tuple[int, ...]]:
    g, _m, shape = jesrgan.build(**dict(SMALL, scale=scale))
    return st.export_model(g), shape


# -- op lowerings ----------------------------------------------------------------

@pytest.mark.parametrize("config", [{}, {"compute_dtype": "bfloat16"}])
def test_leaky_relu_matches_jax(config):
    x = np.random.default_rng(0).standard_normal((2, 3, 8, 16)).astype(np.float32)
    x[0, 0, 0, :3] = [0.0, -0.0, -1e-30]
    for attrs in ({}, {"alpha": 0.2}):
        got, want = _one_op("LeakyRelu", {"x": x}, attrs, **config)
        assert np.array_equal(got[0], want[0])


@pytest.mark.parametrize("form", ["sizes_2x", "sizes_3x2", "scales_2x", "sizes_odd", "nhwc"])
def test_nearest_resize_matches_jax(form):
    """The fx exporter's form (asymmetric, floor, a sizes input) at integer
    factors and at a non-integer ratio (the gather), a scales input, and the
    layout pass's NHWC form."""
    x = np.random.default_rng(1).standard_normal((2, 3, 5, 6)).astype(np.float32)
    attrs = {"mode": "nearest", "coordinate_transformation_mode": "asymmetric",
             "nearest_mode": "floor"}
    roi, empty = np.array([], np.float32), np.array([], np.float32)
    if form == "scales_2x":
        inits = {"roi": roi, "scales": np.array([1, 1, 2, 2], np.float32)}
    else:
        sizes = {"sizes_2x": [2, 3, 10, 12], "sizes_3x2": [2, 3, 15, 12],
                 "sizes_odd": [2, 3, 7, 13], "nhwc": [2, 3, 10, 18]}[form]
        inits = {"roi": roi, "scales": empty, "sizes": np.array(sizes, np.int64)}
    if form == "nhwc":
        attrs["data_layout"] = "NHWC"
        x = x.transpose(0, 2, 3, 1).copy()
    got, want = _one_op("Resize", {"x": x}, attrs, inits)
    assert np.array_equal(got[0], want[0]) and got[0].shape == want[0].shape


@pytest.mark.parametrize("attrs", [
    {"mode": "linear", "coordinate_transformation_mode": "asymmetric"},
    {"mode": "nearest"},  # half_pixel, round_prefer_floor: ONNX's defaults
    {"mode": "nearest", "coordinate_transformation_mode": "asymmetric",
     "nearest_mode": "round_prefer_ceil"},
])
def test_other_resize_modes_raise(attrs):
    from smelter_tpu_torch.ir.build import GraphBuilder
    from smelter_tpu_torch.runtime.executor import Executor

    b = GraphBuilder("op", opset=17)
    b.input("x", (1, 2, 4, 4), 1)
    out = b.node("Resize", ["x", b.init(np.array([], np.float32), "roi"),
                            b.init(np.array([1, 1, 2, 2], np.float32), "scales")], **attrs)
    ex = Executor(b.finish([out]), stt.Config(device="cpu"))
    with pytest.raises(NotSupportedError):
        ex.build_fn()(ex.init_params(), np.zeros((1, 2, 4, 4), np.float32))


def test_pixel_nearest_up_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 4, 3, 5)).astype(np.float32)
    for sh, sw in ((2, 2), (3, 1)):
        got, want = _one_op("PixelNearestUp", {"x": x}, {"sh": sh, "sw": sw})
        assert np.array_equal(got[0], want[0])


def _pixel_conv_inits(cin, cout, seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((cout, cin, 3, 3)) / (3 * np.sqrt(cin))).astype(np.float32),
            "b": rng.standard_normal(cout).astype(np.float32)}


@pytest.mark.parametrize("alpha", [None, 0.2, 0.0])
@pytest.mark.parametrize("cin,cout", [(16, 8), (32, 16), (48, 64)])
@pytest.mark.parametrize("config", [{}, {"compute_dtype": "bfloat16"}])
def test_pixel_conv_matches_jax(alpha, cin, cout, config):
    """The port's plain version against `pixel_conv_rowdot` in interpret mode
    through the op: f32 within 1e-5 of the largest output (sums in other
    orders); bf16 within 1e-2 (one rounding of f32 sums of bf16 operands)."""
    x = np.random.default_rng(3).standard_normal((2, 16, cin, 128)).astype(np.float32)
    attrs = {"data_layout": "NHCW"} if alpha is None else {"data_layout": "NHCW", "alpha": alpha}
    got, want = _one_op("PixelConv", {"x": x}, attrs, _pixel_conv_inits(cin, cout, 4), **config)
    _close(got, want, 1e-2 if config else 1e-5)
    assert pc.launches == 0


def _pixel_conv_q_case(requant, alpha, config, seed=5):
    rng = np.random.default_rng(seed)
    cin, cout = 32, 16
    xq = rng.integers(-127, 128, (2, 16, cin, 128), dtype=np.int8)
    inits = {"w": rng.integers(-127, 128, (cout, cin, 3, 3), dtype=np.int8),
             "s": rng.uniform(1e-4, 1e-3, cout).astype(np.float32),
             "b": rng.standard_normal(cout).astype(np.float32)}
    attrs = {"data_layout": "NHCW", "inv_sy": 5.0, "requant": requant}
    if alpha is not None:
        attrs["alpha"] = alpha
    return _one_op("PixelConvQ", {"x": xq}, attrs, inits, **config)


@pytest.mark.parametrize("requant", [1, 0])
@pytest.mark.parametrize("alpha", [None, 0.2])
@pytest.mark.parametrize("config", [{}, {"compute_dtype": "bfloat16"}])
def test_pixel_conv_q_matches_jax(requant, alpha, config):
    """Exact int32 sums and the same epilogue: the int8 outputs (requant)
    bit-equal, spread over the whole grid; the float outputs within 1e-6 of
    the largest, since XLA on the CPU contracts acc * scale + bias into one
    fused multiply-add where the port rounds the product and the sum."""
    got, want = _pixel_conv_q_case(requant, alpha, config)
    assert got[0].dtype == want[0].dtype
    if requant:
        assert got[0].dtype == np.int8 and np.array_equal(got[0], want[0])
        assert {-127, 127} <= set(np.unique(got[0]).tolist())
    else:
        _close(got, want, 1e-6)
    assert pc.q_launches == 0


# -- graphs ----------------------------------------------------------------------

@pytest.mark.parametrize("scale", [2, 4])
def test_esrgan_builder_matches_jax(scale):
    g, _m, shape = esrgan.build(**dict(SMALL, scale=scale))
    gj, _mj, shape_j = jesrgan.build(**dict(SMALL, scale=scale))
    assert shape == shape_j
    assert_graphs_equal(gj, g)


@pytest.mark.parametrize("scale,n_pixel", [(2, 18), (4, 19)])
@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_prepared_esrgan_graph_matches_jax(scale, n_pixel, layout):
    """On the JAX package's bytes the port's pipeline produces the JAX graph
    node for node, its trunk and tail convs as PixelConv (with LeakyReLU
    fused) and its nearest upsamples as PixelNearestUp."""
    data, _ = _bytes(scale)
    gj = jax_prepare(st.import_model(data), None, True, layout)
    gt = torch_prepare(stt.import_model(data), None, True, layout)
    assert_graphs_equal(gj, gt)
    ops = [n.op_type for n in gt.nodes]
    assert ops.count("PixelConv") == n_pixel
    assert ops.count("PixelNearestUp") == scale // 2
    assert "Resize" not in ops and "LeakyRelu" not in ops


@functools.lru_cache(maxsize=None)
def _jax_outputs(compute_dtype: str):
    data, shape = _bytes()
    return st.compile(st.import_model(data), st.Config(compute_dtype=compute_dtype))(
        image(shape))[0]


@pytest.mark.parametrize("compute_dtype,rel", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_small_esrgan_compile_matches_jax(compute_dtype, rel):
    """compile(..., device="cpu") against the JAX package's CompiledModel on
    the same bytes: f32 within 1e-5 of the largest output, bf16 within 1e-2."""
    data, shape = _bytes()
    want = np.asarray(_jax_outputs(compute_dtype), np.float32)
    model = stt.compile(stt.import_model(data), stt.Config(compute_dtype=compute_dtype),
                        device="cpu")
    got = model(image(shape))[0]
    assert got.shape == want.shape == (1, 3, 256, 256) and np.isfinite(got).all()
    # weights.py stores every PixelConv weight as the kernel reads it,
    # [3, 3, C_out, C_in], once (an OIHW view over that buffer)
    for node in model.graph.nodes:
        if node.op_type == "PixelConv":
            assert model._run_params[node.inputs[1]].permute(2, 3, 0, 1).is_contiguous()
    assert np.abs(got - want).max() <= rel * np.abs(want).max()
    assert pc.launches == 0


def test_small_esrgan_serve_matches_compile():
    """serve(...) at the graph's pinned batch answers threaded requests with
    the compiled model's outputs."""
    data, shape = _bytes()
    xs = image((3,) + shape[1:], seed=1)
    model = stt.compile(stt.import_model(data), device="cpu")
    want = np.concatenate([model(xs[i:i + 1])[0] for i in range(3)])
    server = stt.serve(stt.import_model(data), device="cpu", max_batch=1, buckets=(1,))
    got = [None] * 3
    try:
        assert server.wait_ready(120)
        threads = [threading.Thread(target=lambda i=i: got.__setitem__(
            i, server.infer(xs[i])[0])) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        stats = server.stats()
    finally:
        server.shutdown()
    assert stats["requests"] == 3 and stats["errors"] == 0
    assert np.array_equal(np.stack(got), want)


# -- int8-pixel --------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_int8():
    """The JAX package's optimized graph, its amax over one calibration
    batch, its int8-pixel graph and that graph's outputs."""
    data, shape = _bytes()
    x = image(shape)
    g = st.import_model(data)
    jax_run_passes(g)
    amax = jax_calibrate(g, [(x,)])
    gq = jax_prepare(st.import_model(data), "int8-pixel", True, "nhwc", [(x,)])
    out = np.asarray(st.CompiledModel(gq, st.Config())(x)[0], np.float32)
    return amax, gq, out


def test_calibrate_matches_jax():
    """The same edges, each abs-max within 1e-6 relative of the JAX
    package's (the convs sum in other orders)."""
    amax_j, _, _ = _jax_int8()
    data, shape = _bytes()
    g = stt.import_model(data)
    run_passes(g)
    amax = calibrate(g, [(image(shape),)], stt.Config(device="cpu"))
    assert set(amax) == set(amax_j) and len(amax) > 20
    for k, v in amax_j.items():
        assert abs(amax[k] - v) <= 1e-6 * v, (k, amax[k], v)


def test_calibrate_percentile_matches_jax():
    """percentile=99.9 subsamples large edges on the host by the JAX rule."""
    data, shape = _bytes()
    x = image(shape, seed=2)
    gj, gt = st.import_model(data), stt.import_model(data)
    jax_run_passes(gj)
    run_passes(gt)
    want = jax_calibrate(gj, [(x,)], percentile=99.9)
    got = calibrate(gt, [(x,)], stt.Config(device="cpu"), percentile=99.9)
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-5 * v, (k, got[k], v)


def test_quantize_pixel_regions_matches_jax():
    """Fed the JAX amax, the port's rewrite gives the JAX package's int8-pixel
    graph node for node, int8 weights and scales bit-equal: 18 PixelConvQ."""
    amax_j, _, _ = _jax_int8()
    data, _ = _bytes()
    gj, gt = st.import_model(data), stt.import_model(data)
    jax_run_passes(gj)
    run_passes(gt)
    assert jax_quantize_pixel_regions(gj, amax_j) == quantize_pixel_regions(gt, amax_j) == 18
    assert_graphs_equal(gj, gt)
    ops = [n.op_type for n in gt.nodes]
    assert ops.count("PixelConvQ") == 18 and "PixelConv" not in ops


def test_int8_pixel_compile_matches_jax():
    """compile(quant="int8-pixel") calibrated on the CPU against the JAX
    package's, each on its own calibration: int8 edges equal except flips at
    a half-way point of the grid, so the outputs agree within 1e-3 of the
    largest output, 10x below int8-pixel's own error against f32."""
    _, gq_j, want = _jax_int8()
    data, shape = _bytes()
    x = image(shape)
    model = stt.compile(stt.import_model(data), quant="int8-pixel",
                        calibration_data=[(x,)], device="cpu")
    assert [n.op_type for n in model.graph.nodes] == [n.op_type for n in gq_j.nodes]
    got = model(x)[0]
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-3 * scale
    f32 = np.asarray(_jax_outputs("float32"), np.float32)
    assert np.abs(got - f32).max() >= 1e-2 * scale  # the bound is below int8's error
    assert pc.q_launches == 0


def test_int8_pixel_needs_calibration_data_and_serve_takes_a_quantized_graph():
    data, shape = _bytes()
    with pytest.raises(ValueError, match="calibration_data"):
        stt.compile(stt.import_model(data), quant="int8-pixel", device="cpu")
    with pytest.raises(ValueError, match="calibration_data"):
        st.compile(st.import_model(data), quant="int8-pixel")
    x = image(shape)
    model = stt.compile(stt.import_model(data), quant="int8-pixel", calibration_data=[(x,)],
                        device="cpu")
    assert model.graph.metadata["quant"] == "int8-pixel"
    server = stt.serve(model.graph, quant="int8-pixel", optimize=False, device="cpu",
                       max_batch=1, buckets=(1,))
    try:
        assert server.wait_ready(120)
        got = server.infer(x[0])[0]
    finally:
        server.shutdown()
    assert np.array_equal(got, model(x)[0][0])
