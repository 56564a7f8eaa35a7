"""The int8-static slice of smelter_tpu_torch against smelter_tpu.

`quantize_static` node for node and initializer for initializer on the JAX
package's amax; QLinearConv (both layouts, kernels 1, 3 and 7, strides 1
and 2, pads, with and without a bias, a crafted fused-multiply-add case),
QLinearMatMul, and the int8 Relu and MaxPool one node at a time against the
JAX lowerings, int8 outputs bit-equal; the forms the port does not take;
and a small ResNet through both packages' `compile(quant="int8-static")`
and `serve`: calibration, every int8 edge, the logits.

The JAX side runs jitted, as its `CompiledModel` runs: XLA on the CPU then
contracts QLinearConv's `acc * m + b` into one fused multiply-add, which the
port's kernel and plain version compute too (run eagerly, op by op, the JAX
lowering would round the product first). The port takes its kernels' plain
versions on the CPU.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smelter_tpu as st
import smelter_tpu_torch as stt
import smelter_tpu_torch.quant as stt_quant
from smelter_tpu.ir.build import GraphBuilder as JGraphBuilder
from smelter_tpu.passes.pass_manager import run_passes as jax_run_passes
from smelter_tpu.quant import calibrate as jax_calibrate
from smelter_tpu.quant import quantize_static as jax_quantize_static
from smelter_tpu.runtime.executor import Executor as JExecutor
from smelter_tpu_torch.api import _prepare as torch_prepare
from smelter_tpu_torch.ir.build import GraphBuilder
from smelter_tpu_torch.ir.errors import NotSupportedError
from smelter_tpu_torch.kernels import qlinear_conv as qc
from smelter_tpu_torch.passes.pass_manager import run_passes
from smelter_tpu_torch.quant import calibrate, quantize_static
from smelter_tpu_torch.runtime.executor import Executor
from smelter_tpu_torch.utils import dtypes as dt
from torch_port_common import assert_graphs_equal, image, small_resnet_bytes

INT8 = dt.numpy_to_onnx_dtype(np.dtype(np.int8))


def _run_both(build, inputs: dict, **config):
    """The graph that build(GraphBuilder) makes, through the port's executor
    on the CPU and the JAX package's jitted. Returns (port, JAX) outputs as
    numpy arrays."""
    res = []
    for GB, Ex, cfg in ((GraphBuilder, Executor, stt.Config(device="cpu", **config)),
                        (JGraphBuilder, JExecutor, st.Config(**config))):
        b = GB("q", opset=17)
        for n, a in inputs.items():
            b.input(n, a.shape, dt.numpy_to_onnx_dtype(a.dtype))
        g = b.finish(build(b))
        ex = Ex(g, cfg)
        if Ex is Executor:
            out = ex.build_fn()(ex.cast_params(ex.init_params()),
                                *[torch.from_numpy(a.copy()) for a in inputs.values()])
        else:
            out = jax.jit(ex.build_fn())(ex.init_params(),
                                         *[jnp.asarray(a) for a in inputs.values()])
        res.append([np.asarray(o.float() if o.dtype == torch.bfloat16 else o)
                    if isinstance(o, torch.Tensor) else np.asarray(o) for o in out])
    return res


def _qconv_node(b, x: str, w, w_s, bias=None, x_s=0.02, y_s=0.05, **attrs):
    """QLinearConv on int8 edge x with int8 weight w and scales as inits."""
    ins = [x, b.init(np.float32(x_s)), b.init(np.int8(0)), b.init(w),
           b.init(np.asarray(w_s, np.float32)),
           b.init(np.zeros(np.asarray(w_s).size, np.int8)),
           b.init(np.float32(y_s)), b.init(np.int8(0))]
    if bias is not None:
        ins.append(b.init(np.asarray(bias, np.int32)))
    return b.node("QLinearConv", ins, **attrs)


# -- quantize_static -----------------------------------------------------------------

def _conv_chain(b, rng, layers: int, residual: bool):
    x = b.input("x", (2, 8, 16, 16))
    h, cin = x, 8
    for _ in range(layers):
        h = b.conv(h, rng.standard_normal((16, cin, 3, 3)).astype(np.float32) * 0.1,
                   rng.standard_normal(16).astype(np.float32) * 0.1, pads=(1, 1, 1, 1))
        h = b.node("Relu", [h])
        cin = 16
    if residual:  # the carry edge forks to a conv and the Add
        c = b.conv(h, rng.standard_normal((16, 16, 3, 3)).astype(np.float32) * 0.1,
                   pads=(1, 1, 1, 1))
        h = b.node("Relu", [b.node("Add", [c, h])])
    return [h]


def _gemm_head(b, rng, trans_b: int):
    x = b.input("x", (4, 64))
    h = b.node("Relu", [x])
    w = rng.standard_normal((32, 64) if trans_b else (64, 32)).astype(np.float32) * 0.1
    h = b.gemm(h, w, rng.standard_normal(32).astype(np.float32), trans_b=trans_b)
    h = b.node("MatMul", [b.node("Relu", [h]),
                          b.init(rng.standard_normal((32, 40)).astype(np.float32))])
    return [h]


GRAPHS = {
    "one_conv": (lambda b, rng: _conv_chain(b, rng, 1, False), dict(min_elements=1), 1),
    "chained_convs": (lambda b, rng: _conv_chain(b, rng, 3, False), dict(min_elements=1), 3),
    "min_elements": (lambda b, rng: _conv_chain(b, rng, 3, False), dict(min_elements=2000), 2),
    "carry_on": (lambda b, rng: _conv_chain(b, rng, 1, True), dict(min_elements=1), 2),
    "carry_off": (lambda b, rng: _conv_chain(b, rng, 1, True),
                  dict(min_elements=1, int8_carry=False), 2),
    "gemm_transB": (lambda b, rng: _gemm_head(b, rng, 1), dict(min_elements=1), 2),
    "gemm": (lambda b, rng: _gemm_head(b, rng, 0), dict(min_elements=1), 2),
}


@pytest.mark.parametrize("case", sorted(GRAPHS))
def test_quantize_static_matches_jax(case):
    """Fed the same amax (the JAX package's), the port's rewrite gives the
    JAX graph node for node, int8 weights, scales and int32 biases
    bit-equal, and quantizes as many nodes."""
    build, kw, n_quantized = GRAPHS[case]
    b = JGraphBuilder("sq", opset=13)
    gj = b.finish(build(b, np.random.default_rng(0)))
    data = st.export_model(gj)
    x = image(tuple(gj.inputs[0].type.shape), seed=1)
    gj, gt = st.import_model(data), stt.import_model(data)
    amax = jax_calibrate(gj, [(x,)])
    assert jax_quantize_static(gj, amax, **kw) == quantize_static(gt, amax, **kw) == n_quantized
    assert_graphs_equal(gj, gt)
    ops = [n.op_type for n in gt.nodes]
    if case == "carry_on":
        assert any("_c8" in i for n in gt.nodes if n.op_type == "Add" for i in n.inputs)
    if case == "carry_off":
        assert not any("_c8" in i for n in gt.nodes for i in n.inputs)
    if case.startswith("gemm"):
        assert ops.count("QLinearMatMul") == 2


def test_quantize_static_small_resnet_matches_jax():
    """The small ResNet after the default passes, on a percentile amax."""
    data, shape = small_resnet_bytes()
    gj, gt = st.import_model(data), stt.import_model(data)
    jax_run_passes(gj)
    run_passes(gt)
    amax = jax_calibrate(gj, [(image(shape),)], percentile=99.9)
    n = jax_quantize_static(gj, amax)
    assert n >= 15 and quantize_static(gt, amax) == n
    assert_graphs_equal(gj, gt)


# -- QLinearConv, QLinearMatMul, int8 Relu and MaxPool one node at a time ---------------

def _conv_operands(rng, n, cin, h, w, cout, k, layout):
    x = rng.integers(-128, 128, (n, cin, h, w), dtype=np.int8)
    wq = rng.integers(-127, 128, (cout, cin, k, k), dtype=np.int8)
    if layout == "NHWC":
        return x.transpose(0, 2, 3, 1).copy(), wq.transpose(2, 3, 1, 0).copy()
    return x, wq


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("k,stride,pads,cin,bias", [
    (1, 1, (0, 0, 0, 0), 32, True),     # the bottleneck's 1x1
    (1, 2, (0, 0, 0, 0), 32, True),     # the downsample
    (3, 1, (1, 1, 1, 1), 16, True),     # 3x3 / s1
    (3, 2, (1, 1, 1, 1), 16, False),    # 3x3 / s2 (v1.5), no bias
    (7, 2, (3, 3, 3, 3), 3, True),      # the stem: C_in 3
    (3, 1, (0, 2, 1, 0), 5, True),      # uneven pads
])
def test_qlinear_conv_matches_jax(layout, k, stride, pads, cin, bias):
    rng = np.random.default_rng(k * 10 + stride)
    cout = 24
    x, wq = _conv_operands(rng, 2, cin, 11, 13, cout, k, layout)
    w_s = rng.uniform(2e-3, 2e-2, cout)
    b_q = rng.integers(-3000, 3000, cout) if bias else None
    attrs = dict(strides=[stride, stride], pads=list(pads), kernel_shape=[k, k],
                 dilations=[1, 1], group=1)
    if layout == "NHWC":
        attrs["data_layout"] = "NHWC"
    got, want = _run_both(lambda b: [_qconv_node(b, "x", wq, w_s, b_q, **attrs)], {"x": x})
    assert got[0].dtype == want[0].dtype == np.int8
    assert got[0].shape == want[0].shape
    assert np.array_equal(got[0], want[0])
    assert len(np.unique(got[0])) > 50  # the outputs span the grid, not a clip


def test_qlinear_conv_per_tensor_weight_scale_matches_jax():
    rng = np.random.default_rng(3)
    x, wq = _conv_operands(rng, 1, 16, 9, 9, 8, 3, "NCHW")
    attrs = dict(pads=[1, 1, 1, 1], kernel_shape=[3, 3])
    got, want = _run_both(lambda b: [_qconv_node(b, "x", wq, [0.01], np.arange(8) * 50, **attrs)],
                          {"x": x})
    assert np.array_equal(got[0], want[0])


# acc, m (= w_s with x_s = y_s = 1) and b_q where round(f32(acc) * m + b) as
# one fused multiply-add and as a product then a sum land on either side of
# a half-way point (found by a search over random m and b_q).
FMA_CASES = [(-27653, 3.0384628772735596, 27640), (-27601, 3.0384628772735596, 27640),
             (-28482, 3.3037209510803223, 28454), (-22608, 3.7256858348846436, 22639)]


def test_qlinear_conv_epilogue_is_one_fused_multiply_add():
    """The compiled JAX lowering rounds f32(acc) * m + b once (XLA on the CPU
    contracts it into an FMA); so do the port's plain version and kernel.
    Each crafted row differs between the two forms."""
    cin = 256
    x = np.zeros((len(FMA_CASES), cin, 1, 1), np.int8)
    for r, (acc, _, _) in enumerate(FMA_CASES):  # spread acc over the channels
        rem = acc
        for i in range(cin):
            x[r, i] = v = max(-127, min(127, rem))
            rem -= v
        assert rem == 0
    ws = np.array([m for _, m, _ in FMA_CASES], np.float32)
    bq = np.array([b for _, _, b in FMA_CASES], np.int32)
    wq = np.ones((len(FMA_CASES), cin, 1, 1), np.int8)
    got, want = _run_both(lambda b: [_qconv_node(b, "x", wq, ws, bq, x_s=1.0, y_s=1.0,
                                                 kernel_shape=[1, 1])], {"x": x})
    diag = np.diagonal(want[0][:, :, 0, 0])
    acc = np.array([a for a, _, _ in FMA_CASES], np.float32)
    b32 = (bq.astype(np.float64) * ws.astype(np.float64)).astype(np.float32)
    fused = np.round((acc.astype(np.float64) * ws + b32).astype(np.float32))
    separate = np.round((acc * ws).astype(np.float32) + b32)
    assert np.all(fused != separate)
    assert np.array_equal(diag, fused)
    assert np.array_equal(got[0], want[0])


@pytest.mark.parametrize("a_shape,per_column", [((4, 64), True), ((2, 3, 64), True),
                                                ((5, 64), False)])
def test_qlinear_matmul_matches_jax(a_shape, per_column):
    rng = np.random.default_rng(5)
    a = rng.integers(-128, 128, a_shape, dtype=np.int8)
    wq = rng.integers(-127, 128, (64, 40), dtype=np.int8)
    b_s = rng.uniform(1e-3, 1e-2, 40 if per_column else 1).astype(np.float32)

    def build(b):
        ins = ["a", b.init(np.float32(0.03)), b.init(np.int8(0)), b.init(wq), b.init(b_s),
               b.init(np.zeros(b_s.size, np.int8)), b.init(np.float32(0.2)), b.init(np.int8(0))]
        return [b.node("QLinearMatMul", ins)]

    got, want = _run_both(build, {"a": a})
    assert got[0].dtype == np.int8 and got[0].shape == a_shape[:-1] + (40,)
    assert np.array_equal(got[0], want[0])


@pytest.mark.parametrize("op,attrs", [
    ("Relu", {}),
    ("MaxPool", {"kernel_shape": [3, 3], "strides": [2, 2], "pads": [1, 1, 1, 1]}),
    ("MaxPool", {"kernel_shape": [3, 3], "strides": [2, 2], "pads": [1, 1, 1, 1],
                 "data_layout": "NHWC"}),
    ("MaxPool", {"kernel_shape": [2, 2], "strides": [2, 2], "ceil_mode": 1}),
])
def test_int8_twins_match_jax(op, attrs):
    """Relu and MaxPool run on int8 edges as they are (quant-transparent);
    every value negative, so the pool's padding (int8's lowest) must never
    win a border window."""
    x = np.random.default_rng(6).integers(-128, 0, (2, 4, 9, 9), dtype=np.int8)
    if attrs.get("data_layout") == "NHWC":
        x = x.transpose(0, 2, 3, 1).copy()
    got, want = _run_both(lambda b: [b.node(op, ["x"], **attrs)], {"x": x})
    assert got[0].dtype == np.int8 and np.array_equal(got[0], want[0])


def _form(case: str):
    """A QLinearConv or QLinearMatMul graph of a form the port does not take."""
    b = GraphBuilder("q", opset=17)
    x = b.input("x", (1, 8, 6, 6), INT8)
    wq = np.ones((8, 8, 3, 3), np.int8)
    if case == "asymmetric":
        ins = [x, b.init(np.float32(0.1)), b.init(np.int8(3)), b.init(wq),
               b.init(np.ones(8, np.float32)), b.init(np.zeros(8, np.int8)),
               b.init(np.float32(0.1)), b.init(np.int8(0))]
        y = b.node("QLinearConv", ins, kernel_shape=[3, 3])
    elif case == "traced_scale":
        s = b.input("s", (), dt.FLOAT)
        ins = [x, s, b.init(np.int8(0)), b.init(wq), b.init(np.ones(8, np.float32)),
               b.init(np.zeros(8, np.int8)), b.init(np.float32(0.1)), b.init(np.int8(0))]
        y = b.node("QLinearConv", ins, kernel_shape=[3, 3])
    elif case == "uint8":
        ins = [x, b.init(np.float32(0.1)), b.init(np.int8(0)), b.init(wq),
               b.init(np.ones(8, np.float32)), b.init(np.zeros(8, np.int8)),
               b.init(np.float32(0.1)), b.init(np.uint8(0))]
        y = b.node("QLinearConv", ins, kernel_shape=[3, 3])
    elif case == "matmul_asymmetric":
        x = b.input("a", (4, 16), INT8)
        ins = [x, b.init(np.float32(0.1)), b.init(np.int8(0)), b.init(np.ones((16, 8), np.int8)),
               b.init(np.ones(8, np.float32)), b.init(np.ones(8, np.int8)),
               b.init(np.float32(0.1)), b.init(np.int8(0))]
        y = b.node("QLinearMatMul", ins)
    else:
        attrs = {"group": dict(group=2), "dilation": dict(dilations=[2, 2])}[case]
        w = np.ones((8, 4, 3, 3) if case == "group" else (8, 8, 3, 3), np.int8)
        y = _qconv_node(b, x, w, np.ones(8), kernel_shape=[3, 3], **attrs)
    return b.finish([y])


@pytest.mark.parametrize("case", ["asymmetric", "traced_scale", "uint8", "group", "dilation",
                                  "matmul_asymmetric"])
def test_untaken_forms_raise(case):
    """The forms quantize_static never emits raise on every device (the card
    tests check CUDA tensors; here the CPU and `meta`, shape inference's)."""
    g = _form(case)
    with pytest.raises(NotSupportedError):
        Executor(g, stt.Config(device="cpu")).infer_value_types()
    ex = Executor(g, stt.Config(device="cpu"))
    ins = [torch.zeros(tuple(v.type.shape), dtype=dt.onnx_to_torch_dtype(v.type.dtype))
           for v in g.inputs]
    with pytest.raises(NotSupportedError):
        ex.build_fn()(ex.init_params(), *ins)


def test_folded_constants_are_made_once_per_forward_function(monkeypatch):
    """m and b are folded and put on the device at a forward function's first
    call, not on every call; QuantizeLinear's reciprocal likewise."""
    from smelter_tpu_torch.ops import quant_ops

    calls = []
    fold = quant_ops._fold
    monkeypatch.setattr(quant_ops, "_fold", lambda *a: calls.append(1) or fold(*a))
    data, shape = small_resnet_bytes()
    model = stt.compile(stt.import_model(data), quant="int8-static",
                        calibration_data=[(image(shape),)], device="cpu")
    n_conv = sum(n.op_type in ("QLinearConv", "QLinearMatMul") for n in model.graph.nodes)
    calls.clear()
    model(image(shape))
    assert len(calls) == n_conv
    model(image(shape, seed=1))
    assert len(calls) == n_conv


def test_qlinear_conv_weights_are_stored_ohwi():
    """params_from_numpy lays each QLinearConv weight out once as OHWI (an
    OIHW view over it: channels-last), the layout the kernel reads."""
    data, shape = small_resnet_bytes()
    model = stt.compile(stt.import_model(data), quant="int8-static",
                        calibration_data=[(image(shape),)], device="cpu")
    names = [n.inputs[3] for n in model.graph.nodes if n.op_type == "QLinearConv"]
    assert len(names) >= 10
    for name in names:
        w = model.params[name]
        assert w.dtype == torch.int8 and w.is_contiguous(memory_format=torch.channels_last)
        assert np.array_equal(w.numpy(), model.graph.initializers[name])


# -- the small ResNet through compile and serve ----------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_int8_static():
    """The JAX package's amax on two calibration batches, its int8-static
    graph (the default nhwc layout) and that graph's every edge, jitted."""
    data, shape = small_resnet_bytes()
    calib = [(image(shape, seed=s),) for s in (0, 1)]
    g = st.import_model(data)
    jax_run_passes(g)
    amax = jax_calibrate(g, calib)
    model = st.compile(st.import_model(data), quant="int8-static", calibration_data=calib)
    ex = JExecutor(model.graph)
    env = jax.jit(ex.build_fn(return_all_edges=True))(ex.init_params(), jnp.asarray(image(shape)))
    return amax, model.graph, {k: np.asarray(v) for k, v in env.items()}


def test_calibrate_matches_jax():
    amax_j, _, _ = _jax_int8_static()
    data, shape = small_resnet_bytes()
    g = stt.import_model(data)
    run_passes(g)
    amax = calibrate(g, [(image(shape, seed=s),) for s in (0, 1)], stt.Config(device="cpu"))
    assert set(amax) == set(amax_j) and len(amax) > 30
    for k, v in amax_j.items():
        assert abs(amax[k] - v) <= 1e-6 * v, (k, amax[k], v)


def test_int8_static_graph_and_edges_match_jax(monkeypatch):
    """On the JAX amax, `_prepare` gives the JAX int8-static graph node for
    node, and every int8 edge of a forward equals the JAX package's,
    element for element: the int8 convs sum exactly, the epilogues round
    the same fused multiply-add, and the float ops between them (dequant,
    Add, Relu, quant) are elementwise in f32. Only the head's input, after
    the global pool (a mean over the map, summed in another order), could
    move a step at a half-way point: none does here. The logits are within
    1e-5 of the largest (the pool's order and the head's bias add)."""
    amax, gj, env_j = _jax_int8_static()
    data, shape = small_resnet_bytes()
    monkeypatch.setattr(stt_quant, "calibrate", lambda *a, **k: amax)
    gt = torch_prepare(stt.import_model(data), "int8-static", True, "nhwc", [None], "cpu")
    assert_graphs_equal(gj, gt)
    ops = [n.op_type for n in gt.nodes]
    assert ops.count("QLinearConv") >= 15 and ops.count("QLinearMatMul") == 1
    ex = Executor(gt, stt.Config(device="cpu"))
    env = ex.build_fn(return_all_edges=True)(ex.cast_params(ex.init_params()),
                                             torch.from_numpy(image(shape)))
    int8 = {k: v.numpy() for k, v in env.items()
            if isinstance(v, torch.Tensor) and v.dtype == torch.int8 and k not in gt.initializers}
    assert len(int8) >= 30
    for k, v in int8.items():
        assert env_j[k].dtype == np.int8 and np.array_equal(v, env_j[k]), k
    out = gt.output_names[0]
    got, want = env[out].numpy(), env_j[out]
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_int8_static_compile_and_serve_match_jax():
    """compile(quant="int8-static") calibrated on the CPU against the JAX
    package's: calibrations 1e-7 apart give the same scales but where an
    f32 division lands a value across a half-way point, so the logits are
    held to 1e-3 of the largest, 10x below int8-static's own error against
    the f32 model. `serve` answers on the quantized graph as compile does."""
    _, gj, env_j = _jax_int8_static()
    data, shape = small_resnet_bytes()
    calib = [(image(shape, seed=s),) for s in (0, 1)]
    model = stt.compile(stt.import_model(data), quant="int8-static", calibration_data=calib,
                        device="cpu")
    assert model.graph.metadata["quant"] == "int8-static"
    assert [n.op_type for n in model.graph.nodes] == [n.op_type for n in gj.nodes]
    x = image(shape)
    got = model(x)[0]
    want = env_j[gj.output_names[0]]
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-3 * scale
    f32 = stt.compile(stt.import_model(data), device="cpu")(x)[0]
    assert np.abs(got - f32).max() >= 1e-2 * scale  # the bound is below int8's error
    assert qc.launches == 0
    server = stt.serve(model.graph, quant="int8-static", optimize=False, device="cpu",
                       max_batch=2, buckets=(1, 2))
    results = [None] * shape[0]
    try:
        assert server.wait_ready(120)

        def ask(i):
            results[i] = server.infer(x[i])[0]

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(shape[0])]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        server.shutdown()
    assert np.array_equal(np.stack(results), got)


def test_int8_static_needs_calibration_data():
    data, _ = small_resnet_bytes()
    with pytest.raises(ValueError, match="calibration_data"):
        stt.compile(stt.import_model(data), quant="int8-static", device="cpu")
    with pytest.raises(ValueError, match="calibration_data"):
        stt.serve(stt.import_model(data), quant="int8-static", device="cpu")
    with pytest.raises(ValueError, match="calibration_data"):
        st.compile(st.import_model(data), quant="int8-static")
