"""The int8-static walk's groups against the JAX package.

`int8_join_plain`, the residual join kernel's arithmetic, bit-equal to the
JAX package's DequantizeLinear, DequantizeLinear -> Add -> Relu [->
QuantizeLinear] lowerings, op by op and jitted, on crafted int8 inputs
(ties after scaling, saturation, the f32-out form); DequantizeLinear with
and without a zero point; the walk's plan (`runtime/chains.py`) on the
full-depth ResNet-50 int8-static graph (16 joins, 33 conv + Relu) and the
small one, and what it leaves alone; and the fused walk of the small
ResNet on the CPU against the JAX package's jitted edges and the port's
node-by-node walk. The port takes its kernels' plain versions on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smelter_tpu as st
import smelter_tpu_torch as stt
from smelter_tpu.ir.build import GraphBuilder as JGraphBuilder
from smelter_tpu.runtime.executor import Executor as JExecutor
from smelter_tpu_torch.ir.build import GraphBuilder
from smelter_tpu_torch.kernels import int8_join as ij
from smelter_tpu_torch.kernels import qlinear_conv as qc
from smelter_tpu_torch.models import resnet50
from smelter_tpu_torch.runtime import chains
from smelter_tpu_torch.runtime.executor import Executor
from smelter_tpu_torch.utils import dtypes as dt
from torch_port_common import _one_op, image, small_resnet_bytes

INT8 = dt.numpy_to_onnx_dtype(np.dtype(np.int8))


def _join_graph(GB, shape, s_a, s_b, s_y, *, zero_points=True, extra=None):
    """DequantizeLinear(a), DequantizeLinear(b) -> Add -> Relu [->
    QuantizeLinear (s_y not None)]; `extra` adds a second reader of an
    inner edge ("add": a graph output of the Add; "relu2": a second Relu
    of the Add)."""
    b = GB("join", opset=17)
    b.input("a", shape, INT8)
    b.input("b", shape, INT8)

    def dq(x, s):
        ins = [x, b.init(np.float32(s))] + ([b.init(np.int8(0))] if zero_points else [])
        return b.node("DequantizeLinear", ins)

    add = b.node("Add", [dq("a", s_a), dq("b", s_b)])
    relu = b.node("Relu", [add])
    outs = [relu]
    if s_y is not None:
        outs = [b.node("QuantizeLinear", [relu, b.init(np.float32(s_y)), b.init(np.int8(0))])]
    if extra == "add":
        outs.append(add)
    elif extra == "relu2":
        outs.append(b.node("Relu", [add]))
    return b.finish(outs)


def _jax_outputs(g, a, b, jit: bool):
    ex = JExecutor(g)
    fn = ex.build_fn()
    if jit:
        fn = jax.jit(fn)
    return [np.asarray(o) for o in fn(ex.init_params(), jnp.asarray(a), jnp.asarray(b))]


def _crafted(case: str):
    """(a, b, s_a, s_b, s_y): int8 inputs and scales of one crafted case."""
    rng = np.random.default_rng({"ties": 0, "saturate": 1, "random": 2, "extremes": 3}[case])
    shape = (2, 16, 7, 9)
    a = rng.integers(-128, 128, shape, dtype=np.int8)
    b = rng.integers(-128, 128, shape, dtype=np.int8)
    if case == "ties":  # r / s_y = (a + b) / 2 exactly: every odd sum lands on .5
        return a, b, 0.25, 0.25, 0.5
    if case == "saturate":  # r / s_y up to 2 x 255: most positive sums clip at 127
        return a, b, 1.0, 1.0, 1.0 / 2
    if case == "extremes":  # every pairing of -128, -127, 0, 126, 127
        vals = np.array([-128, -127, 0, 126, 127], np.int8)
        a = np.repeat(vals, 5).reshape(1, 1, 5, 5)
        b = np.tile(vals, 5).reshape(1, 1, 5, 5)
        return a, b, 0.0473, 0.0391, 0.0788
    s = rng.uniform(0.005, 0.08, 3).astype(np.float32)
    return a, b, float(s[0]), float(s[1]), float(s[2])


@pytest.mark.parametrize("case", ["ties", "saturate", "random", "extremes"])
@pytest.mark.parametrize("out", ["int8", "f32"])
@pytest.mark.parametrize("jit", [False, True])
def test_int8_join_plain_matches_jax(case, out, jit):
    """The plain version is bit-equal to the JAX lowerings: ties round half
    to even, sums past the grid clip at 127, negative sums give 0, and the
    f32 form is the Relu's edge."""
    a, b, s_a, s_b, s_y = _crafted(case)
    s_y = s_y if out == "int8" else None
    want = _jax_outputs(_join_graph(JGraphBuilder, a.shape, s_a, s_b, s_y), a, b, jit)[0]
    inv_y = None if s_y is None else float(np.float32(np.reciprocal(np.float64(np.float32(s_y)))))
    got = ij.int8_join_plain(torch.from_numpy(a), torch.from_numpy(b), np.float32(s_a),
                             np.float32(s_b), inv_y).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if case == "ties" and out == "int8":
        r = (a.astype(np.int32) + b) / 2
        assert ((r % 1 == 0.5) & (r > 0)).sum() > 100  # the ties are there
        assert np.array_equal(got, np.clip(np.round(np.maximum(r, 0)), -128, 127))
    if case == "saturate" and out == "int8":
        assert (got == 127).sum() > 100


@pytest.mark.parametrize("case", ["ties", "random"])
@pytest.mark.parametrize("out", ["int8", "f32"])
def test_join_graph_walks_fused_as_jax(case, out):
    """The chain as a graph through the port's executor (one Join group,
    its end a graph output) equals the JAX executor's, and the group ran in
    place of the five nodes."""
    a, b, s_a, s_b, s_y = _crafted(case)
    s_y = s_y if out == "int8" else None
    gt = _join_graph(GraphBuilder, a.shape, s_a, s_b, s_y)
    assert [type(g).__name__ for g in chains.groups(gt)] == ["Join"]
    assert len(chains.plan(gt)) == 1
    ex = Executor(gt, stt.Config(device="cpu"))
    got = ex.build_fn()(ex.cast_params(ex.init_params()), torch.from_numpy(a),
                        torch.from_numpy(b))[0].numpy()
    want = _jax_outputs(_join_graph(JGraphBuilder, a.shape, s_a, s_b, s_y), a, b, True)[0]
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("extra", ["add", "relu2"])
def test_join_with_a_second_reader_is_not_grouped(extra):
    """An inner edge that is a graph output, or that a second node reads,
    leaves the chain to the node-by-node walk, whose outputs are the JAX
    package's."""
    a, b, s_a, s_b, s_y = _crafted("random")
    gt = _join_graph(GraphBuilder, a.shape, s_a, s_b, s_y, extra=extra)
    assert chains.groups(gt) == []
    assert chains.plan(gt) == list(gt.nodes)
    ex = Executor(gt, stt.Config(device="cpu"))
    got = ex.build_fn()(ex.cast_params(ex.init_params()), torch.from_numpy(a),
                        torch.from_numpy(b))
    want = _jax_outputs(_join_graph(JGraphBuilder, a.shape, s_a, s_b, s_y, extra=extra),
                        a, b, True)
    for g_, w_ in zip(got, want):
        assert np.array_equal(g_.numpy(), w_)


def test_join_without_zero_points_is_not_grouped():
    """DequantizeLinear without a zero point (its input's type not pinned
    to int8 by one) walks node by node."""
    a, b, s_a, s_b, s_y = _crafted("random")
    assert chains.groups(_join_graph(GraphBuilder, a.shape, s_a, s_b, s_y,
                                     zero_points=False)) == []


def _conv_relu_graph(extra=None):
    """x -> QuantizeLinear -> QLinearConv -> Relu (int8) -> DequantizeLinear;
    `extra`: "output" makes the conv's int8 edge a graph output, "reader"
    gives it a second reader."""
    rng = np.random.default_rng(5)
    b = GraphBuilder("cr", opset=17)
    b.input("x", (2, 8, 9, 9))
    q = b.node("QuantizeLinear", ["x", b.init(np.float32(0.02)), b.init(np.int8(0))])
    ins = [q, b.init(np.float32(0.02)), b.init(np.int8(0)),
           b.init(rng.integers(-127, 128, (16, 8, 3, 3), dtype=np.int8)),
           b.init(np.float32(0.01)), b.init(np.int8(0)), b.init(np.float32(0.05)),
           b.init(np.int8(0)), b.init(rng.integers(-300, 300, 16).astype(np.int32))]
    conv = b.node("QLinearConv", ins, kernel_shape=[3, 3], pads=[1, 1, 1, 1])
    relu = b.node("Relu", [conv])
    outs = [b.node("DequantizeLinear", [relu, b.init(np.float32(0.05)), b.init(np.int8(0))])]
    if extra == "output":
        outs.append(conv)
    elif extra == "reader":
        outs.append(b.node("MaxPool", [conv], kernel_shape=[2, 2], strides=[2, 2]))
    return b.finish(outs)


@pytest.mark.parametrize("extra", [None, "output", "reader"])
def test_conv_relu_group_and_its_edges(extra):
    """QLinearConv -> int8 Relu is one call where the conv's edge has one
    reader and is no graph output; either way the walk's outputs equal the
    node-by-node walk's."""
    g = _conv_relu_graph(extra)
    kinds = [type(grp).__name__ for grp in chains.groups(g)]
    assert kinds == (["ConvRelu"] if extra is None else [])
    x = torch.from_numpy(image((2, 8, 9, 9)))
    ex = Executor(g, stt.Config(device="cpu"))
    p = ex.cast_params(ex.init_params())
    fused = ex.build_fn()(p, x)
    edges = ex.build_fn(return_all_edges=True)(p, x)
    for name, got in zip(g.output_names, fused):
        assert torch.equal(got, edges[name]), name
    relu = next(n for n in g.nodes if n.op_type == "Relu")
    assert torch.equal(edges[relu.outputs[0]], torch.relu(edges[relu.inputs[0]]))


@pytest.mark.parametrize("zero_point", [None, "zeros", "nonzero"])
@pytest.mark.parametrize("shape,axis,scale", [((2, 6, 5, 5), 1, "tensor"),
                                               ((2, 6, 5, 5), 1, "channel"),
                                               ((7, 12), 0, "channel")])
def test_dequantize_linear_matches_jax(zero_point, shape, axis, scale):
    """DequantizeLinear skips y - zp * s for a static zero point of zeros
    (y - 0 is y): outputs bit-equal to the JAX lowering, which subtracts,
    with and without a zero point."""
    rng = np.random.default_rng(9)
    x = rng.integers(-128, 128, shape, dtype=np.int8)
    n = shape[axis]
    s = (np.float32(0.037) if scale == "tensor"
         else rng.uniform(0.001, 0.1, n).astype(np.float32))
    inits = {"s": s}
    if zero_point is not None:
        zshape = () if scale == "tensor" else (n,)
        inits["z"] = (np.zeros(zshape, np.int8) if zero_point == "zeros"
                      else rng.integers(-5, 6, zshape).astype(np.int8))
    got, want = _one_op("DequantizeLinear", {"x": x}, {"axis": axis}, inits)
    assert got[0].dtype == want[0].dtype == np.float32
    assert np.array_equal(got[0], want[0])


# -- the plan on ResNet-50 ---------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _full_resnet50_int8_static():
    """The port's full-depth ResNet-50 (its builder, batch 1, 64 px)
    quantized int8-static on the CPU."""
    g, _m, shape = resnet50.build(batch=1, image_size=64)
    return stt.compile(g, quant="int8-static", calibration_data=[(image(shape),)],
                       device="cpu").graph, shape


def _kinds(g) -> dict:
    out: dict = {}
    for grp in chains.groups(g):
        key = type(grp).__name__
        if isinstance(grp, chains.Join):
            key += "_int8" if grp.quant is not None else "_f32"
        out[key] = out.get(key, 0) + 1
    return out


def test_plan_groups_resnet50_int8_static():
    """The full-depth graph: 33 conv + Relu pairs (the stem and the first
    two convs of every bottleneck), 16 joins, 15 ending in a QuantizeLinear
    and the last in the f32 edge the pool reads; the head's bias Add is no
    join. The plan keeps every other node, in order."""
    gq, _ = _full_resnet50_int8_static()
    assert _kinds(gq) == {"ConvRelu": 33, "Join_int8": 15, "Join_f32": 1}
    grouped = [n for grp in chains.groups(gq) for n in grp.nodes]
    assert len(grouped) == len({id(n) for n in grouped}) == 33 * 2 + 15 * 5 + 4
    steps = chains.plan(gq)
    assert len(steps) == len(gq.nodes) - len(grouped) + 49
    rest = [s for s in steps if not isinstance(s, (chains.ConvRelu, chains.Join))]
    assert rest == [n for n in gq.nodes if id(n) not in {id(m) for m in grouped}]
    f32 = next(g for g in chains.groups(gq) if isinstance(g, chains.Join) and g.quant is None)
    assert [n.op_type for n in gq.consumers()[f32.relu.outputs[0]]] == ["Transpose"]


def test_plan_groups_the_small_resnet():
    """The small ResNet (one bottleneck a stage, width 16): 4 joins (3 int8,
    1 f32) and 7 conv + Relu pairs, one for each int8 Relu that reads a
    QLinearConv (two of the nine bottleneck convs that a Relu follows stay
    float under quantize_static's size floor)."""
    data, shape = small_resnet_bytes()
    model = stt.compile(stt.import_model(data), quant="int8-static",
                        calibration_data=[(image(shape),)], device="cpu")
    g = model.graph
    producers = g.producers()
    int8_relus = [n for n in g.nodes if n.op_type == "Relu"
                  and getattr(producers.get(n.inputs[0]), "op_type", "") == "QLinearConv"]
    assert len(int8_relus) == 7
    assert _kinds(g) == {"ConvRelu": 7, "Join_int8": 3, "Join_f32": 1}


def test_fused_walk_of_resnet50_matches_the_unfused_walk():
    """The full-depth graph on the CPU: the fused walk's logits and every
    edge it makes equal the node-by-node walk's; it makes no inner edge."""
    gq, shape = _full_resnet50_int8_static()
    ex = Executor(gq, stt.Config(device="cpu"))
    p = ex.cast_params(ex.init_params())
    x = torch.from_numpy(image(shape, seed=3))
    unfused = ex.build_fn(return_all_edges=True)(p, x)
    fused = ex.build_fn(return_all_edges=True, fuse=True)(p, x)
    inner = {o for grp in chains.groups(gq) for n in grp.nodes if n is not grp.last
             for o in n.outputs}
    assert len(inner) == 33 + 16 * 3 + 15
    assert set(fused) == set(unfused) - inner
    for k, v in fused.items():
        assert torch.equal(v, unfused[k]), k
    out = ex.build_fn()(p, x)[0]
    assert torch.equal(out, unfused[gq.output_names[0]])


@functools.lru_cache(maxsize=None)
def _jax_small_int8_static():
    """The JAX package's int8-static small ResNet and its every edge, jitted."""
    data, shape = small_resnet_bytes()
    calib = [(image(shape, seed=s),) for s in (0, 1)]
    model = st.compile(st.import_model(data), quant="int8-static", calibration_data=calib)
    ex = JExecutor(model.graph)
    env = jax.jit(ex.build_fn(return_all_edges=True))(ex.init_params(), jnp.asarray(image(shape)))
    return model.graph, {k: np.asarray(v) for k, v in env.items()}


def test_fused_walk_of_the_small_resnet_matches_jax():
    """The JAX package's int8-static graph through the port's fused walk on
    the CPU: the logits within 1e-5 of the largest (the pool's order, as
    the unfused walk's test) and every chain-end int8 edge equal to the JAX
    package's jitted edges and to the port's node-by-node walk."""
    gj, env_j = _jax_small_int8_static()
    _, shape = small_resnet_bytes()
    gt = stt.import_model(st.export_model(gj))
    ex = Executor(gt, stt.Config(device="cpu"))
    p = ex.cast_params(ex.init_params())
    x = torch.from_numpy(image(shape))
    fused = ex.build_fn(return_all_edges=True, fuse=True)(p, x)
    unfused = ex.build_fn(return_all_edges=True)(p, x)
    ends = [grp.last.outputs[0] for grp in chains.groups(gt)]
    assert len(ends) == 11
    for k in ends:
        assert torch.equal(fused[k], unfused[k]), k
        assert np.array_equal(fused[k].numpy(), env_j[k]), k
    int8 = [k for k, v in fused.items() if v.dtype == torch.int8 and k not in gt.initializers]
    assert len(int8) >= 20
    for k in int8:
        assert np.array_equal(fused[k].numpy(), env_j[k]), k
    out = gt.output_names[0]
    got, want = ex.build_fn()(p, x)[0].numpy(), env_j[out]
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert np.array_equal(got, unfused[out].numpy())
    assert qc.launches == 0 and ij.launches == 0  # the CPU ran the plain versions
