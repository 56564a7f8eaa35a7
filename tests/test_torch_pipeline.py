"""The port's passes and weight quantization against the JAX package.

After `_prepare` (default passes -> quantization -> NHWC layout ->
fuse_dequant_matmul -> dce) both packages must hold the same graph: the same
node list and bit-equal initializers, int8 weights and f32 scales included.
"""

import numpy as np
import pytest

import smelter_tpu as st
import smelter_tpu_torch as stt
from smelter_tpu.api import _prepare as jax_prepare
from smelter_tpu.quant.weight_quant import quantize_array as jax_quantize_array
from smelter_tpu_torch.api import _prepare as torch_prepare
from smelter_tpu_torch.ir.errors import NotSupportedError
from smelter_tpu_torch.quant.weight_quant import quantize_array
from torch_port_common import assert_graphs_equal, small_resnet_bytes


@pytest.mark.parametrize("quant,layout", [("int8", "nhwc"), ("int8", "nchw"),
                                          (None, "nhwc"), ("fp16", "nhwc")])
def test_prepared_graphs_match(quant, layout):
    data, _ = small_resnet_bytes()
    gj = jax_prepare(st.import_model(data), quant, True, layout)
    gt = torch_prepare(stt.import_model(data), quant, True, layout)
    assert_graphs_equal(gj, gt)


def test_int8_nhwc_graph_has_the_fused_head_and_packed_conv():
    data, _ = small_resnet_bytes()
    g = torch_prepare(stt.import_model(data), "int8", True, "nhwc")
    ops = [n.op_type for n in g.nodes]
    assert ops.count("FusedDequantMatMul") == 1
    assert "Gemm" not in ops and "BatchNormalization" not in ops
    # At width 16, pack_conv_output turns a stride-2 3x3 conv into a 4x4/s2
    # conv with 4x the output channels plus DepthToSpace (not at width 64).
    d2s = [n for n in g.nodes if n.op_type == "DepthToSpace"]
    assert len(d2s) == 1 and d2s[0].attr("data_layout") == "NHWC"
    packed = [n for n in g.nodes if n.op_type == "Conv"
              and list(n.attr("kernel_shape")) == [4, 4]]
    assert len(packed) == 1 and list(packed[0].attr("strides")) == [2, 2]
    fdq = g.nodes[ops.index("FusedDequantMatMul")]
    assert g.initializers[fdq.inputs[1]].dtype == np.int8
    assert g.initializers[fdq.inputs[2]].dtype == np.float32


def _halfway_weight(rows: int, inner: int, seed: int) -> np.ndarray:
    """Rows whose entries sit at or next to x.5 steps of their scale, where
    round(w / s) and nearbyint(w * (1/s)) can part."""
    rng = np.random.default_rng(seed)
    amax = rng.uniform(0.5, 3.0, (rows, 1)).astype(np.float32)
    s = (amax / 127.0).astype(np.float32)
    k = rng.integers(-126, 126, (rows, inner)).astype(np.float32) + np.float32(0.5)
    w = (k * s).astype(np.float32)
    w[:, 0] = amax[:, 0]  # pin each row's absmax, hence its scale
    return w


@pytest.mark.parametrize("shape,axis", [
    ((256, 128, 3, 3), 0),   # >= 65,536 elements on axis 0: reciprocal form
    ((64, 64, 3, 3), 0),     # below the threshold: division form
    ((512, 1000), 1),        # a Gemm/MatMul weight's column axis
])
def test_quantize_array_bit_equal_to_jax(shape, axis):
    w = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    q, s = quantize_array(w, axis)
    qj, sj = jax_quantize_array(w, axis)
    assert q.dtype == qj.dtype == np.int8 and s.dtype == sj.dtype == np.float32
    assert np.array_equal(q, qj) and s.tobytes() == sj.tobytes()


def test_quantize_array_halfway_points_bit_equal_to_jax():
    w = _halfway_weight(512, 256, seed=7).reshape(512, 16, 4, 4)
    flat = w.reshape(512, -1)
    s = (np.abs(flat).max(axis=1, keepdims=True) / 127.0).astype(np.float32)
    by_div = np.round(flat / s)
    by_recip = np.rint(flat * (np.float32(1.0) / s).astype(np.float32))
    assert (by_div != by_recip).any(), "the data must part the two formulas"
    q, sc = quantize_array(w, 0)
    qj, scj = jax_quantize_array(w, 0)
    assert np.array_equal(q, qj) and sc.tobytes() == scj.tobytes()


def test_unported_quant_modes_raise():
    data, _ = small_resnet_bytes()
    for mode in ("int4", "int8-g128", "fp8"):
        with pytest.raises(NotSupportedError):
            torch_prepare(stt.import_model(data), mode, True, "nhwc")
    with pytest.raises(NotSupportedError):
        torch_prepare(stt.import_model(data), "int8-static", True, "nhwc")
