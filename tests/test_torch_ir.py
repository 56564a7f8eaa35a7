"""The port's ONNX wire codec and IR against the JAX package's protobuf path.

The same bytes go through `smelter_tpu.import_model` (google.protobuf) and
`smelter_tpu_torch.import_model` (the port's pure-Python wire reader); the
port's writer is read back with the generated `onnx_pb2`.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import smelter_tpu as st
import smelter_tpu_torch as stt
from smelter_tpu.proto import onnx_pb2
from smelter_tpu_torch.ir.errors import ImportError_, NotSupportedError, UnknownOpError
from smelter_tpu_torch.ir.tensor_codec import numpy_to_tensor, tensor_to_numpy
from smelter_tpu_torch.proto import onnx_wire
from torch_port_common import assert_graphs_equal, small_resnet_bytes, value_types


def test_import_matches_jax_node_for_node():
    data, _ = small_resnet_bytes()
    gj, gt = st.import_model(data), stt.import_model(data)
    assert_graphs_equal(gj, gt)
    assert gj.producer == gt.producer
    assert value_types(gj) == value_types(gt)


def test_export_parses_with_onnx_pb2_to_the_same_message():
    data, _ = small_resnet_bytes()
    ours = onnx_pb2.ModelProto()
    ours.ParseFromString(stt.export_model(stt.import_model(data)))
    theirs = onnx_pb2.ModelProto()
    theirs.ParseFromString(st.export_model(st.import_model(data)))
    assert ours == theirs


def test_round_trip():
    data, _ = small_resnet_bytes()
    g = stt.import_model(data)
    assert_graphs_equal(g, stt.import_model(stt.export_model(g)))


def test_wire_scalars_both_ways():
    # negative ints (ten-byte varints), floats, packed repeats, bytes, nesting
    a = onnx_pb2.AttributeProto(name="a", type=onnx_pb2.AttributeProto.INTS,
                                ints=[-1, 0, 2**40, -(2**62)])
    b = onnx_pb2.AttributeProto(name="b", type=onnx_pb2.AttributeProto.FLOAT, f=-0.375)
    c = onnx_pb2.AttributeProto(name="c", type=onnx_pb2.AttributeProto.STRINGS,
                                strings=[b"x", b"\xff"])
    node = onnx_pb2.NodeProto(op_type="Op", input=["i", ""], output=["o"],
                              attribute=[a, b, c])
    blob = node.SerializeToString()
    got = onnx_wire.NodeProto.FromString(blob)
    assert got.input == ["i", ""] and got.output == ["o"]
    assert got.attribute[0].ints == [-1, 0, 2**40, -(2**62)]
    assert got.attribute[1].f == -0.375
    assert got.attribute[2].strings == [b"x", b"\xff"]
    assert got.SerializeToString() == blob


def test_bf16_initializer_decodes_to_torch():
    w = np.array([[1.5, -2.25], [3.0, 1e-3]], np.float32).astype(ml_dtypes.bfloat16)
    tp = onnx_pb2.TensorProto(name="w", data_type=16, dims=[2, 2],
                              raw_data=w.tobytes())
    got = tensor_to_numpy(onnx_wire.TensorProto.FromString(tp.SerializeToString()))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
    assert got.view(torch.int16).numpy().tobytes() == w.tobytes()
    back = numpy_to_tensor(got, "w")
    assert back.raw_data == w.tobytes() and back.data_type == 16


def test_int4_payload_raises_not_supported():
    tp = onnx_wire.TensorProto(name="q", data_type=22, dims=[4], raw_data=b"\x12\x34")
    with pytest.raises(NotSupportedError, match="int4"):
        tensor_to_numpy(tp)


def test_bad_bytes_raise_import_error():
    with pytest.raises(ImportError_):
        stt.import_model(b"\x0a\xff\xff\xff")


def test_executor_rejects_ops_outside_the_slice():
    g = st.import_model(small_resnet_bytes()[0])
    gt = stt.import_model(st.export_model(g))
    gt.nodes[-1].op_type = "Softmax"
    with pytest.raises(UnknownOpError):
        stt.Executor(gt, stt.Config(device="cpu"))
