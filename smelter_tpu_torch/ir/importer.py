"""ONNX protobuf -> typed IR importer (and IR -> protobuf exporter).

The port's counterpart of `smelter_tpu/ir/importer.py`, over the pure-Python
wire format of `proto/onnx_wire.py` instead of `google.protobuf`. The IR and
the conventions are the same: the producer tag marks graphs the offline
preprocessor already optimized, and real ONNX files parse.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from ..proto import onnx_wire as onnx
from .errors import ImportError_
from .graph import Graph, Node, TensorType, ValueInfo
from .tensor_codec import numpy_to_tensor, tensor_to_numpy

# Producer tag written by the offline preprocessor; the runtime detects it
# the way the reference detects producerName == "ONNX2MPS".
PREPROCESSED_PRODUCER = "smelter-tpu"

AttrT = onnx.AttributeProto


def _decode_attr(a: onnx.AttributeProto) -> Any:
    t = a.type
    if t == AttrT.FLOAT:
        return float(a.f)
    if t == AttrT.INT:
        return int(a.i)
    if t == AttrT.STRING:
        try:
            return a.s.decode("utf-8")
        except UnicodeDecodeError:
            return bytes(a.s)
    if t == AttrT.TENSOR:
        return tensor_to_numpy(a.t)
    if t == AttrT.GRAPH:
        return _graph_from_proto(a.g, opset=0)
    if t == AttrT.FLOATS:
        return [float(x) for x in a.floats]
    if t == AttrT.INTS:
        return [int(x) for x in a.ints]
    if t == AttrT.STRINGS:
        return [s.decode("utf-8", "replace") for s in a.strings]
    if t == AttrT.TENSORS:
        return [tensor_to_numpy(x) for x in a.tensors]
    raise ImportError_(f"attribute {a.name!r}: unsupported attr type {t}")


def _encode_attr(name: str, v: Any) -> onnx.AttributeProto:
    a = onnx.AttributeProto(name=name)
    if isinstance(v, bool):
        a.type, a.i = AttrT.INT, int(v)
    elif isinstance(v, int):
        a.type, a.i = AttrT.INT, v
    elif isinstance(v, float):
        a.type, a.f = AttrT.FLOAT, v
    elif isinstance(v, str):
        a.type, a.s = AttrT.STRING, v.encode("utf-8")
    elif isinstance(v, bytes):
        a.type, a.s = AttrT.STRING, v
    elif isinstance(v, (np.ndarray, torch.Tensor)):
        a.type, a.t = AttrT.TENSOR, numpy_to_tensor(v)
    elif isinstance(v, Graph):
        a.type, a.g = AttrT.GRAPH, _graph_to_proto(v)
    elif isinstance(v, (list, tuple)):
        if all(isinstance(x, (int, bool)) for x in v):
            a.type, a.ints = AttrT.INTS, [int(x) for x in v]
        elif all(isinstance(x, (int, float)) for x in v):
            a.type, a.floats = AttrT.FLOATS, [float(x) for x in v]
        elif all(isinstance(x, str) for x in v):
            a.type, a.strings = AttrT.STRINGS, [x.encode("utf-8") for x in v]
        else:
            raise ImportError_(f"attribute {name!r}: mixed list {v!r}")
    else:
        raise ImportError_(f"attribute {name!r}: cannot encode {type(v)}")
    return a


def _type_from_proto(t: onnx.TypeProto | None) -> TensorType | None:
    if t is None or not t.has("tensor_type"):
        return None
    tt = t.tensor_type
    dims: list[int | str | None] = []
    for d in (tt.shape.dim if tt.shape is not None else []):
        which = d.which_oneof()
        if which == "dim_value":
            dims.append(int(d.dim_value))
        elif which == "dim_param":
            dims.append(d.dim_param)
        else:
            dims.append(None)
    return TensorType(dtype=tt.elem_type, shape=tuple(dims))


def _type_to_proto(t: TensorType) -> onnx.TypeProto:
    dims = []
    for d in t.shape:
        if isinstance(d, int):
            dims.append(onnx.TensorShapeDimension(dim_value=d))
        elif isinstance(d, str):
            dims.append(onnx.TensorShapeDimension(dim_param=d))
        else:
            dims.append(onnx.TensorShapeDimension())
    # a scalar leaves `shape` unset, as protobuf's writer does
    return onnx.TypeProto(tensor_type=onnx.TypeProtoTensor(
        elem_type=t.dtype, shape=onnx.TensorShapeProto(dim=dims) if dims else None))


def _value_info(name: str, t: TensorType | None) -> onnx.ValueInfoProto:
    return onnx.ValueInfoProto(
        name=name, type=None if t is None else _type_to_proto(t))


def _graph_from_proto(gp: onnx.GraphProto, opset: int,
                      base_dir: str | None = None) -> Graph:
    g = Graph(name=gp.name or "graph", opset=opset)
    for tp in gp.initializer:
        g.initializers[tp.name] = tensor_to_numpy(tp, base_dir)
    for vi in gp.input:
        if vi.name in g.initializers:
            continue  # older exporters list initializers as inputs too
        g.inputs.append(ValueInfo(vi.name, _type_from_proto(vi.type)))
    for vi in gp.output:
        g.outputs.append(ValueInfo(vi.name, _type_from_proto(vi.type)))
    for vi in gp.value_info:
        t = _type_from_proto(vi.type)
        if t is not None:
            g.value_types[vi.name] = t
    for np_ in gp.node:
        g.nodes.append(
            Node(
                op_type=np_.op_type,
                inputs=list(np_.input),
                outputs=list(np_.output),
                attrs={a.name: _decode_attr(a) for a in np_.attribute},
                name=np_.name,
                domain=np_.domain,
            )
        )
    return g


def _graph_to_proto(g: Graph) -> onnx.GraphProto:
    gp = onnx.GraphProto(name=g.name)
    gp.initializer = [numpy_to_tensor(arr, name)
                      for name, arr in g.initializers.items()]
    gp.input = [_value_info(vi.name, vi.type) for vi in g.inputs]
    gp.output = [_value_info(vi.name, vi.type) for vi in g.outputs]
    gp.value_info = [_value_info(name, t) for name, t in g.value_types.items()]
    gp.node = [
        onnx.NodeProto(op_type=n.op_type, input=list(n.inputs),
                       output=list(n.outputs), name=n.name, domain=n.domain,
                       attribute=[_encode_attr(k, v) for k, v in n.attrs.items()])
        for n in g.nodes
    ]
    return gp


def import_model(data: bytes, base_dir: str | None = None) -> Graph:
    """Parse serialized ONNX ModelProto bytes into the typed IR. base_dir
    resolves external-data weight files (defaults to the model's dir when
    loading via load_model)."""
    try:
        mp = onnx.ModelProto.FromString(data)
    except Exception as e:  # malformed wire data
        raise ImportError_(f"could not parse ONNX model: {e}") from e
    if not mp.has("graph"):
        raise ImportError_("model has no graph")
    opset = 17
    for osi in mp.opset_import:
        if osi.domain in ("", "ai.onnx"):
            opset = int(osi.version)
    if mp.functions:
        from .functions import inline_functions

        inline_functions(mp)
    g = _graph_from_proto(mp.graph, opset=opset, base_dir=base_dir)
    g.producer = mp.producer_name
    g.metadata = {p.key: p.value for p in mp.metadata_props}
    g.toposort()
    return g


def load_model(path: str | os.PathLike) -> Graph:
    with open(path, "rb") as f:
        return import_model(f.read(), base_dir=os.path.dirname(os.fspath(path)) or ".")


def export_model(g: Graph, producer: str | None = None) -> bytes:
    """Serialize the IR back to ONNX ModelProto bytes."""
    mp = onnx.ModelProto(
        ir_version=8,
        opset_import=[onnx.OperatorSetIdProto(domain="", version=g.opset)],
        producer_name=producer if producer is not None else (g.producer or "smelter-tpu"),
        graph=_graph_to_proto(g),
        metadata_props=[onnx.StringStringEntryProto(key=k, value=v)
                        for k, v in g.metadata.items()],
    )
    return mp.SerializeToString()


def save_model(g: Graph, path: str | os.PathLike, producer: str | None = None) -> None:
    with open(path, "wb") as f:
        f.write(export_model(g, producer))
