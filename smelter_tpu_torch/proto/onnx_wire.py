"""ONNX protobuf wire format in pure Python.

The JAX package reads and writes ONNX through `google.protobuf` and the
generated `onnx_pb2`. The port cannot count on protobuf being installed,
so this module carries the small part of the wire format that the IR needs:
varints, fixed 32/64-bit scalars, length-delimited strings, bytes and
sub-messages, and repeated fields in both their packed and unpacked forms.
Field numbers follow `smelter_tpu/proto/onnx.proto`, which follows the
public onnx/onnx.proto, so real ONNX files parse.

Each message is a small class whose `FIELDS` table maps a field number to
(attribute name, kind, repeated). Repeated fields are Python lists,
sub-messages are None until set (`has`), and the members of a oneof are
None until one is set. Unknown fields are skipped on read. Writing emits
fields in field-number order with repeated scalars packed, as protobuf's
own serializer does.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

# wire types
_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5

# scalar kinds -> wire type
_SCALAR_WIRE = {
    "int32": _VARINT, "int64": _VARINT, "uint64": _VARINT, "enum": _VARINT,
    "float": _I32, "double": _I64,
}


class DecodeError(ValueError):
    """The bytes are not a valid encoding of the message."""


def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    n = len(buf)
    while True:
        if pos >= n:
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint too long")


def _write_varint(out: bytearray, v: int) -> None:
    if v < 0:
        v += 1 << 64  # negative int32/int64: ten-byte two's complement
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _signed(v: int, kind: str) -> int:
    if kind in ("int32", "int64", "enum") and v >= 1 << 63:
        v -= 1 << 64
    if kind in ("int32", "enum") and not -(1 << 31) <= v < (1 << 31):
        v = (v + (1 << 31)) % (1 << 32) - (1 << 31)
    return v


def _decode_packed(kind: str, data: memoryview) -> list:
    if kind == "float":
        return np.frombuffer(data, "<f4").tolist()
    if kind == "double":
        return np.frombuffer(data, "<f8").tolist()
    out = []
    pos, n = 0, len(data)
    while pos < n:
        v, pos = _read_varint(data, pos)
        out.append(_signed(v, kind))
    return out


class Message:
    """Base of every message class: generic decode and encode."""

    FIELDS: dict[int, tuple[str, Any, bool]] = {}
    ONEOF: tuple[str, ...] = ()

    def __init__(self, **kw):
        for _num, (name, kind, rep) in self.FIELDS.items():
            if rep:
                setattr(self, name, [])
            elif not isinstance(kind, str) or name in self.ONEOF:
                setattr(self, name, None)
            else:
                setattr(self, name, _default(kind))
        for k, v in kw.items():
            if not hasattr(self, k):
                raise AttributeError(f"{type(self).__name__} has no field {k!r}")
            setattr(self, k, v)

    # -- presence ---------------------------------------------------------

    def has(self, name: str) -> bool:
        return getattr(self, name) is not None

    def which_oneof(self) -> str | None:
        for name in self.ONEOF:
            if getattr(self, name) is not None:
                return name
        return None

    def __eq__(self, other) -> bool:
        return type(self) is type(other) and all(
            getattr(self, name) == getattr(other, name)
            for name, _k, _r in self.FIELDS.values())

    def __repr__(self) -> str:
        parts = [f"{name}={getattr(self, name)!r}"
                 for name, _k, _r in self.FIELDS.values()
                 if getattr(self, name) not in (None, [], "", b"", 0)]
        return f"{type(self).__name__}({', '.join(parts)})"

    # -- decode -----------------------------------------------------------

    @classmethod
    def FromString(cls, data: bytes | bytearray | memoryview):
        msg = cls()
        msg._parse(memoryview(data).cast("B"))
        return msg

    def _parse(self, buf: memoryview) -> None:
        pos, n = 0, len(buf)
        fields = self.FIELDS
        while pos < n:
            key, pos = _read_varint(buf, pos)
            num, wt = key >> 3, key & 7
            spec = fields.get(num)
            if wt == _VARINT:
                v, pos = _read_varint(buf, pos)
                raw: Any = v
            elif wt == _I64:
                raw = buf[pos:pos + 8]
                pos += 8
            elif wt == _I32:
                raw = buf[pos:pos + 4]
                pos += 4
            elif wt == _LEN:
                ln, pos = _read_varint(buf, pos)
                raw = buf[pos:pos + ln]
                pos += ln
            else:
                raise DecodeError(f"unsupported wire type {wt} (field {num})")
            if pos > n:
                raise DecodeError(f"truncated field {num}")
            if spec is None:
                continue  # unknown field
            name, kind, rep = spec
            value = self._decode_value(kind, wt, raw, rep)
            if rep:
                if isinstance(value, list):
                    getattr(self, name).extend(value)
                else:
                    getattr(self, name).append(value)
            else:
                setattr(self, name, value)

    @staticmethod
    def _decode_value(kind, wt: int, raw, rep: bool):
        if not isinstance(kind, str):
            if wt != _LEN:
                raise DecodeError(f"message field with wire type {wt}")
            sub = kind()
            sub._parse(raw)
            return sub
        if kind == "string":
            return bytes(raw).decode("utf-8")
        if kind == "bytes":
            return bytes(raw)
        if wt == _LEN:
            if not rep:
                raise DecodeError(f"length-delimited {kind} scalar")
            return _decode_packed(kind, raw)
        if kind == "float":
            return struct.unpack("<f", raw)[0]
        if kind == "double":
            return struct.unpack("<d", raw)[0]
        return _signed(raw, kind)

    # -- encode -----------------------------------------------------------

    def SerializeToString(self) -> bytes:
        out = bytearray()
        self._write(out)
        return bytes(out)

    def _write(self, out: bytearray) -> None:
        for num in sorted(self.FIELDS):
            name, kind, rep = self.FIELDS[num]
            value = getattr(self, name)
            if rep:
                if not value:
                    continue
                if isinstance(kind, str) and kind in _SCALAR_WIRE:
                    _write_varint(out, (num << 3) | _LEN)
                    packed = bytearray()
                    for v in value:
                        _write_scalar(packed, kind, v)
                    _write_varint(out, len(packed))
                    out += packed
                else:
                    for v in value:
                        _write_one(out, num, kind, v)
            elif value is None:
                continue
            elif (isinstance(kind, str) and name not in self.ONEOF
                  and value == _default(kind)):
                continue  # proto3: defaults are not written
            else:
                _write_one(out, num, kind, value)


def _default(kind: str):
    return {"string": "", "bytes": b"", "float": 0.0, "double": 0.0}.get(kind, 0)


def _write_scalar(out: bytearray, kind: str, v) -> None:
    if kind == "float":
        out += struct.pack("<f", v)
    elif kind == "double":
        out += struct.pack("<d", v)
    else:
        _write_varint(out, int(v))


def _write_one(out: bytearray, num: int, kind, v) -> None:
    if not isinstance(kind, str):
        _write_varint(out, (num << 3) | _LEN)
        sub = bytearray()
        v._write(sub)
        _write_varint(out, len(sub))
        out += sub
    elif kind in ("string", "bytes"):
        data = v.encode("utf-8") if kind == "string" else bytes(v)
        _write_varint(out, (num << 3) | _LEN)
        _write_varint(out, len(data))
        out += data
    else:
        _write_varint(out, (num << 3) | _SCALAR_WIRE[kind])
        _write_scalar(out, kind, v)


# -- the ONNX messages ------------------------------------------------------
# Classes are declared first and their FIELDS filled below, because the
# schema is recursive (GraphProto -> NodeProto -> AttributeProto -> GraphProto).


class StringStringEntryProto(Message):
    pass


class OperatorSetIdProto(Message):
    pass


class TensorProto(Message):
    # DataLocation
    DEFAULT, EXTERNAL = 0, 1


class TensorShapeDimension(Message):
    ONEOF = ("dim_value", "dim_param")


class TensorShapeProto(Message):
    pass


class TypeProtoTensor(Message):
    pass


class TypeProto(Message):
    ONEOF = ("tensor_type",)


class ValueInfoProto(Message):
    pass


class AttributeProto(Message):
    # AttributeType
    UNDEFINED, FLOAT, INT, STRING, TENSOR, GRAPH = 0, 1, 2, 3, 4, 5
    FLOATS, INTS, STRINGS, TENSORS, GRAPHS = 6, 7, 8, 9, 10
    SPARSE_TENSOR, SPARSE_TENSORS, TYPE_PROTO, TYPE_PROTOS = 11, 12, 13, 14


class NodeProto(Message):
    pass


class GraphProto(Message):
    pass


class FunctionProto(Message):
    pass


class ModelProto(Message):
    pass


class TensorSegment(Message):
    pass


StringStringEntryProto.FIELDS = {1: ("key", "string", False),
                                 2: ("value", "string", False)}
OperatorSetIdProto.FIELDS = {1: ("domain", "string", False),
                             2: ("version", "int64", False)}
TensorSegment.FIELDS = {1: ("begin", "int64", False), 2: ("end", "int64", False)}
TensorProto.FIELDS = {
    1: ("dims", "int64", True),
    2: ("data_type", "int32", False),
    3: ("segment", TensorSegment, False),
    4: ("float_data", "float", True),
    5: ("int32_data", "int32", True),
    6: ("string_data", "bytes", True),
    7: ("int64_data", "int64", True),
    8: ("name", "string", False),
    9: ("raw_data", "bytes", False),
    10: ("double_data", "double", True),
    11: ("uint64_data", "uint64", True),
    12: ("doc_string", "string", False),
    13: ("external_data", StringStringEntryProto, True),
    14: ("data_location", "enum", False),
}
TensorShapeDimension.FIELDS = {1: ("dim_value", "int64", False),
                               2: ("dim_param", "string", False),
                               3: ("denotation", "string", False)}
TensorShapeProto.FIELDS = {1: ("dim", TensorShapeDimension, True)}
TypeProtoTensor.FIELDS = {1: ("elem_type", "int32", False),
                          2: ("shape", TensorShapeProto, False)}
TypeProto.FIELDS = {1: ("tensor_type", TypeProtoTensor, False),
                    6: ("denotation", "string", False)}
ValueInfoProto.FIELDS = {1: ("name", "string", False),
                         2: ("type", TypeProto, False),
                         3: ("doc_string", "string", False)}
AttributeProto.FIELDS = {
    1: ("name", "string", False),
    2: ("f", "float", False),
    3: ("i", "int64", False),
    4: ("s", "bytes", False),
    5: ("t", TensorProto, False),
    6: ("g", GraphProto, False),
    7: ("floats", "float", True),
    8: ("ints", "int64", True),
    9: ("strings", "bytes", True),
    10: ("tensors", TensorProto, True),
    11: ("graphs", GraphProto, True),
    13: ("doc_string", "string", False),
    20: ("type", "enum", False),
    21: ("ref_attr_name", "string", False),
}
NodeProto.FIELDS = {
    1: ("input", "string", True),
    2: ("output", "string", True),
    3: ("name", "string", False),
    4: ("op_type", "string", False),
    5: ("attribute", AttributeProto, True),
    6: ("doc_string", "string", False),
    7: ("domain", "string", False),
    8: ("overload", "string", False),
}
GraphProto.FIELDS = {
    1: ("node", NodeProto, True),
    2: ("name", "string", False),
    5: ("initializer", TensorProto, True),
    10: ("doc_string", "string", False),
    11: ("input", ValueInfoProto, True),
    12: ("output", ValueInfoProto, True),
    13: ("value_info", ValueInfoProto, True),
}
FunctionProto.FIELDS = {
    1: ("name", "string", False),
    4: ("input", "string", True),
    5: ("output", "string", True),
    6: ("attribute", "string", True),
    7: ("node", NodeProto, True),
    8: ("doc_string", "string", False),
    9: ("opset_import", OperatorSetIdProto, True),
    10: ("domain", "string", False),
    11: ("attribute_proto", AttributeProto, True),
    12: ("value_info", ValueInfoProto, True),
    13: ("overload", "string", False),
}
ModelProto.FIELDS = {
    1: ("ir_version", "int64", False),
    2: ("producer_name", "string", False),
    3: ("producer_version", "string", False),
    4: ("domain", "string", False),
    5: ("model_version", "int64", False),
    6: ("doc_string", "string", False),
    7: ("graph", GraphProto, False),
    8: ("opset_import", OperatorSetIdProto, True),
    14: ("metadata_props", StringStringEntryProto, True),
    25: ("functions", FunctionProto, True),
}
