"""TensorProto <-> numpy codec, over the port's own wire-format reader.

Zero-copy reinterpret of raw_data when possible, typed-field fallback,
fp16 aware, as the JAX package's codec. numpy has no bf16 or fp8 dtype
here (the port does without `ml_dtypes`), so those payloads decode
straight to torch tensors and encode from them. int4/uint4 payloads raise
NotSupportedError (utils/dtypes.py).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..proto import onnx_wire as onnx
from ..utils import dtypes as dt
from .errors import ImportError_

# ONNX stores some narrow dtypes widened inside int32_data.
_INT32_CARRIED = {dt.UINT8, dt.INT8, dt.UINT16, dt.INT16, dt.INT32, dt.BOOL,
                  dt.FLOAT16, dt.BFLOAT16}


def _read_external(tp: onnx.TensorProto, base_dir: str) -> bytes:
    """ONNX external-data convention: key/value pairs location (relative
    path), offset, length."""
    info = {p.key: p.value for p in tp.external_data}
    loc = info.get("location")
    if not loc:
        raise ImportError_(f"tensor {tp.name!r}: external data without location")
    path = os.path.join(base_dir, loc)
    if not os.path.exists(path):
        raise ImportError_(
            f"tensor {tp.name!r}: external data file {loc!r} not found next "
            f"to the model")
    offset = int(info.get("offset", 0))
    with open(path, "rb") as f:
        f.seek(offset)
        length = info.get("length")
        return f.read(int(length)) if length is not None else f.read()


def _torch_only(raw: bytes, code: int, shape: tuple, name: str) -> torch.Tensor:
    """bf16/fp8 payload -> torch tensor (numpy cannot hold these dtypes)."""
    tdtype = dt.onnx_to_torch_dtype(code)
    count = int(np.prod(shape)) if shape else 1
    need = count * tdtype.itemsize
    if len(raw) < need:
        raise ImportError_(f"tensor {name!r}: payload has {len(raw)} bytes, "
                           f"shape {shape} ({dt.dtype_name(code)}) needs {need}")
    bits = np.frombuffer(raw, np.uint8, count=need).copy()
    return torch.from_numpy(bits).view(tdtype).reshape(shape)


def tensor_to_numpy(tp: onnx.TensorProto, base_dir: str | None = None):
    """Decode a TensorProto into a numpy array of the tensor's dtype/shape
    (a torch tensor for bf16/fp8). base_dir resolves ONNX external-data
    files (weights in side files)."""
    if tp.data_type == dt.STRING:
        raise ImportError_(f"string tensors not supported (tensor {tp.name!r})")
    shape = tuple(tp.dims)
    count = int(np.prod(shape)) if shape else 1
    if tp.data_location == onnx.TensorProto.EXTERNAL:
        if base_dir is None:
            raise ImportError_(
                f"tensor {tp.name!r} uses external data files; load via a "
                f"file path (load_model) so they can be resolved")
        raw = _read_external(tp, base_dir)
    elif tp.raw_data:
        raw = tp.raw_data
    else:
        raw = None
    if dt.is_torch_only(tp.data_type):
        if raw is None and tp.data_type == dt.BFLOAT16 and tp.int32_data:
            # bf16 stored as its bit pattern in the low 16 bits of int32_data
            raw = np.asarray(tp.int32_data, np.int32).astype(np.uint16).tobytes()
        if raw is None:
            raise ImportError_(
                f"tensor {tp.name!r}: no payload for dtype {dt.dtype_name(tp.data_type)}")
        return _torch_only(raw, tp.data_type, shape, tp.name)

    np_dtype = dt.onnx_to_numpy_dtype(tp.data_type)
    if raw is not None:
        if len(raw) < count * np_dtype.itemsize:
            raise ImportError_(
                f"tensor {tp.name!r}: raw_data has {len(raw)} bytes, "
                f"shape {shape} ({dt.dtype_name(tp.data_type)}) needs "
                f"{count * np_dtype.itemsize}"
            )
        return np.frombuffer(raw, dtype=np_dtype, count=count).reshape(shape)
    if tp.data_type == dt.FLOAT:
        arr = np.asarray(tp.float_data, dtype=np.float32)
    elif tp.data_type == dt.DOUBLE:
        arr = np.asarray(tp.double_data, dtype=np.float64)
    elif tp.data_type == dt.INT64:
        arr = np.asarray(tp.int64_data, dtype=np.int64)
    elif tp.data_type in (dt.UINT64, dt.UINT32):
        arr = np.asarray(tp.uint64_data, dtype=np.uint64).astype(np_dtype)
    elif tp.data_type in _INT32_CARRIED:
        raw32 = np.asarray(tp.int32_data, dtype=np.int32)
        if tp.data_type == dt.FLOAT16:
            # fp16 is stored as its bit pattern in the low 16 bits.
            arr = raw32.astype(np.uint16).view(np_dtype)
        else:
            arr = raw32.astype(np_dtype)
    else:
        raise ImportError_(
            f"tensor {tp.name!r}: no payload for dtype {dt.dtype_name(tp.data_type)}"
        )
    if arr.size != count:
        raise ImportError_(
            f"tensor {tp.name!r}: payload has {arr.size} elements, shape {shape} "
            f"needs {count}"
        )
    return arr.reshape(shape)


def numpy_to_tensor(arr, name: str = "") -> onnx.TensorProto:
    """Encode a numpy array (or a torch tensor, for bf16/fp8) as a
    TensorProto using raw_data (compact, fast)."""
    tp = onnx.TensorProto(name=name)
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        tp.data_type = dt.torch_to_onnx_dtype(t.dtype)
        tp.dims = list(t.shape)
        tp.raw_data = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        return tp
    arr = np.asarray(arr, order="C")  # not ascontiguousarray: that promotes 0-d to 1-d
    tp.data_type = dt.numpy_to_onnx_dtype(arr.dtype)
    tp.dims = list(arr.shape)
    tp.raw_data = arr.tobytes()
    return tp
