"""Dtype registry: ONNX TensorProto.DataType codes <-> numpy <-> torch.

The JAX package maps bf16/fp8/int4 onto numpy through `ml_dtypes`. The port
does without it: numpy only carries the dtypes it has natively, and the
narrow float types (bf16, fp8) decode straight to torch tensors. int4 and
uint4 are not supported yet and raise NotSupportedError naming the code.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ir.errors import NotSupportedError

# ONNX TensorProto.DataType codes (public ONNX spec).
UNDEFINED = 0
FLOAT = 1
UINT8 = 2
INT8 = 3
UINT16 = 4
INT16 = 5
INT32 = 6
INT64 = 7
STRING = 8
BOOL = 9
FLOAT16 = 10
DOUBLE = 11
UINT32 = 12
UINT64 = 13
COMPLEX64 = 14
COMPLEX128 = 15
BFLOAT16 = 16
FLOAT8E4M3FN = 17
FLOAT8E4M3FNUZ = 18
FLOAT8E5M2 = 19
FLOAT8E5M2FNUZ = 20
UINT4 = 21
INT4 = 22

_ONNX_TO_NUMPY = {
    FLOAT: np.dtype(np.float32),
    UINT8: np.dtype(np.uint8),
    INT8: np.dtype(np.int8),
    UINT16: np.dtype(np.uint16),
    INT16: np.dtype(np.int16),
    INT32: np.dtype(np.int32),
    INT64: np.dtype(np.int64),
    BOOL: np.dtype(np.bool_),
    FLOAT16: np.dtype(np.float16),
    DOUBLE: np.dtype(np.float64),
    UINT32: np.dtype(np.uint32),
    UINT64: np.dtype(np.uint64),
    COMPLEX64: np.dtype(np.complex64),
    COMPLEX128: np.dtype(np.complex128),
}

_NUMPY_TO_ONNX = {v: k for k, v in _ONNX_TO_NUMPY.items()}

# Narrow float codes numpy cannot hold: decoded as torch tensors.
_ONNX_TO_TORCH_ONLY = {
    BFLOAT16: torch.bfloat16,
    FLOAT8E4M3FN: torch.float8_e4m3fn,
    FLOAT8E4M3FNUZ: torch.float8_e4m3fnuz,
    FLOAT8E5M2: torch.float8_e5m2,
    FLOAT8E5M2FNUZ: torch.float8_e5m2fnuz,
}

_TORCH_TO_ONNX = {
    torch.float32: FLOAT, torch.uint8: UINT8, torch.int8: INT8,
    torch.int16: INT16, torch.int32: INT32, torch.int64: INT64,
    torch.bool: BOOL, torch.float16: FLOAT16, torch.float64: DOUBLE,
    torch.complex64: COMPLEX64, torch.complex128: COMPLEX128,
    **{v: k for k, v in _ONNX_TO_TORCH_ONLY.items()},
}

_NAMES = {
    UNDEFINED: "undefined",
    FLOAT: "float32",
    UINT8: "uint8",
    INT8: "int8",
    UINT16: "uint16",
    INT16: "int16",
    INT32: "int32",
    INT64: "int64",
    STRING: "string",
    BOOL: "bool",
    FLOAT16: "float16",
    DOUBLE: "float64",
    UINT32: "uint32",
    UINT64: "uint64",
    COMPLEX64: "complex64",
    COMPLEX128: "complex128",
    BFLOAT16: "bfloat16",
    FLOAT8E4M3FN: "float8_e4m3fn",
    FLOAT8E4M3FNUZ: "float8_e4m3fnuz",
    FLOAT8E5M2: "float8_e5m2",
    FLOAT8E5M2FNUZ: "float8_e5m2fnuz",
    UINT4: "uint4",
    INT4: "int4",
}


def _reject_int4(code: int) -> None:
    if code in (INT4, UINT4):
        raise NotSupportedError(
            f"ONNX dtype code {code} ({_NAMES[code]}) is not supported by "
            f"the PyTorch port yet")


def onnx_to_numpy_dtype(code: int) -> np.dtype:
    _reject_int4(code)
    try:
        return _ONNX_TO_NUMPY[code]
    except KeyError:
        raise ValueError(f"unsupported numpy dtype for ONNX code {code} "
                         f"({_NAMES.get(code, '?')})")


def is_torch_only(code: int) -> bool:
    """True for codes decoded as torch tensors (no numpy dtype)."""
    return code in _ONNX_TO_TORCH_ONLY


def onnx_to_torch_dtype(code: int) -> torch.dtype:
    _reject_int4(code)
    if code in _ONNX_TO_TORCH_ONLY:
        return _ONNX_TO_TORCH_ONLY[code]
    np_dtype = onnx_to_numpy_dtype(code)
    return torch.from_numpy(np.zeros(0, np_dtype)).dtype


def numpy_to_onnx_dtype(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return torch_to_onnx_dtype(dtype)
    dtype = np.dtype(dtype)
    try:
        return _NUMPY_TO_ONNX[dtype]
    except KeyError:
        raise ValueError(f"numpy dtype {dtype} has no ONNX code")


def torch_to_onnx_dtype(dtype: torch.dtype) -> int:
    try:
        return _TORCH_TO_ONNX[dtype]
    except KeyError:
        raise ValueError(f"torch dtype {dtype} has no ONNX code")


def dtype_name(code: int) -> str:
    return _NAMES.get(code, f"dtype<{code}>")


def is_float(code: int) -> bool:
    return code in (FLOAT, FLOAT16, DOUBLE, BFLOAT16, FLOAT8E4M3FN,
                    FLOAT8E4M3FNUZ, FLOAT8E5M2, FLOAT8E5M2FNUZ)


def itemsize(code: int) -> int:
    if code in _ONNX_TO_TORCH_ONLY:
        return _ONNX_TO_TORCH_ONLY[code].itemsize
    return onnx_to_numpy_dtype(code).itemsize


# The integer types a float converts into by clamping, as XLA's convert
# does: int32 clamps in float64, where its bounds are exact.
_SATURATING = {torch.int8: torch.float32, torch.uint8: torch.float32,
               torch.int16: torch.float32, torch.int32: torch.float64}


def _saturating_int64(x: torch.Tensor) -> torch.Tensor:
    """A float into int64 as XLA's convert does under x64. The bounds are
    compared in the float type (-2^63 and 2^63 are exact there) and the
    integer constants selected: clamping through float(INT64_MAX) would
    round it to 2^63, which wraps."""
    if x.dtype not in (torch.float32, torch.float64):
        x = x.float()
    hi, lo, nan = x >= 2.0 ** 63, x < -2.0 ** 63, torch.isnan(x)
    y = torch.where(hi | lo | nan, 0.0, x).to(torch.int64)
    y = torch.where(hi, torch.iinfo(torch.int64).max, y)
    return torch.where(lo, torch.iinfo(torch.int64).min, y)


def saturating_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x cast to `dtype` as the JAX package's `astype` lowers it (XLA's
    convert): a float into int8, uint8, int16, int32 or int64 is clamped to
    the type's range, NaN goes to 0, and the rest truncates toward zero, on
    every device. Every other cast is a plain `.to(dtype)` (an int into a
    narrower int keeps its low bits, as in XLA)."""
    if dtype == torch.int64 and x.is_floating_point():
        return _saturating_int64(x)
    wide = _SATURATING.get(dtype)
    if wide is None or not x.is_floating_point():
        return x.to(dtype)
    info = torch.iinfo(dtype)
    y = torch.nan_to_num(x.to(wide), nan=0.0).clamp(info.min, info.max)
    return y.to(dtype)
