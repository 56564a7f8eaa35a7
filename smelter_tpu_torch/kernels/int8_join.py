"""The residual join of an int8-static network as one kernel:

    r = relu(f32(a) * s_a + f32(b) * s_b)
    out = clip(round(r * inv_y), -128, 127) as int8    (inv_y given)
    out = r as f32                                     (inv_y None)

a and b int8 of one shape (a conv's output and the block's int8 carry),
s_a, s_b their per-tensor scales and inv_y the f32 reciprocal of the next
edge's scale, folded in f64 as the QuantizeLinear lowering folds it. Each
product, the sum and the last product round to f32 on their own and the
round is half to even: the port's DequantizeLinear, DequantizeLinear ->
Add -> Relu [-> QuantizeLinear] lowerings, one op at a time, give the same
edges bit for bit.

It replaces no Pallas kernel: it stands in for the fusion XLA makes of that
chain under the JAX package's jit (`smelter_tpu/quant/static_quant.py::
_requantize_carries`), as `qlinear_conv` stands in for XLA's int8 conv. The
walk's plan (`runtime/chains.py`) routes each such chain here. The Hopper
kernel is `csrc/int8_join.cu`:

- What bounds it on an H100: the bytes (2 read and 1 written an element,
  or 2 and 4 with f32 out).
- Its design: a grid-stride loop over the inputs' common dense storage, 16
  elements a thread an iteration with one 16-byte load of each input and a
  16-byte int8 store (four with f32 out), a scalar loop for the tail and
  for bases that are not 16-byte aligned.

The output takes the inputs' memory layout (channels-last in, channels-last
out). Inputs whose strides differ, or that are not dense, are copied to one
layout first (`layout_copies` counts them). A CPU or `meta` tensor takes
the plain version (`int8_join_plain`); a CUDA tensor launches the kernel or
raises. `launches` counts kernel launches and nothing else.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

launches = 0
layout_copies = 0  # inputs the wrapper copied to a common layout

_BLOCKS_PER_SM = 8
_THREADS = 256


def _f32(s) -> float:
    """s as the f32 value it holds (a Python float multiplies an f32 tensor
    in f32, as the lowerings' 0-d f32 scales do, and needs no upload)."""
    return float(np.float32(s))


def int8_join_plain(a: torch.Tensor, b: torch.Tensor, s_a, s_b, inv_y=None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, op for op the unfused
    lowerings: the two dequantizing products, the sum, the Relu, and with
    inv_y the requantizing product, round and clip."""
    r = torch.relu(a.float() * _f32(s_a) + b.float() * _f32(s_b))
    if inv_y is None:
        return r
    return torch.clamp(torch.round(r * _f32(inv_y)), -128, 127).to(torch.int8)


def _dense(t: torch.Tensor) -> bool:
    """Whether t's elements fill its storage span once each, in some order
    of its dims (a permutation of a contiguous layout)."""
    expect = 1
    for stride, size in sorted((st, sz) for st, sz in zip(t.stride(), t.shape) if sz != 1):
        if stride != expect:
            return False
        expect *= size
    return True


def int8_join(a: torch.Tensor, b: torch.Tensor, s_a: float, s_b: float,
              inv_y: float | None = None) -> torch.Tensor:
    """a, b int8 of one shape, any layout; s_a, s_b, inv_y f32 values (inv_y
    None: f32 out). Returns int8 (or f32) of a's shape, in a's memory layout
    where a is dense."""
    global launches, layout_copies
    if a.device.type in ("cpu", "meta"):
        return int8_join_plain(a, b, s_a, s_b, inv_y)
    if a.device.type != "cuda":
        raise ValueError(f"int8_join: no kernel for device {a.device}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_join: a {a.dtype} and b {b.dtype} must be int8")
    if a.shape != b.shape:
        raise ValueError(f"int8_join: shapes {tuple(a.shape)} and {tuple(b.shape)} differ")
    if b.device != a.device:
        raise ValueError("int8_join: operands must lie on one device")
    if not _dense(a):
        a = a.contiguous()
        layout_copies += 1
    if b.stride() != a.stride() or not _dense(b):
        b = torch.empty_like(a).copy_(b)  # a's layout
        layout_copies += 1
    out = torch.empty_like(a, dtype=torch.int8 if inv_y is not None else torch.float32)
    n = a.numel()
    if n == 0:
        return out
    blocks = max(1, min(-(-n // (16 * _THREADS)), _BLOCKS_PER_SM * _build.sms(a.device)))
    lib = _build.library("int8_join")
    with torch.cuda.device(a.device):
        rc = lib.smelter_int8_join(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, _f32(s_a),
                                   _f32(s_b), 0.0 if inv_y is None else _f32(inv_y),
                                   int(inv_y is None), blocks, _build.stream_of(a))
    _build.check(lib, rc, "int8_join")
    launches += 1
    return out
