"""MaxUnpool of non-overlapping 2x2 / stride 2 windows (SegNet's decoder):
`max_unpool2x2`.

x (B, C, h, w) and idx (B, C, h, w), each index a flat position in the
(B, C, 2h, 2w) output as MaxPool's indices output gives it (ONNX: over
[N, C, H, W]). Each value lands inside its own 2x2 window, at the parity of
its index, ((idx // 2w) % 2, idx % 2), and the window's other three
positions are zero. The parity names the landing place because 2h and 2w
are even, so every term of the flat offset but the window's own row and
column is even.

Replaces the Pallas kernel `smelter_tpu/kernels/max_unpool.py::
max_unpool2x2`. The Hopper kernel is `csrc/max_unpool.cu`:

- What bounds it on an H100: the bytes. x and the int64 index are read
  once and the output (four times x) written once; at SegNet's three
  unpools (batch 16, 256 px, base 32) that is ~264 MB in bf16, ~79 us at
  3.35 TB/s. The index is the largest operand: the JAX package reads int32.
- What the simple design does about it: one thread an input element, which
  writes its window's two output rows as two 2-element stores.

A CPU or `meta` tensor takes the plain version (`max_unpool2x2_plain`);
a CUDA tensor launches the kernel or raises. `launches` counts the
kernel's launches and nothing else.
"""

from __future__ import annotations

import torch

from . import _build

launches = 0

_X_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def max_unpool2x2_plain(x, idx) -> torch.Tensor:
    """The kernel's function in plain PyTorch: x at each window's parity
    position, zeros elsewhere."""
    b, c, h, w = x.shape
    idx = idx.reshape(x.shape).to(torch.int64)
    ar = torch.arange(2, device=x.device)
    dy = torch.div(idx, 2 * w, rounding_mode="floor").remainder(2)
    dx = idx.remainder(2)
    land = ((dy.reshape(b, c, h, 1, w, 1) == ar.reshape(2, 1, 1))
            & (dx.reshape(b, c, h, 1, w, 1) == ar))
    y = torch.where(land, x.reshape(b, c, h, 1, w, 1),
                    torch.zeros((), dtype=x.dtype, device=x.device))
    return y.reshape(b, c, 2 * h, 2 * w)


def max_unpool2x2(x, idx) -> torch.Tensor:
    """x (B, C, h, w) f32/bf16/f16, idx of x's shape (int64, or another
    integer type, converted). Returns (B, C, 2h, 2w) in x's dtype."""
    global launches
    if x.device.type in ("cpu", "meta"):
        return max_unpool2x2_plain(x, idx)
    if x.device.type != "cuda":
        raise ValueError(f"max_unpool2x2: no kernel for device {x.device}")
    if x.dim() != 4 or tuple(idx.shape) != tuple(x.shape):
        raise ValueError(f"max_unpool2x2: x {tuple(x.shape)} and idx {tuple(idx.shape)} must "
                         "be one (B, C, h, w) shape")
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"max_unpool2x2: x {x.dtype} not taken")
    if idx.dtype.is_floating_point or idx.dtype == torch.bool or idx.device != x.device:
        raise TypeError(f"max_unpool2x2: idx must be integer indices on {x.device}")
    if 4 * x.numel() >= 2 ** 31:
        raise ValueError("max_unpool2x2: outputs of 2^31 elements or more are not taken")
    x = x.contiguous()
    idx = idx.to(torch.int64).contiguous()
    b, c, h, w = x.shape
    out = torch.empty((b, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    lib = _build.library("max_unpool")
    with torch.cuda.device(x.device):
        rc = lib.smelter_max_unpool2x2(x.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                       x.numel(), w, _build.DTYPE_CODES[x.dtype],
                                       _build.stream_of(x))
    _build.check(lib, rc, "max_unpool2x2")
    launches += 1
    return out
