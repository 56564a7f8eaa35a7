"""Static-shape nearest resize with ONNX coordinate semantics.

The port's part of `smelter_tpu/ops/resize_utils.py`: the nearest mode under
the "asymmetric" coordinate transform and "floor" rounding, which is what
the fx exporter emits for `F.interpolate(..., mode="nearest")` (and what
Upsample's nearest mode means). Gather indices are computed in numpy from
the static shapes; an exact integer repeat becomes a broadcast and a
reshape. Every other mode raises NotSupportedError.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ir.errors import NotSupportedError


def nearest_indices(out_size: int, in_size: int) -> np.ndarray:
    """Source index of each output index: floor(x / scale), scale = out/in,
    clipped into the input."""
    coords = np.arange(out_size, dtype=np.float64) / (out_size / in_size)
    return np.clip(np.floor(coords), 0, in_size - 1).astype(np.int64)


def resize_nearest(x: torch.Tensor, out_sizes: tuple[int, ...], *, coord_mode: str,
                   nearest_mode: str, spatial_axes: tuple[int, ...]) -> torch.Tensor:
    """Resize the `spatial_axes` of x to `out_sizes` by nearest neighbour."""
    if coord_mode != "asymmetric" or nearest_mode != "floor":
        raise NotSupportedError(
            f"nearest resize with coordinate_transformation_mode={coord_mode!r}, "
            f"nearest_mode={nearest_mode!r} (the port takes asymmetric/floor)")
    out = x
    for axis, out_s in zip(spatial_axes, out_sizes):
        in_s = out.shape[axis]
        if in_s == out_s:
            continue
        idx = nearest_indices(out_s, in_s)
        k, rem = divmod(out_s, in_s)
        if rem == 0 and np.array_equal(idx, np.repeat(np.arange(in_s), k)):
            shape = list(out.shape)
            shape_b = shape[:axis + 1] + [k] + shape[axis + 1:]
            shape[axis] = out_s
            out = out.unsqueeze(axis + 1).expand(shape_b).reshape(shape)
            continue
        out = out.index_select(axis, torch.as_tensor(idx, device=out.device))
    return out
