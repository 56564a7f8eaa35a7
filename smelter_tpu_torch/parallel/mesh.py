"""Device meshes and the sharding of full tensors over their axes.

The port's counterpart of `smelter_tpu/parallel/mesh.py`: a `Mesh` names
its axes and maps each rank (a point of the mesh) to a `torch.device`, and
`MeshPlan` picks a (dp, tp) mesh for a number of devices by the JAX
package's rule. The JAX package lets `device_put(x, NamedSharding(mesh,
P(...)))` cut a full array over the mesh and its shard_map wrappers return
sharded arrays; here `Mesh.shard` cuts a full tensor into one contiguous
shard a rank, on that rank's device, and `ShardedTensor` holds the shards
with their spec and gathers them back (`full`).

Devices may repeat: `Mesh(["cuda:0"] * 4, ("tp",))` is four ranks on one
card (each rank its own shard, the ring between them an on-card copy), and
`Mesh(["cpu"] * 8, ("sp",))` is the CPU tests' counterpart of the JAX
tests' virtual 8-device mesh. The same code takes ranks on distinct cards.
With no devices named, ranks map to the visible cards in turn (rank i on
`cuda:(i % count)`); without a card that raises, as the port's other entry
points do.

Sharding a compiled graph's parameters (`_role_map`, `param_shardings`,
`shard_params`, `shard_inputs` of the JAX module) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

import numpy as np
import torch

from .ring import Ring


def default_devices(n: int) -> list[torch.device]:
    """`n` ranks on the visible cards in turn; raises without a card."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("no CUDA card is available; pass devices=['cpu'] * n to run the "
                           "mesh on the CPU")
    return [torch.device("cuda", i % count) for i in range(n)]


class Mesh:
    """Named axes over an array of ranks, each rank a `torch.device`."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh of shape {arr.shape} cannot take the axes {axis_names}")
        self.devices = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            self.devices[idx] = torch.device(arr[idx])
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, arr.shape))
        self._comm_streams: dict = {}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_list(self) -> list[torch.device]:
        """The ranks' devices in row-major order of the mesh (flat rank)."""
        return list(self.devices.reshape(-1))

    def _axis(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"the mesh has no axis {axis!r} (axes {self.axis_names})")
        return self.axis_names.index(axis)

    def rings(self, axis: str) -> list[Ring]:
        """One ring along `axis` for each point of the other axes: its ranks
        (flat) in the order of their coordinate on `axis`."""
        a = self._axis(axis)
        flat = np.arange(self.size).reshape(self.devices.shape)
        rings = []
        for rest in itertools.product(*(range(n) for i, n in enumerate(self.devices.shape)
                                        if i != a)):
            idx = list(rest)
            ranks = []
            for c in range(self.devices.shape[a]):
                idx.insert(a, c)
                ranks.append(int(flat[tuple(idx)]))
                idx.pop(a)
            rings.append(Ring([self.devices.reshape(-1)[r] for r in ranks], ranks,
                              self._comm_streams))
        return rings

    def run_rings(self, axis: str, fn, *shards: list, **kw) -> list:
        """fn(*shard lists in ring order, ring, **kw) on each ring along
        `axis`; its per-rank results back in flat-rank order."""
        out: list = [None] * self.size
        for ring in self.rings(axis):
            got = fn(*([s[r] for r in ring.ranks] for s in shards), ring, **kw)
            for r, o in zip(ring.ranks, got):
                out[r] = o
        return out

    def _check_spec(self, spec: tuple, ndim: int) -> tuple:
        spec = tuple(spec) + (None,) * (ndim - len(spec))
        if len(spec) != ndim:
            raise ValueError(f"spec {spec} has more entries than the tensor's {ndim} dims")
        named = [s for s in spec if s is not None]
        for s in named:
            self._axis(s)
        if len(set(named)) != len(named):
            raise ValueError(f"spec {spec} shards two dims over one axis")
        return spec

    def _slices(self, shape: tuple, spec: tuple, rank: int) -> tuple:
        coord = np.unravel_index(rank, self.devices.shape)
        out = []
        for dim, s in zip(shape, spec):
            if s is None:
                out.append(slice(None))
                continue
            n = self.shape[s]
            c = int(coord[self._axis(s)])
            out.append(slice(c * (dim // n), (c + 1) * (dim // n)))
        return tuple(out)

    def shard(self, x, spec: tuple) -> list[torch.Tensor]:
        """Cut a full tensor (or numpy array, or a `ShardedTensor` of this
        mesh) into one contiguous shard a flat rank, on that rank's device:
        dim d over axis spec[d] (None: every rank holds the whole dim). A
        `ShardedTensor` already cut this way is passed through as it is."""
        if isinstance(x, ShardedTensor):
            if x.mesh is self and x.spec == self._check_spec(spec, len(x.shape)):
                return list(x.shards)
            x = x.full()
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
        spec = self._check_spec(spec, t.dim())
        for dim, s in zip(t.shape, spec):
            if s is not None and dim % self.shape[s]:
                raise ValueError(f"dim {dim} does not split evenly over axis {s!r} "
                                 f"({self.shape[s]} ranks)")
        return [t[self._slices(tuple(t.shape), spec, r)].to(dev).contiguous()
                for r, dev in enumerate(self.device_list())]


@dataclasses.dataclass
class ShardedTensor:
    """A full tensor of `shape` held as one shard a flat rank of `mesh`, cut
    by `spec` (dim d over axis spec[d], or whole where it is None)."""

    shards: list
    mesh: Mesh
    spec: tuple
    shape: tuple

    def full(self, device=None) -> torch.Tensor:
        """The shards put back together on `device` (default: rank 0's)."""
        dev = torch.device(device) if device is not None else self.shards[0].device
        out = torch.empty(self.shape, dtype=self.shards[0].dtype, device=dev)
        for r, s in enumerate(self.shards):
            out[self.mesh._slices(self.shape, self.spec, r)] = s.to(dev)
        return out

    def numpy(self) -> np.ndarray:
        return self.full("cpu").numpy()

    def map(self, fn) -> "ShardedTensor":
        """fn applied to each shard on its own rank (an elementwise op)."""
        shards = [fn(s) for s in self.shards]
        return ShardedTensor(shards, self.mesh, self.spec, self.shape)


@dataclasses.dataclass
class MeshPlan:
    """A (dp, tp) mesh and its axis names for data- and tensor-parallel
    sharding."""

    mesh: Mesh
    dp_axis: str = "dp"
    tp_axis: str = "tp"

    @classmethod
    def for_devices(cls, n_devices: int | None = None, tp: int | None = None,
                    devices=None) -> "MeshPlan":
        """tp defaults to the largest of 4, 2, 1 that divides the device
        count, as the JAX package chooses. Without `devices`, `n_devices`
        ranks (default: one a visible card) on the visible cards in turn;
        given `devices`, all of them, and `n_devices` is not read (the JAX
        package's rule)."""
        if devices is None:
            n = n_devices if n_devices is not None else max(1, torch.cuda.device_count())
            devices = default_devices(n)
        devices = list(devices)
        n = len(devices)
        if tp is None:
            tp = next(c for c in (4, 2, 1) if n % c == 0 and c <= n)
        if tp <= 0 or n % tp:
            raise ValueError(f"tp {tp} does not divide {n} devices")
        grid = np.empty((n // tp, tp), dtype=object)
        for i, d in enumerate(devices):
            grid[i // tp, i % tp] = d
        return cls(mesh=Mesh(grid, ("dp", "tp")))

    @property
    def tp_size(self) -> int:
        return self.mesh.shape[self.tp_axis]

    @property
    def dp_size(self) -> int:
        return self.mesh.shape[self.dp_axis]
