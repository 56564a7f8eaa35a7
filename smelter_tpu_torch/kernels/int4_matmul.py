"""Grouped int4 dequant + matmul over half-split packed nibbles (decode).

`out = sum_kb (x_lo[:, kb] @ lo_kb) * s[kb] + (x_hi[:, kb] @ hi_kb) * s[ngh + kb]`,
with x (M, K) rounded to bf16 first (also when it is f32), pk (K/2, N) int8
whose row r holds w[r] in its low nibble and w[r + K/2] in its high nibble
(`passes/fuse_dequant.py::pack_int4_half`), and scales (K/g, N) f32: row kb
for group kb of the low half, row ngh + kb for group kb of the high half
(ngh = K/2/g). Each group's dot is summed in f32 and scaled there; the
output is the f32 sum, returned in `out_dtype`.

Replaces the Pallas kernel `smelter_tpu/kernels/int4_matmul.py::
int4_matmul`. The Hopper kernels are in `csrc/int4_matmul.cu`, the form
picked by `wgmma_plan.int4_plan(N, K, group)` (never by M, so a row's
result does not depend on the other rows):

- What bounds it on an H100: the weight bytes. At decode (M = 8 slots, 1
  for a single stream) K*N/2 bytes of nibbles and K*N/g*4 of scales, 1.1
  MB (N 1024, K 2048) to 35 MB (N 32000, K 2048) a call; the tensor-core
  work is a few hundredths of that.
- "wgmma" (N % 128, group % 64: every llama_1b shape): a persistent weight
  stream. A work unit is 128 W columns x a chunk of whole groups x a slab
  of 8 rows of x; one producer thread a CTA keeps 64 KB of W in flight
  through TMA (two CTAs an SM), and two consumer warpgroups turn each
  nibble byte into two bf16 values in registers as wgmma's A operand (the
  product transposed, x^T the B operand from shared memory). Each group's
  f32 dots are scaled at its end; a tile split into several chunks has its
  f32 partials (scratch allocated here) added in chunk order by the last
  CTA of each (tile, slab), behind a counter that the kernel leaves at zero
  (one buffer per device, `_counters`); where the (tile, slab) pairs alone
  come near filling the card (a prefill's M, `Int4Plan.whole`), a unit
  walks all of a tile's chunks and folds their partials in the same order
  itself. The kernel takes bf16 x: f32 x is rounded to bf16 here first,
  one extra launch on that path only.
- "mma" (other shapes the wrapper takes): nibbles from HBM straight into
  mma.sync B fragments, one block of 8 warps per 32 output columns.

The JAX package's CPU composite (`smelter_tpu/ops/fused_ops.py:288-291`)
keeps x in f32; this module follows its Pallas kernel, which rounds x to
bf16. `int4_matmul` takes the plain PyTorch version for a tensor on the
CPU or the `meta` device, and launches the kernel for a CUDA tensor or
raises. Under `torch.func.vmap` it goes through a `torch.library` custom op
whose vmap rule folds the vmapped axis into M, so a decode step vmapped over
slots (the DecodeServer) launches the kernel once for all slots. `launches`
counts kernel launches and nothing else (not the bf16 rounding of an f32
x), `forms` the same launches by form.
"""

from __future__ import annotations

import torch

from . import _build
from .wgmma_plan import I4_MT, int4_plan

launches = 0
forms = {"wgmma": 0, "mma": 0}
_counters: dict = {}  # device -> the wgmma form's (tile, slab) counters (int32, zeros)

_X_DTYPES = (torch.float32, torch.bfloat16)
_OUT_DTYPES = (torch.float32, torch.bfloat16)


def unpack_int4_half(pk: torch.Tensor) -> torch.Tensor:
    """(K/2, N) int8 half-split nibbles -> (K, N) int8 values in [-8, 7];
    the arithmetic shifts sign-extend the nibbles."""
    return torch.cat([(pk << 4) >> 4, pk >> 4], dim=0)


def int4_matmul_plain(x: torch.Tensor, pk: torch.Tensor, scales: torch.Tensor, *,
                      group: int, out_dtype=torch.float32) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: bf16 x, one f32 dot per
    group of each half, scaled, then summed over the groups."""
    m, k = x.shape
    n = pk.shape[1]
    ng = k // group  # groups over all of K: ngh of each half
    xg = x.to(torch.bfloat16).float().reshape(m, ng, group).transpose(0, 1)
    wg = unpack_int4_half(pk).float().reshape(ng, group, n)
    part = torch.bmm(xg, wg) * scales.float().reshape(ng, 1, n)  # (ng, M, N)
    return (part[: ng // 2] + part[ng // 2:]).sum(0).to(out_dtype)


def _tile_counters(device: torch.device, n: int) -> torch.Tensor:
    """The device's counters, one a (tile, slab of 8 rows): zeros the kernel
    leaves at zero, made once and large enough for llama_1b's prefill (a
    CUDA graph captured later replays with the same buffer)."""
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        buf = _counters[device] = torch.zeros(max(n, 1 << 14), dtype=torch.int32,
                                              device=device)
    return buf


def _launch(x: torch.Tensor, pk: torch.Tensor, scales: torch.Tensor, group: int,
            out_dtype: torch.dtype) -> torch.Tensor:
    global launches
    if x.dim() != 2 or pk.dim() != 2:
        raise ValueError(f"int4_matmul: x {tuple(x.shape)} and pk {tuple(pk.shape)} not 2-D")
    M, K = x.shape
    kh, N = pk.shape
    if K != 2 * kh:
        raise ValueError(f"int4_matmul: x {tuple(x.shape)} and pk {tuple(pk.shape)} "
                         "do not chain")
    if group % 16 or K % (2 * group) or N % 32:
        raise ValueError(f"int4_matmul: needs group % 16, K % (2 group) and N % 32 "
                         f"(group {group}, K {K}, N {N})")
    if x.dtype not in _X_DTYPES or out_dtype not in _OUT_DTYPES:
        raise TypeError(f"int4_matmul: x {x.dtype} -> {out_dtype} not taken")
    if pk.dtype != torch.int8 or scales.dtype != torch.float32 \
            or tuple(scales.shape) != (K // group, N):
        raise TypeError("int4_matmul: pk must be int8 and scales (K/group, N) f32")
    for t in (pk, scales):
        if t.device != x.device:
            raise ValueError("int4_matmul: operands on different devices")
    for t in (x, pk, scales):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("int4_matmul: operands must be contiguous and 16-byte aligned")
    plan = int4_plan(N, K, group)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0:
        return out
    part = counters = None
    whole = plan.whole(M)
    if plan.form == "wgmma":
        if x.dtype != torch.bfloat16:  # the kernel's TMA reads bf16 x
            x = x.to(torch.bfloat16)
        if plan.chunks > 1 and not whole:
            part = torch.empty((plan.chunks, M, N), dtype=torch.float32, device=x.device)
            counters = _tile_counters(x.device, plan.tiles * -(-M // I4_MT))
    lib = _build.library("int4_matmul")
    with torch.cuda.device(x.device):
        rc = lib.smelter_int4_matmul(
            x.data_ptr(), pk.data_ptr(), scales.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            None if counters is None else counters.data_ptr(), M, N, K, group,
            _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[out_dtype], plan.code, plan.chunks,
            int(whole), _build.stream_of(x))
    _build.check(lib, rc, "int4_matmul")
    launches += 1
    forms[plan.form] += 1
    return out


def _call(x, pk, scales, group: int, out_dtype) -> torch.Tensor:
    if x.device.type in ("cpu", "meta"):
        return int4_matmul_plain(x, pk, scales, group=group, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul: no kernel for device {x.device}")
    return _launch(x, pk, scales, group, out_dtype)


@torch.library.custom_op("smelter::int4_matmul", mutates_args=())
def _op(x: torch.Tensor, pk: torch.Tensor, scales: torch.Tensor, group: int,
        out_dtype: torch.dtype) -> torch.Tensor:
    return _call(x, pk, scales, group, out_dtype)


@_op.register_fake
def _(x, pk, scales, group, out_dtype):
    return x.new_empty((x.shape[0], pk.shape[1]), dtype=out_dtype)


def _vmap_rule(info, in_dims, x, pk, scales, group, out_dtype):
    """Fold the vmapped axis into M: one launch for every vmapped row."""
    x_dim, pk_dim, s_dim = in_dims[:3]
    if pk_dim is not None or s_dim is not None:
        raise ValueError("int4_matmul: vmap over the weight or its scales is not taken")
    x = x.movedim(x_dim, 0)
    n, m, k = x.shape
    y = _op(x.reshape(n * m, k).contiguous(), pk, scales, group, out_dtype)
    return y.reshape(n, m, -1), 0


_op.register_vmap(_vmap_rule)


def int4_matmul(x: torch.Tensor, pk: torch.Tensor, scales: torch.Tensor, *,
                group: int, out_dtype=torch.float32) -> torch.Tensor:
    """(M, K) float @ dequant((K/2, N) packed int4, (K/g, N) scales) ->
    (M, N) out_dtype."""
    if _build.vmapped(x, pk, scales):
        return _op(x, pk, scales, int(group), out_dtype)
    return _call(x, pk, scales, int(group), out_dtype)
