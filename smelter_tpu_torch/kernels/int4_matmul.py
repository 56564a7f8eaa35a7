"""Grouped int4 dequant + matmul over half-split packed nibbles (decode).

`out = sum_kb (x_lo[:, kb] @ lo_kb) * s[kb] + (x_hi[:, kb] @ hi_kb) * s[ngh + kb]`,
with x (M, K) rounded to bf16 first (also when it is f32), pk (K/2, N) int8
whose row r holds w[r] in its low nibble and w[r + K/2] in its high nibble
(`passes/fuse_dequant.py::pack_int4_half`), and scales (K/g, N) f32: row kb
for group kb of the low half, row ngh + kb for group kb of the high half
(ngh = K/2/g). Each group's dot is summed in f32 and scaled there; the
output is the f32 sum, returned in `out_dtype`.

Replaces the Pallas kernel `smelter_tpu/kernels/int4_matmul.py::
int4_matmul`. The Hopper kernel is `csrc/int4_matmul.cu`:

- What bounds it on an H100: the weight bytes. At decode (M = 8 slots)
  K*N/2 bytes of nibbles and K*N/g*4 of scales, 1.1 MB (N 1024, K 2048) to
  35 MB (N 32000, K 2048) a call; the tensor-core work is a hundredth of
  that.
- What the simple design does about it: the nibbles go from HBM straight
  into mma.sync B fragments as bf16 (a mask, an xor and a subtraction per
  two values), so W crosses HBM as 4 bits. One block of 8 warps per 32
  output columns, the warps sharing out the K groups and adding their sums
  in a fixed order: a row's result does not depend on M or the other rows.
  At N 1024 and 2048 that fills 32 and 64 of 132 SMs; a cluster K split
  that fills them was measured slower (the calls are latency-bound).

The JAX package's CPU composite (`smelter_tpu/ops/fused_ops.py:288-291`)
keeps x in f32; this module follows its Pallas kernel, which rounds x to
bf16. `int4_matmul` takes the plain PyTorch version for a tensor on the
CPU or the `meta` device, and launches the kernel for a CUDA tensor or
raises. Under `torch.func.vmap` it goes through a `torch.library` custom op
whose vmap rule folds the vmapped axis into M, so a decode step vmapped over
slots (the DecodeServer) launches the kernel once for all slots. `launches`
counts kernel launches and nothing else.
"""

from __future__ import annotations

import torch

from . import _build

launches = 0

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
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0:
        return out
    lib = _build.library("int4_matmul")
    with torch.cuda.device(x.device):
        rc = lib.smelter_int4_matmul(
            x.data_ptr(), pk.data_ptr(), scales.data_ptr(), out.data_ptr(), M, N, K, group,
            _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[out_dtype], _build.stream_of(x))
    _build.check(lib, rc, "int4_matmul")
    launches += 1
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
