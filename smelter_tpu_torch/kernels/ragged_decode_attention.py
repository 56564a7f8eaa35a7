"""Ragged decode attention (each slot's own contiguous KV cache, read only
up to its position).

q in the GQA layout `(B, kvh, g*c, hd)` (query row i at chunk offset
i % c); caches `(B, L, kvh*hd)` in q's dtype, or int8 with per-row scales
`(B, L, 1)` in f32 or q's dtype; pos `(B,)` int64. Query row i of slot b
attends rows <= pos[b] + i % c, with a streaming softmax in f32.

Replaces the Pallas kernel `smelter_tpu/kernels/ragged_decode_attention.py::
ragged_decode_attention` (its batched `_batched`). The Hopper kernel is
`csrc/ragged_decode_attention.cu`, the split-KV kernels of
`csrc/decode_attention.cuh` over contiguous row blocks:

- What bounds it on an H100: the live K/V bytes, (pos + c) rows of K and V
  a slot; ~4 MB a step at llama_1b's shape with 8 slots over 0-511.
- What the design does about it: the cache is cut into blocks of
  `split_plan` rows, so that (row block, KV head, slot) gives a few hundred
  CUDA blocks at one slot as at eight; each reads only its rows up to the
  frontier, K and V of a warp's rows in flight together, and writes a
  partial softmax state (running max, sum, f32 sums) into scratch the
  wrapper allocates; a second launch merges each slot's partials in block
  order. Up to 16 query rows (8 at hd 256) share a block's K/V reads, more
  go in further groups, and a query row's sums run in the same order
  whatever the group's size. A block past the frontier reads nothing (a reused slot's stale
  rows are neither scored nor added). The grid depends on (B, kvh, L), never
  on pos, so a captured decode step replays right at any position.

On a CPU or `meta` tensor `ragged_decode_attention` takes the plain version
(`ragged_decode_attention_reference`, the dense masked attention), and on a
CUDA tensor it launches the kernel or raises. Under `torch.func.vmap` it
goes through a `torch.library` custom op whose vmap rule folds the vmapped
axis into the op's own slot axis, so a batch-1 decode step vmapped over
slots (the DecodeServer) launches the kernel once for all slots, as the
Pallas kernel's `custom_vmap` folds JAX's vmap onto its slot-batched grid.
`launches` counts calls that launched the kernels (two CUDA launches), once
a call.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

launches = 0

_Q_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (32, 64, 128, 256)
_SPLIT_ROWS = 32        # a row block is a multiple of this: 4 warps x 8 rows
_SPLIT_BLOCKS = 8 * 132  # CUDA blocks to aim for: eight an SM of an H100
_SPLIT_MAX = 256         # row blocks a slot at most (the merge walks them in order)


def split_plan(B: int, kvh: int, L: int) -> tuple[int, int]:
    """(rows a block, blocks a slot) of the split kernel for B slots, kvh KV
    heads and caches of L rows: about _SPLIT_BLOCKS CUDA blocks in all, at
    least one row block a slot, at most one per _SPLIT_ROWS rows and
    _SPLIT_MAX, whatever the positions."""
    want = -(-_SPLIT_BLOCKS // max(1, B * kvh))
    blocks = max(1, min(want, -(-L // _SPLIT_ROWS), _SPLIT_MAX))
    rows = -(-(-(-L // blocks)) // _SPLIT_ROWS) * _SPLIT_ROWS
    return rows, -(-L // rows)


def ragged_decode_attention_reference(q, k, v, pos, k_scale=None, v_scale=None, *,
                                      c: int, kv_heads: int, scale: float) -> torch.Tensor:
    """Dense masked attention over a contiguous cache, for one stream (q
    (kvh, g*c, hd), k/v (L, kvd), pos ()) or a batch of them (a leading
    dim on every operand); int8 k/v take per-row scales (L, 1). V rows past
    the frontier pos + c - 1 are taken as zeros, as the Pallas kernel zeros
    them, so a reused cache's stale rows never reach the output."""
    *lead, kvh, gc, hd = q.shape
    L = k.shape[-2]
    g = gc // c
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf = kf * k_scale.float()
        vf = vf * v_scale.float()
    rows = torch.arange(L, device=q.device)
    p0 = pos.reshape(*lead, 1).long()
    vf = torch.where((rows <= p0 + (c - 1))[..., None], vf, 0.0)
    k3 = kf.reshape(*lead, L, kvh, hd)
    v3 = vf.reshape(*lead, L, kvh, hd)
    q4 = q.float().reshape(*lead, kvh, g, c, hd)
    s = torch.einsum("...hgcd,...lhd->...hgcl", q4, k3) * scale
    limit = p0 + torch.arange(c, device=q.device)  # (..., c)
    mask = rows <= limit[..., None]  # (..., c, L)
    s = torch.where(mask[..., None, None, :, :], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("...hgcl,...lhd->...hgcd", p, v3)
    return out.reshape(*lead, kvh, gc, hd).to(q.dtype)


def _check(q, k, v, pos, k_scale, v_scale, c: int, kv_heads: int) -> None:
    bsz, kvh, gc, hd = q.shape
    quant = k_scale is not None
    if k.dim() != 3 or k.shape[0] != bsz or k.shape[2] != kvh * hd or v.shape != k.shape \
            or kvh != kv_heads or tuple(pos.shape) != (bsz,):
        raise ValueError(f"ragged_decode_attention: q {tuple(q.shape)}, caches "
                         f"{tuple(k.shape)} and pos {tuple(pos.shape)} do not match "
                         f"({kv_heads} KV heads)")
    if hd not in _HEAD_DIMS or c < 1 or gc % c:
        raise ValueError(f"ragged_decode_attention: head dim {hd} (of {_HEAD_DIMS}) and "
                         f"g*c {gc} (a multiple of c {c}) not taken")
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"ragged_decode_attention: q {q.dtype} not taken")
    if pos.dtype != torch.int64:
        raise TypeError(f"ragged_decode_attention: pos must be int64, not {pos.dtype}")
    if quant:
        if k.dtype != torch.int8 or v.dtype != torch.int8 or v_scale is None:
            raise TypeError("ragged_decode_attention: scaled caches must be int8")
        if tuple(k_scale.shape) != tuple(k.shape[:2]) + (1,) or v_scale.shape != k_scale.shape \
                or k_scale.dtype not in (torch.float32, q.dtype) \
                or v_scale.dtype != k_scale.dtype:
            raise TypeError("ragged_decode_attention: scales must be (B, L, 1) in f32 or "
                            "q's dtype")
    elif k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("ragged_decode_attention: float caches must hold q's dtype")
    for t in [q, k, v, pos] + ([k_scale, v_scale] if quant else []):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("ragged_decode_attention: operands must be contiguous, on one "
                             "device")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:  # read in vectors
        raise ValueError("ragged_decode_attention: q and the caches must be 16-byte aligned")


def _launch(q, k, v, pos, k_scale, v_scale, c: int, kv_heads: int,
            scale: float) -> torch.Tensor:
    global launches
    _check(q, k, v, pos, k_scale, v_scale, c, kv_heads)
    bsz, kvh, gc, hd = q.shape
    L = k.shape[1]
    quant = k_scale is not None
    rows, nblk = split_plan(bsz, kvh, L)
    out = torch.empty_like(q)
    scratch = torch.empty(bsz * kvh * nblk * gc * (hd + 2), dtype=torch.float32,
                          device=q.device)
    lib = _build.library("ragged_decode_attention")
    with torch.cuda.device(q.device):
        rc = lib.smelter_ragged_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None, pos.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), bsz, L, kvh, hd, gc, c, rows, float(scale),
            _build.DTYPE_CODES[q.dtype],
            _build.DTYPE_CODES[k.dtype], _build.DTYPE_CODES[k_scale.dtype] if quant else 0,
            _build.stream_of(q))
    _build.check(lib, rc, "ragged_decode_attention")
    launches += 1
    return out


def _call(q, k, v, pos, k_scale, v_scale, c: int, kv_heads: int, scale: float):
    if q.device.type in ("cpu", "meta"):
        return ragged_decode_attention_reference(q, k, v, pos, k_scale, v_scale, c=c,
                                                 kv_heads=kv_heads, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_decode_attention: no kernel for device {q.device}")
    return _launch(q, k, v, pos, k_scale, v_scale, c, kv_heads, scale)


@torch.library.custom_op("smelter::ragged_decode_attention", mutates_args=())
def _op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor,
        k_scale: Optional[torch.Tensor], v_scale: Optional[torch.Tensor], c: int,
        kv_heads: int, scale: float) -> torch.Tensor:
    return _call(q, k, v, pos, k_scale, v_scale, c, kv_heads, scale)


@_op.register_fake
def _(q, k, v, pos, k_scale, v_scale, c, kv_heads, scale):
    return torch.empty_like(q)


def _fold(t: Optional[torch.Tensor], dim: Optional[int], n: int) -> Optional[torch.Tensor]:
    """A vmapped operand (n, B, ...) -> (n*B, ...); an unvmapped one (B, ...)
    is repeated n times first."""
    if t is None:
        return None
    t = t.movedim(dim, 0) if dim is not None else t.expand(n, *t.shape)
    return t.reshape(n * t.shape[1], *t.shape[2:]).contiguous()


def _vmap_rule(info, in_dims, q, k, v, pos, k_scale, v_scale, c, kv_heads, scale):
    n = info.batch_size
    ops = [_fold(t, d, n) for t, d in zip((q, k, v, pos, k_scale, v_scale), in_dims[:6])]
    out = _op(*ops, c, kv_heads, scale)
    return out.reshape(n, -1, *out.shape[1:]), 0


_op.register_vmap(_vmap_rule)


def ragged_decode_attention(q, k, v, pos, k_scale=None, v_scale=None, *, c: int,
                            kv_heads: int, scale: float) -> torch.Tensor:
    """Slot-batched ragged attention: q (B, kvh, g*c, hd); caches (B, L,
    kvh*hd) in q's dtype, or int8 with scales (B, L, 1); pos (B,) int64.
    Returns (B, kvh, g*c, hd) in q's dtype."""
    args = (q, k, v, pos, k_scale, v_scale, int(c), int(kv_heads), float(scale))
    if _build.vmapped(q, k, v, pos, k_scale, v_scale):
        return _op(*args)
    return _call(*args)
