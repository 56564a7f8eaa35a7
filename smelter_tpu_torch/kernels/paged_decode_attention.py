"""Paged decode attention (a block-paged KV pool shared by all slots).

K/V live in one pool of fixed-size pages per layer, `(P, page_size, kvd)`,
and each slot owns a row of the page table: logical row j*ps + r of slot b
is row r of pool page `table[b, j]`. A slot's query rows (GQA layout
`(B, kvh, g*c, hd)`, row i at chunk offset i % c) attend its logical rows
<= pos + i % c. Pools are float in q's dtype, or int8 with per-row scale
pools `(P, ps, 1)`.

Replaces the Pallas kernel `smelter_tpu/kernels/paged_decode_attention.py::
paged_decode_attention`. The Hopper kernels are
`csrc/paged_decode_attention.cu`, the split-KV pair of
`csrc/decode_attention.cuh` over blocks of pool rows:

- What bounds it on an H100: the live K/V bytes, ceil((pos+c)/ps) pages a
  slot and of the last page only the rows up to the frontier; ~4 MB a step
  at llama_1b's shape with positions spread over 0-511.
- What the design does about it: `paged_split_plan` cuts each page into
  blocks of a multiple of 32 rows (a whole page where ps is not one), so
  that (row block, KV head, slot) gives about 8 x 132 CUDA blocks; each
  reads only its rows up to the frontier, from the page the table names,
  and writes a partial softmax state (running max, sum, f32 sums) into
  scratch the wrapper allocates; a second launch merges each slot's
  partials in block order. No slot's cache is ever gathered out of the
  pool. The plan reads (B, kvh, npg, ps), never pos or the table, so a
  captured step replays right at any position.

Beside it, in plain PyTorch: `paged_cache_update` (not a kernel in the JAX
package either: a c-row scatter) and `paged_gather_reference`, which with
the dense masked `ragged_decode_attention_reference`
(`kernels/ragged_decode_attention.py`) are the plain version of the
attention. `paged_gather_reference` clamps a table entry into the pool, as
the kernels (and the Pallas kernel's block fetch) do. `paged_decode_attention`
takes the plain version for a tensor on the CPU or the `meta` device, and
launches the kernels for a CUDA tensor or raises. `launches` counts calls
that launched the kernels (two CUDA launches), once a call.
"""

from __future__ import annotations

import functools

import torch

from . import _build
from .ragged_decode_attention import _SPLIT_BLOCKS, _SPLIT_ROWS, ragged_decode_attention_reference

launches = 0

_Q_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (32, 64, 128, 256)


@functools.lru_cache(maxsize=256)  # planned on every call of a decode step
def paged_split_plan(B: int, kvh: int, npg: int, ps: int) -> tuple[int, int, int]:
    """(rows a block, blocks a page, blocks a slot) of the split kernel for
    B slots, kvh KV heads and npg pages of ps rows a slot: the fewest blocks
    a page that reach about _SPLIT_BLOCKS CUDA blocks in all, each block a
    multiple of _SPLIT_ROWS rows that divides the page (the whole page where
    ps is not a multiple of _SPLIT_ROWS), whatever the positions and the
    table."""
    units = ps // _SPLIT_ROWS if ps % _SPLIT_ROWS == 0 else 1
    want = -(-_SPLIT_BLOCKS // max(1, B * kvh * npg))
    split = next((d for d in range(1, units + 1) if units % d == 0 and d >= want), units)
    return ps // split, split, npg * split


def paged_cache_update(pool: torch.Tensor, page_table: torch.Tensor, pos: torch.Tensor,
                       rows: torch.Tensor) -> torch.Tensor:
    """Write `rows` (B, c, kvd) at logical positions pos..pos+c-1 of each
    slot into the paged pool (P, ps, kvd), IN PLACE, and return the pool.

    The JAX package returns a new pool and its server donates the old one;
    writing in place is the same to every reader and copies nothing. Dead
    slots write too: the server points their table rows at a scratch page."""
    P_, ps, kvd = pool.shape
    c = rows.shape[1]
    npg = page_table.shape[1]
    lpos = pos.reshape(-1, 1).long() + torch.arange(c, device=pool.device)[None]  # (B, c)
    pg = torch.gather(page_table.long(), 1, torch.clamp(lpos // ps, 0, npg - 1))
    idx = (pg * ps + lpos % ps).reshape(-1)
    src = rows.reshape(-1, kvd).to(pool.dtype)
    pool.view(P_ * ps, kvd).index_copy_(0, idx, src)
    return pool


def paged_gather_reference(pool: torch.Tensor, page_table: torch.Tensor,
                           n_rows: int) -> torch.Tensor:
    """Slot caches (B, n_rows, kvd) gathered from the pool (the plain
    version only; the kernel never does this)."""
    P_, ps, kvd = pool.shape
    lrow = torch.arange(n_rows, device=pool.device)
    pg = page_table.long()[:, lrow // ps].clamp(0, P_ - 1)  # (B, n)
    idx = pg * ps + (lrow % ps)[None]
    return pool.reshape(P_ * ps, kvd)[idx]


def paged_decode_attention_plain(q, k_pool, v_pool, page_table, pos, k_scale=None,
                                 v_scale=None, *, c: int, kv_heads: int,
                                 scale: float) -> torch.Tensor:
    """The plain version: gather every slot's npg pages, then the dense
    masked reference."""
    n = page_table.shape[1] * k_pool.shape[1]
    kd = paged_gather_reference(k_pool, page_table, n)
    vd = paged_gather_reference(v_pool, page_table, n)
    ksd = vsd = None
    if k_scale is not None:
        ksd = paged_gather_reference(k_scale, page_table, n)
        vsd = paged_gather_reference(v_scale, page_table, n)
    return ragged_decode_attention_reference(q, kd, vd, pos.reshape(-1), ksd, vsd, c=c,
                                             kv_heads=kv_heads, scale=scale)


def _check(q, k_pool, v_pool, page_table, pos, k_scale, v_scale, c: int,
           kv_heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Raise for operands the kernels do not take; return the table as
    (B, npg) int32 and pos as (B,) int64."""
    bsz, kvh, gc, hd = q.shape
    P_, ps, kvd = k_pool.shape
    quant = k_scale is not None
    if kvh != kv_heads or kvd != kvh * hd or v_pool.shape != k_pool.shape \
            or page_table.numel() != bsz * page_table.shape[-1] or pos.numel() != bsz:
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}, table {tuple(page_table.shape)} and pos "
                         f"{tuple(pos.shape)} do not match ({kv_heads} KV heads)")
    if hd not in _HEAD_DIMS or c < 1 or gc % c:
        raise ValueError(f"paged_decode_attention: head dim {hd} (of {_HEAD_DIMS}) and "
                         f"g*c {gc} (a multiple of c {c}) not taken")
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"paged_decode_attention: q {q.dtype} not taken")
    if quant:
        if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8 or v_scale is None:
            raise TypeError("paged_decode_attention: scaled pools must be int8")
        if tuple(k_scale.shape) != (P_, ps, 1) or v_scale.shape != k_scale.shape \
                or k_scale.dtype not in (torch.float32, q.dtype) \
                or v_scale.dtype != k_scale.dtype:
            raise TypeError("paged_decode_attention: scale pools must be (P, ps, 1) in f32 "
                            "or q's dtype")
    elif k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("paged_decode_attention: float pools must hold q's dtype")
    table = page_table.reshape(bsz, page_table.shape[-1]).to(torch.int32)
    pos = pos.reshape(bsz).to(torch.int64)
    for t in [q, k_pool, v_pool, table, pos] + ([k_scale, v_scale] if quant else []):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("paged_decode_attention: operands must be contiguous, on one "
                             "device")
    if q.data_ptr() % 16 or k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:  # vectors
        raise ValueError("paged_decode_attention: q and the pools must be 16-byte aligned")
    return table, pos


def paged_decode_attention(q, k_pool, v_pool, page_table, pos, k_scale=None, v_scale=None,
                           *, c: int, kv_heads: int, scale: float) -> torch.Tensor:
    """Slot-batched paged attention: q (B, kvh, g*c, hd); pools (P, ps,
    kvh*hd) in q's dtype, or int8 with scale pools (P, ps, 1); page_table
    (B, npg) int32; pos (B,) int. Returns (B, kvh, g*c, hd) in q's dtype."""
    global launches
    if q.device.type in ("cpu", "meta"):
        return paged_decode_attention_plain(q, k_pool, v_pool, page_table, pos, k_scale,
                                            v_scale, c=c, kv_heads=kv_heads, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for device {q.device}")
    bsz, kvh, gc, hd = q.shape
    P_, ps, _ = k_pool.shape
    npg = page_table.shape[-1]
    quant = k_scale is not None
    table, pos = _check(q, k_pool, v_pool, page_table, pos, k_scale, v_scale, c, kv_heads)
    _, split, nblk = paged_split_plan(bsz, kvh, npg, ps)
    out = torch.empty_like(q)
    scratch = torch.empty(bsz * kvh * nblk * gc * (hd + 2), dtype=torch.float32,
                          device=q.device)
    lib = _build.library("paged_decode_attention")
    with torch.cuda.device(q.device):
        rc = lib.smelter_paged_decode_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
            table.data_ptr(), pos.data_ptr(), out.data_ptr(), scratch.data_ptr(), bsz, P_, ps,
            kvh, hd, gc, c, npg, split, float(scale), _build.DTYPE_CODES[q.dtype],
            _build.DTYPE_CODES[k_pool.dtype],
            _build.DTYPE_CODES[k_scale.dtype] if quant else 0, _build.stream_of(q))
    _build.check(lib, rc, "paged_decode_attention")
    launches += 1
    return out
