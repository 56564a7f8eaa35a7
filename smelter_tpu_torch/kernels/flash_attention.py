"""Streaming-softmax attention: softmax(q k^T * scale) v over q (B, H, Nq,
hd) and k, v (B, H, Nk, hd), non-causal; Nq and Nk may differ.

Arithmetic follows the Pallas kernel: q, k and v in f32, f32 scores times
scale, an f32 softmax whose sum is taken over the unrounded exponentials,
p V in f32, the output in q's dtype. The Hopper kernel rounds p to the
16-bit operand type before p V (the Pallas kernel keeps it in f32): on the
card a bf16 output differs from the plain version by a few bf16 steps.

Replaces the Pallas kernel `smelter_tpu/kernels/flash_attention.py::
_flash_attention_impl`. The Hopper kernel is `csrc/flash_attention.cu` on
the pieces of `csrc/attention.cuh`:

- What bounds it on an H100: at ViT-B/16 384 px (B 64, H 12, N 577, hd 64)
  the bytes by a hair (227 MB, 68 us at 3.35 TB/s, against 65.5 GFLOP);
  at B 2, H 12, N 4096 the tensor cores (103 GFLOP, 104 us).
- What the simple design does about it: one block of 4 warps a (batch,
  head, 64 query rows) keeps the running max, sum and f32 accumulator in
  registers while K and V stream through a two-stage cp.async ring in
  shared memory, so no score reaches device memory; mma.sync with f32
  accumulation. f32 (in full f32), other head dims and unaligned rows take
  a warp-per-query-row kernel.

Operands are read through their strides (the head dim contiguous), so the
(B, H, N, hd) views of (B, N, H, hd) tensors that a graph's Reshape ->
Transpose produces are not copied, and the output takes q's strides
(`torch.empty_like`), so the graph's Transpose -> Reshape back is a view.

On a CPU or `meta` tensor `flash_attention` takes the plain version
(`flash_attention_plain`); on a CUDA tensor it launches the kernel or
raises. `launches` counts kernel launches and nothing else.
"""

from __future__ import annotations

import torch

from . import _build

launches = 0

X_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
MAX_HD = 256  # the warp-per-row kernel's head dim (csrc/attention.cuh)


def flash_attention_plain(q, k, v, *, scale: float = 1.0) -> torch.Tensor:
    """The Pallas kernel's arithmetic in plain PyTorch, over whole rows:
    exp(s - max) V / sum(exp(s - max)) in f32."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhqk,bhkd->bhqd", e, v.float()) / e.sum(-1, keepdim=True)
    return o.to(q.dtype)


def check_operands(name: str, q, k, v) -> None:
    """Raise for operands the attention kernels do not take."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} are not (B, H, Nq, hd) and (B, H, Nk, hd)")
    if q.dtype not in X_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v {q.dtype}, {k.dtype}, {v.dtype} not taken (one of "
                        f"{X_DTYPES})")
    if q.shape[3] > MAX_HD or k.shape[2] == 0:
        raise ValueError(f"{name}: head dim {q.shape[3]} > {MAX_HD} or no keys")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: operands on different devices")


def strided(t: torch.Tensor) -> tuple[torch.Tensor, list[int]]:
    """t with a contiguous last axis (a copy only where it is not), and its
    batch, head and row strides in elements."""
    if t.stride(3) != 1:
        t = t.contiguous()
    st = [t.stride(0), t.stride(1), t.stride(2)]
    if max(st) >= 2 ** 31:
        raise ValueError(f"attention: strides {st} do not fit the kernel's int32")
    return t, st


def flash_attention(q, k, v, *, scale: float = 1.0) -> torch.Tensor:
    """Attention over q (B, H, Nq, hd), k and v (B, H, Nk, hd); returns (B,
    H, Nq, hd) in q's dtype."""
    global launches
    if q.device.type in ("cpu", "meta"):
        return flash_attention_plain(q, k, v, scale=scale)
    check_operands("flash_attention", q, k, v)
    (q, qs), (k, ks), (v, vs) = strided(q), strided(k), strided(v)
    out = torch.empty_like(q)
    B, H, Nq, hd = q.shape
    lib = _build.library("flash_attention")
    with torch.cuda.device(q.device):
        rc = lib.smelter_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Nq, k.shape[2], hd,
            *qs, *ks, *vs, *strided(out)[1], float(scale), _build.DTYPE_CODES[q.dtype],
            _build.stream_of(q))
    _build.check(lib, rc, "flash_attention")
    launches += 1
    return out
