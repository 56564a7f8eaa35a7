"""Streaming-softmax attention: softmax(q k^T * scale) v over q (B, H, Nq,
hd) and k, v (B, H, Nk, hd), non-causal; Nq and Nk may differ.

Arithmetic follows the Pallas kernel: q, k and v in f32, f32 scores times
scale, an f32 softmax whose sum is taken over the unrounded exponentials,
p V in f32, the output in q's dtype. The Hopper kernels round p to the
16-bit operand type before p V (the Pallas kernel keeps it in f32): on the
card a bf16 output differs from the plain version by a few bf16 steps.

Replaces the Pallas kernel `smelter_tpu/kernels/flash_attention.py::
_flash_attention_impl`. The Hopper kernel is `csrc/flash_attention.cu`:

- What bounds it on an H100: at ViT-B/16 384 px (B 64, H 12, N 577, hd 64)
  the bytes by a hair (227 MB, 68 us at 3.35 TB/s, against 65.5 GFLOP);
  at B 2, H 12, N 4096 the tensor cores (103 GFLOP, 104 us).
- What the design does about it: bf16/f16 at hd 32, 64, 128 run the
  streaming form of `csrc/wgmma_attention.cuh` in one call (no f32 state in
  device memory): a CTA takes 128 query rows of a (batch, head), a producer
  thread brings Q once and K and V in 128-key tiles by TMA through 4-D maps
  of their strides into a ring of stages, two consumer warpgroups run S = Q
  K^T and P V on wgmma and keep the running max, sum and f32 accumulator in
  registers, and the output goes out through q's strides. At hd <= 64 the
  next tile's scores and softmax overlap this tile's P V; a positive scale
  is folded into the exponent. `attention_plan.flash_plan` picks the form;
  what it does not take (f32 in full f32, other head dims, strides or bases
  a TMA map cannot take) keeps the file's mma.sync kernel (hd 16) or its
  warp-per-query-row kernel.

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

from . import _build, attention_plan

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


def plan(q, k, v, out) -> attention_plan.AttnPlan:
    """The form `flash_attention` takes for these CUDA operands (each with a
    contiguous last axis) and its output."""
    B, H, Nq, hd = q.shape
    strides = [[t.stride(0), t.stride(1), t.stride(2)] for t in (q, k, v, out)]
    return attention_plan.flash_plan(B, H, Nq, k.shape[2], hd, strides, q.dtype,
                                     aligned=_build.aligned16(q, k, v, out))


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
    form = plan(q, k, v, out)
    lib = _build.library("flash_attention")
    with torch.cuda.device(q.device):
        rc = lib.smelter_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Nq, k.shape[2], hd,
            *qs, *ks, *vs, *strided(out)[1], float(scale), _build.DTYPE_CODES[q.dtype],
            form.code, _build.stream_of(q))
    _build.check(lib, rc, "flash_attention")
    launches += 1
    return out
