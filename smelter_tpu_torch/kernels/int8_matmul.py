"""int8 x int8 -> int32 matmul with a scaled epilogue.

`out = float(x_q @ w_q) * s_row[m] * s_col[n]`, with x_q (M, K) int8,
w_q (K, N) int8, s_row (M, 1) f32 and s_col (N,) f32. `dequant_matmul_int8`
puts float activations in front of it: `quantize_rows` (plain PyTorch, as it
was plain XLA) quantizes each row to int8 with its own scale.

Replaces the Pallas kernel `smelter_tpu/kernels/int8_matmul.py::
_int8_matmul_impl`. The Hopper kernel is `csrc/int8_matmul.cu` on the int8
forms of the wgmma/TMA core `csrc/wgmma_gemm.cuh`:

- What bounds it on an H100: HBM at the ResNet-50 head (M 128, K 2048,
  N 1000: ~2.6 MB moved, ~0.77 us), the int8 tensor cores at the serving
  GEMM (M 8192, K 4096, N 4096: ~275 GOP, ~139 us).
- What the design does about it: `wgmma_plan.int8_plan` picks the form
  from the shape. Where there are tiles enough to fill the card (the
  serving GEMM) the persistent TMA kernel runs the product transposed on
  wgmma.m64n128k32 s8: 8-bit wgmma reads shared operands K-major only, so
  W^T is its register operand, gathered from the TMA-loaded W box with
  2-byte loads and byte permutes, and x's box is B. Otherwise (the head's
  16 tiles; any unaligned shape) a K split over a cluster of up to 8 CTAs,
  W transposed on its way into shared memory, the int32 partials summed in
  rank order through distributed shared memory: 128 CTAs at the head, not
  16. The int32 sum is exact and the scales multiply it once, after it.

`dequant_matmul_int8_fused` and `dequant_matmul_int8_fused2` compute
`dequant_matmul_int8`'s function in one kernel that quantizes x as it
stages it (`csrc/int8_matmul_fused.cu`), in place of the Pallas kernels
`_int8_matmul_fused_impl` (a BM x K int8 panel quantized once in VMEM,
then swept against every N tile) and `_int8_matmul_fused2_impl`
(quantize-on-revisit: each output tile quantizes the x tiles it stages).
`dequant_matmul_int8_fused` runs the int8 wgmma core's design
(`wgmma_plan.fused_plan`): the "panel" form keeps a 128-row panel of x,
quantized once, resident in shared memory, its K split over a cluster of
4 or 8 CTAs (128 x 4,096 int8 bytes do not fit one CTA), and sweeps N
tiles against it with W by TMA as wgmma's register operand; the ranks add
the int32 sums of each other's rows into their owners' shared memory. x
crosses device memory once as floats. The shapes it turns down take
`_fused2`'s forms (`wgmma_plan.revisit_plan`). No K is refused.
`dequant_matmul_int8_fused2` is quantize-on-revisit, as its Pallas kernel:
a row's int32 accumulator across N (2 MB at 128 rows and N 4,096) fits no
SM, so each output tile quantizes the x boxes it stages and x is reread
through L2. The "revisit" form (aligned shapes with tiles enough: the
serving GEMM) is a persistent kernel, one CTA an SM, TMA loading x's float
boxes and W's int8 boxes into a ring; its warps quantize each x box into
wgmma's K-major int8 B operand without a division (Markstein's
correction of x times the row's reciprocal gives `quantize_rows`' IEEE
quotient exactly), then the consumers run `int8_matmul`'s product on it,
W^T the register operand, on tiles of 256 W columns where they fill the
card (x quantized once every 256 columns), else 128. What bounds it: the
int8 tensor cores at the serving GEMM (~139 us) in principle; on the
card the quantizing (CUDA cores, each x value once every 256 columns)
sets its pace. The "cluster" form (few tiles: the head) quantizes x as
each 128 x 64 tile loads it, K split over up to 8 CTAs. The "mma" form
(the mma.sync kernel) takes the rest: N % 16, an unaligned base.
The per-row scales stay plain PyTorch, as they were plain XLA. The Pallas
entries' block sizes are accepted and not read; the JAX `fused` entry's
fall-back to the two-pass path on unaligned M or K (a Mosaic rule) is not
copied: the kernels mask every edge.

Each wrapper takes the plain PyTorch version for a tensor on the CPU or the
`meta` device, and launches its kernel for a CUDA tensor or raises.
`launches`, `fused_launches` and `fused2_launches` count kernel launches
and nothing else; `fused_forms` and `fused2_forms` split the last two by
form.
"""

from __future__ import annotations

import torch

from . import _build, wgmma_plan

launches = 0
fused_launches = 0
fused2_launches = 0
# launches by form: dequant_matmul_int8_fused's and dequant_matmul_int8_fused2's
fused_forms = {"panel": 0, "cluster": 0, "revisit": 0, "mma": 0}
fused2_forms = {"cluster": 0, "revisit": 0, "mma": 0}

_OUT_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int32)


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization: (x_q int8, s_row f32 (M, 1)).
    s = max(absmax, 1e-30) / 127 and q = clip(round(x / s), -127, 127),
    rounding half to even; the division is kept, not a reciprocal."""
    xf = x.float()
    s = quantize_rows_scales(xf)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def quantize_rows_scales(x: torch.Tensor) -> torch.Tensor:
    """`quantize_rows`' scales alone, f32 (M, 1): max(absmax, 1e-30) / 127."""
    # |x| and its max are exact in every float type: convert only the max
    return torch.clamp_min(x.abs().amax(dim=-1, keepdim=True).float(), 1e-30) / 127.0


def int8_matmul_plain(x_q: torch.Tensor, w_q: torch.Tensor,
                      row_scales: torch.Tensor, col_scales: torch.Tensor,
                      *, out_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch. The int32 sum is taken in
    float64, which is exact here (|sum| <= 127 * 127 * K < 2**53) and runs
    on every device; out_dtype=int32 returns it as it is."""
    acc = torch.matmul(x_q.double(), w_q.double()).to(torch.int32)
    if out_dtype == torch.int32:
        return acc
    return (acc.float() * row_scales.float()
            * col_scales.float()[None, :]).to(out_dtype)


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, row_scales: torch.Tensor,
                col_scales: torch.Tensor, *, out_dtype=torch.bfloat16) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> int32 sum -> * s_row * s_col -> out_dtype
    (int32: the raw sum)."""
    global launches
    if x_q.device.type in ("cpu", "meta"):
        return int8_matmul_plain(x_q, w_q, row_scales, col_scales,
                                 out_dtype=out_dtype)
    if x_q.device.type != "cuda":
        raise ValueError(f"int8_matmul: no kernel for device {x_q.device}")
    M, K = x_q.shape
    if w_q.dim() != 2 or w_q.shape[0] != K:
        raise ValueError(f"int8_matmul: x_q {tuple(x_q.shape)} and w_q "
                         f"{tuple(w_q.shape)} do not chain")
    N = w_q.shape[1]
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError("int8_matmul: x_q and w_q must be int8")
    if row_scales.dtype != torch.float32 or row_scales.numel() != M \
            or col_scales.dtype != torch.float32 or col_scales.numel() != N:
        raise TypeError("int8_matmul: scales must be f32 (M, 1) and (N,)")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"int8_matmul: out_dtype {out_dtype} not taken")
    ops = (x_q, w_q, row_scales, col_scales)
    if any(t.device != x_q.device for t in ops):
        raise ValueError("int8_matmul: operands on different devices")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("int8_matmul: operands must be contiguous")
    out = torch.empty((M, N), dtype=out_dtype, device=x_q.device)
    if M == 0 or N == 0:
        return out
    p = plan(x_q, w_q)
    lib = _build.library("int8_matmul")
    with torch.cuda.device(x_q.device):
        rc = lib.smelter_int8_matmul(
            x_q.data_ptr(), w_q.data_ptr(), row_scales.data_ptr(),
            col_scales.data_ptr(), out.data_ptr(), M, N, K,
            _build.DTYPE_CODES[out_dtype], p.code, p.split, p.k_chunk, p.grid,
            _build.stream_of(x_q))
    _build.check(lib, rc, "int8_matmul")
    launches += 1
    return out


def plan(x_q: torch.Tensor, w_q: torch.Tensor) -> wgmma_plan.Plan:
    """The wgmma form `int8_matmul` launches for these (CUDA) operands."""
    return wgmma_plan.int8_plan(x_q.shape[0], w_q.shape[1], x_q.shape[1],
                                aligned=_build.aligned16(x_q, w_q), sms=_build.sms(x_q.device))


def int32_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 summed in int32: `torch._int_mm` on the card
    (which takes K and N multiples of 8 and M above 16: fewer rows are
    padded with zeros), else in float64, which is exact here."""
    M, K = x_q.shape
    N = w_q.shape[1]
    if x_q.device.type == "cuda" and K % 8 == 0 and N % 8 == 0:
        if M <= 16:
            x_q = torch.nn.functional.pad(x_q, (0, 0, 0, 17 - M))
        return torch._int_mm(x_q, w_q)[:M]
    return torch.matmul(x_q.double(), w_q.double()).to(torch.int32)


def dequant_matmul_int8_reference(x: torch.Tensor, w_q: torch.Tensor,
                                  scales: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """The composite FusedDequantMatMul takes under `int8_activations`
    without `Config.use_pallas`, as the JAX package's
    `dequant_matmul_int8_xla`: `quantize_rows`, an int32-accumulating int8
    matmul, and the scaled epilogue in f32."""
    x_q, s_row = quantize_rows(x)
    acc = int32_matmul(x_q, w_q)
    return (acc.float() * s_row * scales.float().reshape(1, -1)).to(out_dtype or x.dtype)


def dequant_matmul_int8(x: torch.Tensor, w_q: torch.Tensor,
                        scales: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """Float activations, int8 weights with per-N scales: quantize the rows,
    then the int8 kernel."""
    x_q, s_row = quantize_rows(x)
    return int8_matmul(x_q, w_q, s_row, scales, out_dtype=out_dtype or x.dtype)


def dequant_matmul_int8_fused_plain(x: torch.Tensor, w_q: torch.Tensor, scales: torch.Tensor,
                                    *, out_dtype=None) -> torch.Tensor:
    """The fused kernels' arithmetic in plain PyTorch: `quantize_rows`, then
    `int8_matmul_plain` (an exact int32 sum, `acc * s_row * s_col`)."""
    x_q, s_row = quantize_rows(x)
    return int8_matmul_plain(x_q, w_q, s_row, scales, out_dtype=out_dtype or x.dtype)


def fused_plan(x: torch.Tensor, w_q: torch.Tensor, *, fused2: bool = False
               ) -> wgmma_plan.FusedPlan:
    """The form `dequant_matmul_int8_fused` (`fused2`: `_fused2`) launches
    for these (CUDA) operands: `wgmma_plan.fused_plan` (`revisit_plan`) on
    x's shape, value size and base."""
    choose = wgmma_plan.revisit_plan if fused2 else wgmma_plan.fused_plan
    return choose(x.shape[0], w_q.shape[1], x.shape[1], x.element_size(),
                  aligned=_build.aligned16(x, w_q), sms=_build.sms(x.device))


def _fused(x, w_q, scales, out_dtype, what: str, fused2: bool = False) -> torch.Tensor:
    """Checks, the row scales (plain PyTorch), and one launch of the form
    `fused_plan` names, counted by form."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if x.dim() != 2 or w_q.dim() != 2 or w_q.shape[0] != x.shape[1]:
        raise ValueError(f"{what}: x {tuple(x.shape)} and w_q {tuple(w_q.shape)} do not chain")
    M, K = x.shape
    N = w_q.shape[1]
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16) or w_q.dtype != torch.int8:
        raise TypeError(f"{what}: x {x.dtype} (f32, bf16 or f16) and w_q {w_q.dtype} (int8)")
    if out_dtype not in (torch.float32, x.dtype):
        raise TypeError(f"{what}: out_dtype {out_dtype} is neither f32 nor x's dtype")
    if scales.numel() != N or any(t.device != x.device for t in (w_q, scales)):
        raise ValueError(f"{what}: scales must hold N = {N}, on x's device")
    x, w_q = x.contiguous(), w_q.contiguous()
    s_row = quantize_rows_scales(x)
    s_col = scales.float().reshape(-1).contiguous()
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    p = fused_plan(x, w_q, fused2=fused2)
    _launch(x, w_q, s_row, s_col, out, p, what)
    (fused2_forms if fused2 else fused_forms)[p.form] += 1
    return out


def _launch(x, w_q, s_row, s_col, out, p: wgmma_plan.FusedPlan, what: str) -> None:
    """One launch of the form `p` names on checked, contiguous operands."""
    M, K = x.shape
    lib = _build.library("int8_matmul_fused")
    with torch.cuda.device(x.device):
        rc = lib.smelter_int8_matmul_fused(
            x.data_ptr(), w_q.data_ptr(), s_row.data_ptr(), s_col.data_ptr(), out.data_ptr(),
            M, w_q.shape[1], K, _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[out.dtype],
            p.code, p.split, p.k_chunk, p.stages, p.cols, p.grid, _build.stream_of(x))
    _build.check(lib, rc, what)


def dequant_matmul_int8_fused(x: torch.Tensor, w_q: torch.Tensor, scales: torch.Tensor, *,
                              block_m: int = 512, block_n: int = 1024, block_k: int = 1024,
                              out_dtype=None) -> torch.Tensor:
    """`dequant_matmul_int8`'s function, x (M, K) f32/bf16/f16, w_q (K, N)
    int8, scales (N,): one kernel that quantizes x as it loads it
    (`fused_plan`: on int8 wgmma into a resident panel quantized once a
    cluster; else `_fused2`'s forms). The block arguments are not read."""
    global fused_launches
    del block_m, block_n, block_k
    if x.device.type in ("cpu", "meta"):
        return dequant_matmul_int8_fused_plain(x, w_q, scales, out_dtype=out_dtype)
    out = _fused(x, w_q, scales, out_dtype or x.dtype, "dequant_matmul_int8_fused")
    fused_launches += 1
    return out


def dequant_matmul_int8_fused2(x: torch.Tensor, w_q: torch.Tensor, scales: torch.Tensor, *,
                               block_m: int = 256, block_n: int = 1024, block_k: int = 1024,
                               out_dtype=None) -> torch.Tensor:
    """`dequant_matmul_int8`'s function in one kernel whose output tiles
    quantize the x tiles they stage (quantize-on-revisit; `revisit_plan`:
    the persistent TMA-fed int8 wgmma kernel where its maps can read the
    operands, the cluster form for few tiles, else the mma.sync kernel).
    The block arguments are not read."""
    global fused2_launches
    del block_m, block_n, block_k
    if x.device.type in ("cpu", "meta"):
        return dequant_matmul_int8_fused_plain(x, w_q, scales, out_dtype=out_dtype)
    out = _fused(x, w_q, scales, out_dtype or x.dtype, "dequant_matmul_int8_fused2", fused2=True)
    fused2_launches += 1
    return out
