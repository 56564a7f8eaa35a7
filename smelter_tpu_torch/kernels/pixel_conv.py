"""3x3 / stride 1 / pad 1 convolution of (B, H, C, W) ("NHCW") activations:
`pixel_conv_rowdot` in f32, bf16 or f16, and `pixel_conv_rowdot_q` on int8
activations and weights with the dequant -> bias -> LeakyReLU -> requant
epilogue; `pixel_conv_blockdot` (rowdot's function on a taller tile) and
`pixel_conv_patch` (rowdot's function on flat NCHW, (B, C, H*W)).

    out[b, h, co, w] = epilogue(sum over dy, dx, ci of
                                W[co, ci, dy, dx] * x[b, h+dy-1, ci, w+dx-1])

with zeros outside the map. `pixel_conv_rowdot` casts the weight to x's
dtype, sums in f32, adds the f32 bias, applies LeakyReLU (alpha; alpha 0 is
ReLU; None is linear) and rounds once to x's dtype. `pixel_conv_rowdot_q`
sums int8 products exactly in int32, converts the sum to f32, multiplies it
by scales[co] and adds bias[co] as two roundings (no fused multiply-add),
applies LeakyReLU, then either rounds acc * inv_sy half to even and clips it
to [-127, 127] as int8 (requant) or casts to `out_dtype`.

Replaces the Pallas kernels `smelter_tpu/kernels/pixel_conv.py::
pixel_conv_rowdot`, `::pixel_conv_rowdot_q`, `::pixel_conv_blockdot` and
`::pixel_conv_patch`. The Hopper kernels are one entry point of
`csrc/pixel_conv.cu`, which reads and writes the maps at the batch, row and
channel strides it is given (W contiguous), so `pixel_conv_patch` launches
rowdot's and blockdot's device code on NCHW with no layout copy:

- What bounds them on an H100: at ESRGAN's trunk convs (batch 8, 128 x 128,
  C_in 64-192, C_out 32/64) the bf16 tensor cores and HBM nearly tie: about
  4.7 TFLOP and 16 GB over the 349 convs of a forward, ~4.7 ms and ~4.9 ms at
  the data sheet's peaks; int8 halves both.
- 16-bit `pixel_conv_rowdot` runs the wgmma form (`csrc/wgmma_conv.cuh`)
  where `wgmma_plan.pixel_plan` takes the shape (C_out 32 or 64, rows of
  16-byte pixel chunks; ESRGAN's eight shapes): a persistent,
  warp-specialised implicit GEMM with the pixels on M and C_out on N. TMA
  brings each K step's 16 channels of 6 input rows into shared memory; the
  producer warpgroup transposes them into a K-major copy, so that the dx
  taps are 16-byte offsets of wgmma's A operand (an MN-major operand, or a
  TMA box, cannot start one pixel off); the weight stays resident in shared
  memory where it fits, else comes a step at a time; the output leaves by a
  TMA store. Two consumer warpgroups of two output rows run wgmma m64n32 or
  m64n64 over the 9 taps.
- 16-bit `pixel_conv_blockdot` runs the same core with the Pallas
  variant's point, a taller row block, where `pixel_plan(..., tall=True)`
  takes it: two consumer warpgroups of four output rows, 10 staged input
  rows for 8 output rows (1.25 an output row against 1.5), so each K
  step's box, copy and weights feed twice the products; its x boxes land
  in a ring of their own, so that three to five stages fit; the rows leave
  two a warpgroup at a time through the same staging tiles. The plan takes
  it at C_out 32 with C_in >= 96, where it ran 3-7 % under the 4-row tile
  on the card; the rest (C_out 64, where it ran slower; C_in 64; H below
  its 10-row box) takes the 4-row tile.
- `pixel_conv_rowdot_q` with int8 or 16-bit out runs the same design on
  int8 wgmma (`csrc/wgmma_conv_s8.cuh`) where `pixel_plan` takes the shape
  (also C_out 32 or 64; rows of 16-pixel chunks, C_in % 16; ESRGAN's eight
  shapes): K steps of 32 channels summed exactly in int32, a 96-pixel x box
  (its first pixel 16-byte aligned) transposed by the producer warps into
  16-channel rows, the weight resident where it fits, and the epilogue below
  before a TMA store of int8 or 16-bit rows.
- 16-bit `pixel_conv_patch` runs the same core on flat NCHW where
  `patch_plan` takes it (blockdot's tile rule, and the wgmma form's shape
  checks at NCHW strides: ESRGAN's eight shapes): the x map and the store
  map are 4-D views (W, C, H, B) at strides (hw, W, C hw), so a staged
  box is 16 channel planes of rows and a stored box of 64 pixels x C_out
  channels is C_out runs of 128 bytes, `hw` apart. No layout copy.
- Everything else (f32, which keeps a full-f32 FMA kernel, no TF32; other
  C_out; strides or bases TMA cannot take; rowdot_q with f32 out) runs the
  mma.sync implicit GEMM: a block of 2 (blockdot: 4) output rows x 128
  pixels x 64 channels, the input rows staged in shared memory transposed
  to [pixel][channel] so that the dx taps are row offsets, both operands
  read by ldmatrix (m16n8k16 bf16/f16, m16n8k32 s8). The Pallas kernels' `rows` (a TPU tiling) is accepted and
  not read, and H need not divide into it.

The kernel reads the weight as [3, 3, C_out, C_in]: `weights.params_from_numpy`
stores the graph's PixelConv weights so (an OIHW view over that buffer),
once, when params go to the device; another layout is copied per call.

A CPU or `meta` tensor takes the plain versions (`pixel_conv_rowdot_plain`,
`pixel_conv_rowdot_q_plain`, `pixel_conv_blockdot_plain`,
`pixel_conv_patch_plain`); a CUDA tensor launches the kernel at any B, H,
W, C_in and C_out, or raises for operands it does not take. `launches`,
`q_launches`, `blockdot_launches` and `patch_launches` count each entry
point's launches and nothing else.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build, wgmma_plan

launches = 0
q_launches = 0
blockdot_launches = 0
patch_launches = 0
patch_forms = {"wgmma": 0, "mma": 0}  # pixel_conv_patch's launches by plan form

_X_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _leaky(y: torch.Tensor, alpha) -> torch.Tensor:
    return y if alpha is None else torch.where(y >= 0, y, y * float(alpha))


def pixel_conv_rowdot_plain(x, w, bias, *, alpha=None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: a conv of the NCHW view in
    f32 on the weight rounded to x's dtype, the f32 bias, LeakyReLU, one
    rounding to x's dtype."""
    y = F.conv2d(x.permute(0, 2, 1, 3).float(), w.to(x.dtype).float(), padding=1)
    y = _leaky(y + bias.float().reshape(1, -1, 1, 1), alpha)
    return y.to(x.dtype).permute(0, 2, 1, 3).contiguous()


# pixel_conv_blockdot computes pixel_conv_rowdot's function on its layout.
pixel_conv_blockdot_plain = pixel_conv_rowdot_plain


def pixel_conv_patch_plain(x, w, bias, *, width: int, alpha=None) -> torch.Tensor:
    """`pixel_conv_rowdot_plain`'s arithmetic on flat NCHW: x (B, C_in, H*W)
    with rows of `width` pixels, out (B, C_out, H*W)."""
    B, C, hw = x.shape
    y = F.conv2d(x.reshape(B, C, hw // width, width).float(), w.to(x.dtype).float(), padding=1)
    y = _leaky(y + bias.float().reshape(1, -1, 1, 1), alpha)
    return y.to(x.dtype).reshape(B, -1, hw)


def pixel_conv_rowdot_q_plain(x, w_q, scales, bias, *, alpha=None, inv_sy: float = 1.0,
                              requant: bool = True, out_dtype=torch.bfloat16) -> torch.Tensor:
    """The int8 kernel's arithmetic in plain PyTorch. The int8 products are
    summed in f64, where every sum (|sum| < 2^53) is exact, so the sums are
    the kernel's int32 sums; the epilogue's multiply and add are two ops."""
    acc = F.conv2d(x.permute(0, 2, 1, 3).double(), w_q.double(), padding=1).float()
    y = _leaky(acc * scales.float().reshape(1, -1, 1, 1) + bias.float().reshape(1, -1, 1, 1),
               alpha)
    if requant:
        y = torch.clamp(torch.round(y * float(inv_sy)), -127, 127).to(torch.int8)
    else:
        y = y.to(out_dtype)
    return y.permute(0, 2, 1, 3).contiguous()


def _packed_weight(w: torch.Tensor) -> torch.Tensor:
    """w (C_out, C_in, 3, 3) as the kernel's contiguous [3, 3, C_out, C_in]."""
    wp = w.permute(2, 3, 0, 1)
    return wp if wp.is_contiguous() else wp.contiguous()


def _device_ok(x) -> bool:
    """Whether x lies where the plain versions run (CPU, `meta`); raises for
    a device with no kernel."""
    if x.device.type in ("cpu", "meta"):
        return True
    if x.device.type != "cuda":
        raise ValueError(f"pixel_conv: no kernel for device {x.device}")
    return False


def _check(x, w, vecs, what: str, cin_dim: int = 2):
    """Shapes, devices and sizes; x is NHCW (C_in at dim 2) or flat NCHW
    (B, C_in, H*W) (C_in at dim 1)."""
    if (x.dim() != cin_dim + 2 or w.dim() != 4
            or tuple(w.shape[1:]) != (x.shape[cin_dim], 3, 3)):
        layout = "(B, H, C_in, W)" if cin_dim == 2 else "(B, C_in, H*W)"
        raise ValueError(f"{what}: x {tuple(x.shape)} {layout} and w "
                         f"{tuple(w.shape)} (C_out, C_in, 3, 3) do not fit")
    for v in vecs:
        if v.numel() != w.shape[0]:
            raise ValueError(f"{what}: per-channel vectors must hold C_out = {w.shape[0]}")
    for t in (w,) + tuple(vecs):
        if t.device != x.device:
            raise ValueError(f"{what}: operands must lie on one device")
    if x.numel() >= 2 ** 31 or x.numel() // max(w.shape[1], 1) * w.shape[0] >= 2 ** 31:
        raise ValueError(f"{what}: tensors of 2^31 elements or more are not taken")


def _launch(x, wp, bias, scales, out, alpha, inv_sy: float, requant: bool, *,
            dims=None, x_strides=None, out_strides=None, tall: bool = False, p=None):
    """dims (B, H, C_in, W, C_out) and the (batch, row, channel) element
    strides of x and out; by default those of contiguous NHCW maps. p: a
    `wgmma_plan.PixelPlan` (default: the mma.sync / FMA kernels); a wgmma
    plan's tile height goes with it. tall: the mma.sync / FMA kernels' 4-row
    blocks."""
    if dims is None:
        dims = tuple(x.shape) + (out.shape[2],)
        x_strides, out_strides = x.stride()[:3], out.stride()[:3]
    lib = _build.library("pixel_conv")
    with torch.cuda.device(x.device):
        rc = lib.smelter_pixel_conv(
            x.data_ptr(), wp.data_ptr(), bias.data_ptr(),
            None if scales is None else scales.data_ptr(), out.data_ptr(),
            *dims, *x_strides, *out_strides, _build.DTYPE_CODES[x.dtype],
            _build.DTYPE_CODES[bias.dtype], _build.DTYPE_CODES[out.dtype],
            0.0 if alpha is None else float(alpha), int(alpha is not None), float(inv_sy),
            int(requant), int(tall), 0 if p is None else p.code, 0 if p is None else p.grid,
            0 if p is None else p.stages, 0 if p is None else p.rows, _build.stream_of(x))
    _build.check(lib, rc, "pixel_conv")


def _float_operands(x, w, bias, what: str, cin_dim: int = 2):
    """The float forms' checks; bias as the kernel reads it."""
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"{what}: x {x.dtype} not taken")
    bias = bias.reshape(-1)
    _check(x, w, (bias,), what, cin_dim)
    if bias.dtype not in (torch.float32, x.dtype):
        raise TypeError(f"{what}: bias {bias.dtype} is neither f32 nor x's dtype")
    return bias.contiguous()


def _name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def plan(x, w, out=None, wp=None, *, out_dtype=None, tall: bool = False
         ) -> wgmma_plan.PixelPlan:
    """The kernel `pixel_conv_rowdot` (int8 x: `pixel_conv_rowdot_q`; tall:
    `pixel_conv_blockdot`) launches for NHCW x (B, H, C_in, W) and w (C_out,
    C_in, 3, 3), out in out's dtype, else `out_dtype`, else x's (rowdot_q:
    int8 under requant, else its out_dtype); `out` and `wp` (the packed
    weight) join the alignment check where given."""
    B, H, C, W = x.shape
    bases = [t for t in (x, out, wp) if t is not None]
    od = out.dtype if out is not None else out_dtype or x.dtype
    return wgmma_plan.pixel_plan(B, H, W, C, w.shape[0], x.stride()[:3], _name(x.dtype),
                                 out_dtype=_name(od), aligned=_build.aligned16(*bases),
                                 sms=_build.sms(x.device), tall=tall)


def patch_plan(x, w, width: int, out=None, wp=None) -> wgmma_plan.PixelPlan:
    """The kernel `pixel_conv_patch` launches for flat NCHW x (B, C_in, H*W)
    of rows of `width` pixels: `pixel_plan(..., tall=True)` (blockdot's
    tile rule) on dims (B, H, C_in, W) at x's strides (C_in hw, W, hw) and
    out's (C_out hw, W, hw); `out` and `wp` join the alignment check where
    given."""
    B, C, hw = x.shape
    cout = w.shape[0]
    bases = [t for t in (x, out, wp) if t is not None]
    return wgmma_plan.pixel_plan(B, hw // width, width, C, cout, (C * hw, width, hw),
                                 _name(x.dtype), aligned=_build.aligned16(*bases),
                                 sms=_build.sms(x.device), tall=True,
                                 out_strides=(cout * hw, width, hw))


def _nhcw(x, w, bias, alpha, tall: bool, what: str) -> torch.Tensor:
    bias = _float_operands(x, w, bias, what)
    x = x.contiguous()
    out = torch.empty((x.shape[0], x.shape[1], w.shape[0], x.shape[3]), dtype=x.dtype,
                      device=x.device)
    wp = _packed_weight(w.to(x.dtype))
    p = plan(x, w, out, wp, tall=tall)
    _launch(x, wp, bias, None, out, alpha, 1.0, False, tall=tall and p.code == 0, p=p)
    return out


def pixel_conv_rowdot(x, w, bias, *, alpha=None) -> torch.Tensor:
    """x (B, H, C_in, W) f32/bf16/f16; w (C_out, C_in, 3, 3); bias (C_out,)
    in f32 or x's dtype. Returns (B, H, C_out, W) in x's dtype."""
    global launches
    if _device_ok(x):
        return pixel_conv_rowdot_plain(x, w, bias, alpha=alpha)
    out = _nhcw(x, w, bias, alpha, False, "pixel_conv_rowdot")
    launches += 1
    return out


def pixel_conv_blockdot(x, w, bias, *, alpha=None, rows: int = 16) -> torch.Tensor:
    """`pixel_conv_rowdot`'s contract on a taller tile (the Pallas variant's
    one dot a row block): `plan(..., tall=True)` picks 8 or 4 output rows;
    `rows` is not read."""
    global blockdot_launches
    del rows
    if _device_ok(x):
        return pixel_conv_blockdot_plain(x, w, bias, alpha=alpha)
    out = _nhcw(x, w, bias, alpha, True, "pixel_conv_blockdot")
    blockdot_launches += 1
    return out


def pixel_conv_patch(x, w, bias, *, width: int, alpha=None, rows: int = 8) -> torch.Tensor:
    """x (B, C_in, H*W) flat NCHW of an (H, width) map, f32/bf16/f16; w
    (C_out, C_in, 3, 3); bias (C_out,) in f32 or x's dtype. Returns
    (B, C_out, H*W) in x's dtype; `rows` is not read. A contiguous x is read
    where it lies: one kernel, no layout copy."""
    global patch_launches
    del rows
    if x.dim() != 3 or width <= 0 or x.shape[2] % width:
        raise ValueError(f"pixel_conv_patch: x {tuple(x.shape)} is no (B, C_in, H*W) map "
                         f"of rows of {width} pixels")
    if _device_ok(x):
        return pixel_conv_patch_plain(x, w, bias, width=width, alpha=alpha)
    bias = _float_operands(x, w, bias, "pixel_conv_patch", cin_dim=1)
    x = x.contiguous()
    B, C, hw = x.shape
    cout = w.shape[0]
    out = torch.empty((B, cout, hw), dtype=x.dtype, device=x.device)
    wp = _packed_weight(w.to(x.dtype))
    p = patch_plan(x, w, width, out, wp)
    _launch(x, wp, bias, None, out, alpha, 1.0, False, dims=(B, hw // width, C, width, cout),
            x_strides=(C * hw, width, hw), out_strides=(cout * hw, width, hw), p=p)
    patch_launches += 1
    patch_forms[p.form] += 1
    return out


def pixel_conv_rowdot_q(x, w_q, scales, bias, *, alpha=None, inv_sy: float = 1.0,
                        requant: bool = True, out_dtype=torch.bfloat16) -> torch.Tensor:
    """x (B, H, C_in, W) int8; w_q (C_out, C_in, 3, 3) int8; scales and bias
    (C_out,). Returns (B, H, C_out, W): int8 under requant, else out_dtype
    (f32, bf16 or f16)."""
    global q_launches
    if _device_ok(x):
        return pixel_conv_rowdot_q_plain(x, w_q, scales, bias, alpha=alpha, inv_sy=inv_sy,
                                         requant=requant, out_dtype=out_dtype)
    if x.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"pixel_conv_rowdot_q: x {x.dtype} and w {w_q.dtype} must be int8")
    if not requant and out_dtype not in _X_DTYPES:
        raise TypeError(f"pixel_conv_rowdot_q: out_dtype {out_dtype} not taken")
    scales, bias = scales.reshape(-1), bias.reshape(-1)
    _check(x, w_q, (scales, bias), "pixel_conv_rowdot_q")
    x = x.contiguous()
    out = torch.empty((x.shape[0], x.shape[1], w_q.shape[0], x.shape[3]),
                      dtype=torch.int8 if requant else out_dtype, device=x.device)
    wp = _packed_weight(w_q)
    _launch(x, wp, bias.float().contiguous(), scales.float().contiguous(), out, alpha, inv_sy,
            requant, p=plan(x, w_q, out, wp))
    q_launches += 1
    return out
