"""Stable-Diffusion-style conditional UNet (latent denoiser); the port's
copy of `smelter_tpu/models/sd_unet.py`, exported by the port's own fx
frontend. ResBlocks with GroupNorm+SiLU and sinusoidal-timestep
conditioning, transformer blocks with self- AND cross-attention over a
text context, GEGLU feed-forward, skip-concat decoder.

Only the ZOO form (`build`: timestep and context baked in as constants,
one latent input) is ported; the JAX package's `build_multi` feeds the
timestep as an input, whose Sin/Cos chain the port does not lower yet.
`build_zoo` is the JAX package's `ZOO["sd_unet"]`: the pixel size / 8
latent, base 128, a 16 x 256 context, 8 heads.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class TimestepEmbedding(nn.Module):
    """Sinusoidal embedding computed in-graph (exports as Sin/Cos/Mul)."""

    def __init__(self, dim: int, temb_dim: int):
        super().__init__()
        half = dim // 2
        freqs = torch.exp(
            -math.log(10000.0) * torch.arange(half, dtype=torch.float32) / half)
        self.register_buffer("freqs", freqs)
        self.fc1 = nn.Linear(dim, temb_dim)
        self.fc2 = nn.Linear(temb_dim, temb_dim)

    def forward(self, t):  # t: (B,)
        ang = t[:, None] * self.freqs[None, :]
        emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        return self.fc2(F.silu(self.fc1(emb)))


class ResBlock(nn.Module):
    def __init__(self, inp: int, out: int, temb_dim: int, groups: int = 8):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, inp)
        self.conv1 = nn.Conv2d(inp, out, 3, padding=1)
        self.temb_proj = nn.Linear(temb_dim, out)
        self.norm2 = nn.GroupNorm(groups, out)
        self.conv2 = nn.Conv2d(out, out, 3, padding=1)
        self.skip = nn.Conv2d(inp, out, 1) if inp != out else nn.Identity()

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.temb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return h + self.skip(x)


class CrossAttention(nn.Module):
    """Hand-rolled MHA (supports cross-attention kdim != dim) — exports as
    MatMul/Softmax so the attention-fusion pass can pick it up."""

    def __init__(self, dim: int, ctx_dim: int | None, heads: int):
        super().__init__()
        self.heads = heads
        self.hd = dim // heads  # static (fx-friendly: no proxy floordiv)
        self.dim = dim
        ctx_dim = ctx_dim or dim
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(ctx_dim, dim, bias=False)
        self.to_v = nn.Linear(ctx_dim, dim, bias=False)
        self.to_out = nn.Linear(dim, dim)

    def forward(self, x, ctx=None):
        ctx = x if ctx is None else ctx
        b, n, _ = x.shape
        h, hd = self.heads, self.hd
        q = self.to_q(x).reshape(b, n, h, hd).permute(0, 2, 1, 3)
        k = self.to_k(ctx).reshape(b, ctx.shape[1], h, hd).permute(0, 2, 3, 1)
        v = self.to_v(ctx).reshape(b, ctx.shape[1], h, hd).permute(0, 2, 1, 3)
        attn = torch.softmax(q @ k * hd ** -0.5, dim=-1)
        out = (attn @ v).permute(0, 2, 1, 3).reshape(b, n, self.dim)
        return self.to_out(out)


class TransformerBlock(nn.Module):
    """norm->selfattn->norm->crossattn->norm->GEGLU, all residual."""

    def __init__(self, dim: int, ctx_dim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = CrossAttention(dim, None, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = CrossAttention(dim, ctx_dim, heads)
        self.norm3 = nn.LayerNorm(dim)
        self.ff1 = nn.Linear(dim, dim * 8)
        self.ff2 = nn.Linear(dim * 4, dim)

    def forward(self, x, ctx):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx)
        h = self.ff1(self.norm3(x))
        a, gate = torch.chunk(h, 2, dim=-1)
        return x + self.ff2(a * F.gelu(gate))


class SpatialTransformer(nn.Module):
    def __init__(self, ch: int, ctx_dim: int, heads: int, groups: int = 8):
        super().__init__()
        self.norm = nn.GroupNorm(groups, ch)
        self.proj_in = nn.Conv2d(ch, ch, 1)
        self.block = TransformerBlock(ch, ctx_dim, heads)
        self.proj_out = nn.Conv2d(ch, ch, 1)

    def forward(self, x, ctx):
        b, c, hh, ww = x.shape
        h = self.proj_in(self.norm(x))
        h = h.reshape(b, c, -1).permute(0, 2, 1)
        h = self.block(h, ctx)
        h = h.permute(0, 2, 1).reshape(b, c, hh, ww)
        return x + self.proj_out(h)


class SDUNet(nn.Module):
    def __init__(self, in_ch: int = 4, base: int = 32, ctx_dim: int = 64,
                 heads: int = 4, groups: int = 8):
        super().__init__()
        temb_dim = base * 4
        self.temb = TimestepEmbedding(base, temb_dim)
        self.conv_in = nn.Conv2d(in_ch, base, 3, padding=1)
        # down: base @ full res -> 2*base @ half res
        self.down1_res = ResBlock(base, base, temb_dim, groups)
        self.down1_attn = SpatialTransformer(base, ctx_dim, heads, groups)
        self.downsample = nn.Conv2d(base, base, 3, stride=2, padding=1)
        self.down2_res = ResBlock(base, base * 2, temb_dim, groups)
        self.down2_attn = SpatialTransformer(base * 2, ctx_dim, heads, groups)
        # mid
        self.mid_res1 = ResBlock(base * 2, base * 2, temb_dim, groups)
        self.mid_attn = SpatialTransformer(base * 2, ctx_dim, heads, groups)
        self.mid_res2 = ResBlock(base * 2, base * 2, temb_dim, groups)
        # up
        self.up1_res = ResBlock(base * 4, base * 2, temb_dim, groups)
        self.up1_attn = SpatialTransformer(base * 2, ctx_dim, heads, groups)
        self.up_conv = nn.Conv2d(base * 2, base * 2, 3, padding=1)
        self.up2_res = ResBlock(base * 3, base, temb_dim, groups)
        self.up2_attn = SpatialTransformer(base, ctx_dim, heads, groups)
        self.norm_out = nn.GroupNorm(groups, base)
        self.conv_out = nn.Conv2d(base, in_ch, 3, padding=1)

    def forward(self, x, t, ctx):
        temb = self.temb(t)
        h1 = self.conv_in(x)
        h1 = self.down1_res(h1, temb)
        h1 = self.down1_attn(h1, ctx)              # skip @ full res (base)
        h2 = self.downsample(h1)
        h2 = self.down2_res(h2, temb)
        h2 = self.down2_attn(h2, ctx)              # skip @ half res (2*base)
        m = self.mid_res1(h2, temb)
        m = self.mid_attn(m, ctx)
        m = self.mid_res2(m, temb)
        u = self.up1_res(torch.cat([m, h2], dim=1), temb)
        u = self.up1_attn(u, ctx)
        u = F.interpolate(u, scale_factor=2.0, mode="nearest")
        u = self.up_conv(u)
        u = self.up2_res(torch.cat([u, h1], dim=1), temb)
        u = self.up2_attn(u, ctx)
        return self.conv_out(F.silu(self.norm_out(u)))


class _FixedConditioning(nn.Module):
    """Single-input wrapper: timestep + text context pinned as buffers
    (constants in the export) — the ZOO/bench contract is one input."""

    def __init__(self, unet: SDUNet, t: torch.Tensor, ctx: torch.Tensor):
        super().__init__()
        self.unet = unet
        self.register_buffer("t", t)
        self.register_buffer("ctx", ctx)

    def forward(self, x):
        return self.unet(x, self.t, self.ctx)


def create_torch(batch: int = 1, in_ch: int = 4, base: int = 32, ctx_dim: int = 64,
                 ctx_len: int = 8, heads: int = 4, seed: int = 0) -> _FixedConditioning:
    """The torch module `build` exports: weights, timestep and context from
    `seed`."""
    torch.manual_seed(seed)
    unet = SDUNet(in_ch=in_ch, base=base, ctx_dim=ctx_dim, heads=heads).eval()
    t = torch.full((batch,), 42.0)
    ctx = torch.randn(batch, ctx_len, ctx_dim)
    return _FixedConditioning(unet, t, ctx).eval()


def build(batch: int = 1, image_size: int = 16, in_ch: int = 4,
          base: int = 32, ctx_dim: int = 64, ctx_len: int = 8,
          heads: int = 4, seed: int = 0, **_):
    """ZOO form: (graph, torch_module, input_shape) with fixed timestep /
    context baked as constants. image_size is the LATENT resolution (the
    ZOO lambda divides pixel size by 8, SD-style)."""
    from ..frontend.torch_export import export_torch

    m = create_torch(batch, in_ch, base, ctx_dim, ctx_len, heads, seed)
    shape = (batch, in_ch, image_size, image_size)
    g = export_torch(m, (torch.randn(*shape),), name="sd_unet")
    return g, m, shape


ZOO_KW = {"base": 128, "ctx_dim": 256, "ctx_len": 16, "heads": 8}


def build_zoo(batch: int = 1, image_size: int = 256, **kw):
    """`smelter_tpu.models.ZOO["sd_unet"]`: image_size is the PIXEL size;
    the latent UNet runs at image_size / 8 (at least 8)."""
    return build(batch=batch, image_size=max(8, image_size // 8), **{**ZOO_KW, **kw})
