"""ViT-B/16 (BASELINE.json configs[4]); the port's copy of
`smelter_tpu/models/vit.py`, exported by the port's own fx frontend.
Attention written with explicit
reshape/transpose/matmul/softmax so the fx exporter emits plain ONNX ops —
the same graph shape a standard torch.onnx ViT export produces. The class
token / position embeddings ride through get_attr initializers."""

from __future__ import annotations

import torch
import torch.nn as nn


class MHA(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.head_dim = dim // heads
        self.scale = self.head_dim ** -0.5
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        # x: (B, N, D). Static shapes only (fx-friendly).
        qkv = self.qkv(x)  # (B, N, 3D)
        b, n, _ = qkv.shape
        qkv = qkv.reshape(b, n, 3, self.heads, self.head_dim)
        qkv = qkv.permute(2, 0, 3, 1, 4)  # (3, B, H, N, hd)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.matmul(q, k.transpose(-2, -1)) * self.scale
        attn = attn.softmax(dim=-1)
        out = torch.matmul(attn, v)  # (B, H, N, hd)
        out = out.transpose(1, 2).reshape(b, n, self.heads * self.head_dim)
        return self.proj(out)


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MHA(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        hidden = int(dim * mlp_ratio)
        self.mlp = nn.Sequential(
            nn.Linear(dim, hidden), nn.GELU(), nn.Linear(hidden, dim))

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    def __init__(self, image_size=224, patch=16, dim=768, depth=12, heads=12,
                 num_classes=1000, mlp_ratio=4.0):
        super().__init__()
        n_patches = (image_size // patch) ** 2
        self.patch_embed = nn.Conv2d(3, dim, patch, patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_patches + 1, dim))
        self.blocks = nn.Sequential(*[Block(dim, heads, mlp_ratio) for _ in range(depth)])
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.head = nn.Linear(dim, num_classes)
        self._batch = 1  # pinned at export; expand() needs static shape

    def forward(self, x):
        x = self.patch_embed(x)  # (B, D, H/p, W/p)
        x = x.flatten(2)  # (B, D, N)
        x = x.transpose(1, 2)  # (B, N, D)
        cls = self.cls_token.expand(self._batch, 1, x.shape[2])
        x = torch.cat([cls, x], dim=1)
        x = x + self.pos_embed
        x = self.blocks(x)
        x = self.norm(x)
        x = x[:, 0]
        return self.head(x)


def create_torch(seed: int = 0, image_size: int = 224, patch: int = 16,
                 dim: int = 768, depth: int = 12, heads: int = 12,
                 num_classes: int = 1000) -> nn.Module:
    torch.manual_seed(seed)
    m = ViT(image_size, patch, dim, depth, heads, num_classes).eval()
    with torch.no_grad():
        m.cls_token.normal_(0, 0.02)
        m.pos_embed.normal_(0, 0.02)
    return m


def build(batch: int = 1, image_size: int = 224, seed: int = 0, patch: int = 16,
          dim: int = 768, depth: int = 12, heads: int = 12, num_classes: int = 1000):
    from ..frontend.torch_export import export_torch

    m = create_torch(seed, image_size, patch, dim, depth, heads, num_classes)
    m._batch = batch
    example = torch.randn(batch, 3, image_size, image_size)
    g = export_torch(m, example, name="vit_b16", opset=17)
    return g, m, (batch, 3, image_size, image_size)
