"""ViT for image classification written as Hugging Face `transformers` writes
it (`ViTForImageClassification`): a test model, not a feature of either
package.

The layout is the library's: separate `query` / `key` / `value` Linears
with biases, `view` + `permute(0, 2, 1, 3)` into heads, `matmul / sqrt(hd)`,
softmax, `matmul`, then `permute` + `view` back (`ViTSelfAttention`), or
`F.scaled_dot_product_attention` (`ViTSdpaSelfAttention`, `sdpa=True`);
pre-LN layers with exact GELU and LayerNorm eps 1e-12; the class token's
final LayerNorm row into the classifier. Shapes are static, so that the fx
exporters of both packages take it.

`VIT_B16_224` and `VIT_B16_384` are the published widths of
`google/vit-base-patch16-224` and `google/vit-base-patch16-384`. Weights are
random, from a numpy seed: Linear and conv weights normal with std
1/sqrt(fan_in), biases and the class and position embeddings std 0.02,
LayerNorm gamma 1 + N(0, 0.1) and beta N(0, 0.1). Nothing is downloaded.

This file imports neither JAX nor either package.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

VIT_B16_224 = dict(image_size=224, patch=16, dim=768, depth=12, heads=12, mlp=3072,
                   num_classes=1000)
VIT_B16_384 = dict(VIT_B16_224, image_size=384)
EPS = 1e-12


class ViTSelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int, batch: int, tokens: int, sdpa: bool):
        super().__init__()
        self.heads, self.hd = heads, dim // heads
        self.shape = (batch, tokens, heads, self.hd)
        self.out_shape = (batch, tokens, dim)
        self.sdpa = sdpa
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)

    def transpose_for_scores(self, x):
        return x.view(self.shape).permute(0, 2, 1, 3)

    def forward(self, x):
        q = self.transpose_for_scores(self.query(x))
        k = self.transpose_for_scores(self.key(x))
        v = self.transpose_for_scores(self.value(x))
        if self.sdpa:
            ctx = F.scaled_dot_product_attention(q, k, v)
        else:
            scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(self.hd)
            ctx = torch.matmul(F.softmax(scores, dim=-1), v)
        return ctx.permute(0, 2, 1, 3).contiguous().view(self.out_shape)


class ViTLayer(nn.Module):
    def __init__(self, dim: int, heads: int, mlp: int, batch: int, tokens: int, sdpa: bool):
        super().__init__()
        self.layernorm_before = nn.LayerNorm(dim, eps=EPS)
        self.attention = ViTSelfAttention(dim, heads, batch, tokens, sdpa)
        self.attention_output = nn.Linear(dim, dim)
        self.layernorm_after = nn.LayerNorm(dim, eps=EPS)
        self.intermediate = nn.Linear(dim, mlp)
        self.output = nn.Linear(mlp, dim)

    def forward(self, x):
        x = self.attention_output(self.attention(self.layernorm_before(x))) + x
        h = F.gelu(self.intermediate(self.layernorm_after(x)))
        return self.output(h) + x


class ViTForImageClassification(nn.Module):
    def __init__(self, batch: int, image_size: int, patch: int, dim: int, depth: int,
                 heads: int, mlp: int, num_classes: int, sdpa: bool = False):
        super().__init__()
        tokens = (image_size // patch) ** 2 + 1
        self.batch, self.dim = batch, dim
        self.patch_embeddings = nn.Conv2d(3, dim, patch, patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.position_embeddings = nn.Parameter(torch.zeros(1, tokens, dim))
        self.layer = nn.Sequential(*[ViTLayer(dim, heads, mlp, batch, tokens, sdpa)
                                     for _ in range(depth)])
        self.layernorm = nn.LayerNorm(dim, eps=EPS)
        self.classifier = nn.Linear(dim, num_classes)

    def forward(self, pixel_values):
        x = self.patch_embeddings(pixel_values).flatten(2).transpose(1, 2)
        cls = self.cls_token.expand(self.batch, 1, self.dim)
        x = torch.cat([cls, x], dim=1) + self.position_embeddings
        x = self.layernorm(self.layer(x))
        return self.classifier(x[:, 0])


def create(batch: int = 1, seed: int = 0, sdpa: bool = False, **cfg) -> nn.Module:
    """The model in eval mode with weights from numpy seed `seed`; `cfg`
    defaults to VIT_B16_224."""
    cfg = {**VIT_B16_224, **cfg}
    m = ViTForImageClassification(batch, sdpa=sdpa, **cfg).eval()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("weight") and p.dim() > 1:
                std = 1.0 / math.sqrt(p[0].numel())
                val = rng.standard_normal(p.shape) * std
            elif "layernorm" in name and name.endswith("weight"):
                val = 1 + 0.1 * rng.standard_normal(p.shape)
            elif "layernorm" in name:
                val = 0.1 * rng.standard_normal(p.shape)
            else:
                val = 0.02 * rng.standard_normal(p.shape)
            p.copy_(torch.from_numpy(val.astype(np.float32)))
    return m


def input_shape(batch: int, image_size: int = 224, **_) -> tuple[int, int, int, int]:
    return (batch, 3, image_size, image_size)
