"""ConvNeXt-style modern CNN (ConvNeXt-T shapes by default: dims
96/192/384/768, depths 3/3/9/3, 1000 classes); the port's copy of
`smelter_tpu/models/convnext.py`, exported by the port's own fx frontend.
Depthwise 7x7 convs, channels-last LayerNorm, inverted-bottleneck MLP with
GELU, learnable layer scale. `passes/vit_block.py::fuse_convnext_block`
folds a block into one `ConvNeXtBlock` (kernels/convnext_block.py) when
it is run explicitly.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, ls_init: float = 1e-6):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pw1 = nn.Linear(dim, 4 * dim)
        self.pw2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(ls_init * torch.ones(dim))

    def forward(self, x):  # (B, C, H, W)
        h = self.dwconv(x)
        h = h.permute(0, 2, 3, 1)          # channels-last
        h = self.norm(h)
        h = self.pw2(F.gelu(self.pw1(h)))
        h = self.gamma * h
        return x + h.permute(0, 3, 1, 2)


class ConvNeXt(nn.Module):
    def __init__(self, in_ch: int = 3, num_classes: int = 1000,
                 dims=(96, 192, 384, 768), depths=(3, 3, 9, 3)):
        super().__init__()
        self.stem = nn.Conv2d(in_ch, dims[0], 4, stride=4)
        self.stem_norm = nn.LayerNorm(dims[0], eps=1e-6)
        stages = []
        downs = []
        for i, (d, n) in enumerate(zip(dims, depths)):
            stages.append(nn.ModuleList([ConvNeXtBlock(d) for _ in range(n)]))
            if i < len(dims) - 1:
                downs.append(nn.Sequential(
                    _ChannelsLastLN(d), nn.Conv2d(d, dims[i + 1], 2, stride=2)))
        self.stages = nn.ModuleList(stages)
        self.downs = nn.ModuleList(downs)
        self.head_norm = nn.LayerNorm(dims[-1], eps=1e-6)
        self.head = nn.Linear(dims[-1], num_classes)

    def forward(self, x):
        x = self.stem(x)
        x = self.stem_norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        for i, blocks in enumerate(self.stages):
            for b in blocks:
                x = b(x)
            if i < len(self.downs):
                x = self.downs[i](x)
        x = x.mean(dim=(2, 3))  # global average pool
        return self.head(self.head_norm(x))


class _ChannelsLastLN(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x):
        return self.norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def create_torch(seed: int = 0, num_classes: int = 1000, dims=(96, 192, 384, 768),
                 depths=(3, 3, 9, 3)) -> ConvNeXt:
    """The torch module `build` exports, with weights from `seed`."""
    torch.manual_seed(seed)
    return ConvNeXt(num_classes=num_classes, dims=tuple(dims), depths=tuple(depths)).eval()


def build(batch: int = 1, image_size: int = 224, num_classes: int = 1000,
          dims=(96, 192, 384, 768), depths=(3, 3, 9, 3), seed: int = 0,
          **_):
    """ZOO contract: (graph, torch_module, input_shape)."""
    from ..frontend.torch_export import export_torch

    m = create_torch(seed, num_classes, dims, depths)
    shape = (batch, 3, image_size, image_size)
    g = export_torch(m, (torch.randn(*shape),), name="convnext")
    return g, m, shape
