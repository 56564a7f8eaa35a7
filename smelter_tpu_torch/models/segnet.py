"""SegNet-style encoder-decoder segmentation net; the port's copy of
`smelter_tpu/models/segnet.py`, exported by the port's own fx frontend.
Max-pooling with saved
indices on the way down, MaxUnpool on the way up (no skip concats — the
indices ARE the skip information). Exercises the MaxPool-2-output +
MaxUnpool lowerings end-to-end through the fx frontend. Outside the
reference's op set (Sources/Smelter/Converters.swift has pools but no
unpool); included as the canonical consumer of the MaxUnpool envelope op.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class ConvBNReLU(nn.Sequential):
    def __init__(self, inp, out):
        super().__init__(
            nn.Conv2d(inp, out, 3, padding=1, bias=False),
            nn.BatchNorm2d(out),
            nn.ReLU(inplace=False),
        )


class SegNet(nn.Module):
    def __init__(self, in_ch=3, num_classes=2, base=32, depth=3):
        super().__init__()
        enc, dec = [], []
        chans = [in_ch] + [base * (2 ** i) for i in range(depth)]
        for i in range(depth):
            enc.append(ConvBNReLU(chans[i], chans[i + 1]))
        for i in reversed(range(depth)):
            dec.append(ConvBNReLU(chans[i + 1],
                                  chans[i] if i > 0 else chans[1]))
        self.enc = nn.ModuleList(enc)
        self.dec = nn.ModuleList(dec)
        self.head = nn.Conv2d(chans[1], num_classes, 1)
        self.depth = depth

    def forward(self, x):
        indices, sizes = [], []
        for blk in self.enc:
            x = blk(x)
            sizes.append(x.shape)
            x, idx = F.max_pool2d(x, 2, 2, return_indices=True)
            indices.append(idx)
        for blk in self.dec:
            idx = indices.pop()
            size = sizes.pop()
            x = F.max_unpool2d(x, idx, 2, 2, output_size=size[2:])
            x = blk(x)
        return self.head(x)


def create_torch(seed: int = 0, num_classes: int = 2, base: int = 32,
                 depth: int = 3) -> nn.Module:
    torch.manual_seed(seed)
    m = SegNet(num_classes=num_classes, base=base, depth=depth).eval()
    with torch.no_grad():
        g = torch.Generator().manual_seed(seed)
        for mod in m.modules():
            if isinstance(mod, nn.BatchNorm2d):
                mod.running_mean.copy_(
                    torch.randn(mod.num_features, generator=g) * 0.1)
                mod.running_var.copy_(
                    torch.rand(mod.num_features, generator=g) + 0.5)
    return m


def build(batch: int = 1, image_size: int = 128, seed: int = 0,
          num_classes: int = 2, base: int = 32, depth: int = 3):
    from ..frontend.torch_export import export_torch

    m = create_torch(seed, num_classes, base, depth)
    example = torch.randn(batch, 3, image_size, image_size)
    g = export_torch(m, example, name="segnet", opset=17)
    return g, m, (batch, 3, image_size, image_size)
