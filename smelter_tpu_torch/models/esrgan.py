"""ESRGAN-style super-resolution net; the port's copy of
`smelter_tpu/models/esrgan.py`, exported by the port's own fx frontend.
RRDBNet generator: residual-
in-residual dense blocks, LeakyReLU, nearest-neighbor 2x upsampling tail.
Dense blocks chain Concat ops — together with big spatial convs this is the
stress config for the concat + upsample paths."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class DenseBlock(nn.Module):
    def __init__(self, nf=64, gc=32):
        super().__init__()
        self.conv1 = nn.Conv2d(nf, gc, 3, 1, 1)
        self.conv2 = nn.Conv2d(nf + gc, gc, 3, 1, 1)
        self.conv3 = nn.Conv2d(nf + 2 * gc, gc, 3, 1, 1)
        self.conv4 = nn.Conv2d(nf + 3 * gc, gc, 3, 1, 1)
        self.conv5 = nn.Conv2d(nf + 4 * gc, nf, 3, 1, 1)
        self.lrelu = nn.LeakyReLU(0.2, inplace=False)

    def forward(self, x):
        x1 = self.lrelu(self.conv1(x))
        x2 = self.lrelu(self.conv2(torch.cat([x, x1], 1)))
        x3 = self.lrelu(self.conv3(torch.cat([x, x1, x2], 1)))
        x4 = self.lrelu(self.conv4(torch.cat([x, x1, x2, x3], 1)))
        x5 = self.conv5(torch.cat([x, x1, x2, x3, x4], 1))
        return x + x5 * 0.2


class RRDB(nn.Module):
    def __init__(self, nf=64, gc=32):
        super().__init__()
        self.db1 = DenseBlock(nf, gc)
        self.db2 = DenseBlock(nf, gc)
        self.db3 = DenseBlock(nf, gc)

    def forward(self, x):
        out = self.db3(self.db2(self.db1(x)))
        return x + out * 0.2


class RRDBNet(nn.Module):
    def __init__(self, in_ch=3, out_ch=3, nf=64, nb=4, gc=32, scale=4):
        super().__init__()
        assert scale in (2, 4)
        self.scale = scale
        self.conv_first = nn.Conv2d(in_ch, nf, 3, 1, 1)
        self.body = nn.Sequential(*[RRDB(nf, gc) for _ in range(nb)])
        self.conv_body = nn.Conv2d(nf, nf, 3, 1, 1)
        self.upconv1 = nn.Conv2d(nf, nf, 3, 1, 1)
        self.upconv2 = nn.Conv2d(nf, nf, 3, 1, 1) if scale == 4 else None
        self.conv_hr = nn.Conv2d(nf, nf, 3, 1, 1)
        self.conv_last = nn.Conv2d(nf, out_ch, 3, 1, 1)
        self.lrelu = nn.LeakyReLU(0.2, inplace=False)

    def forward(self, x):
        feat = self.conv_first(x)
        feat = feat + self.conv_body(self.body(feat))
        feat = self.lrelu(self.upconv1(
            F.interpolate(feat, scale_factor=2, mode="nearest")))
        if self.upconv2 is not None:
            feat = self.lrelu(self.upconv2(
                F.interpolate(feat, scale_factor=2, mode="nearest")))
        return self.conv_last(self.lrelu(self.conv_hr(feat)))


def create_torch(seed: int = 0, nf: int = 64, nb: int = 4, scale: int = 4) -> nn.Module:
    torch.manual_seed(seed)
    return RRDBNet(nf=nf, nb=nb, scale=scale).eval()


def build(batch: int = 1, image_size: int = 64, seed: int = 0,
          nf: int = 64, nb: int = 4, scale: int = 4):
    from ..frontend.torch_export import export_torch

    m = create_torch(seed, nf, nb, scale)
    example = torch.randn(batch, 3, image_size, image_size)
    g = export_torch(m, example, name="esrgan", opset=17)
    return g, m, (batch, 3, image_size, image_size)
