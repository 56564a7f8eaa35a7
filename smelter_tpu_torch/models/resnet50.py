"""ResNet-50 — the headline benchmark config (BASELINE.json configs[1]:
FP16/INT8 weight-only quant + BN-into-Conv fusion; north-star metric is
images/sec/chip at INT8). Hand-written bottleneck architecture matching the
standard torchvision definition."""

from __future__ import annotations

import torch
import torch.nn as nn


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.relu = nn.ReLU(inplace=False)
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Module):
    def __init__(self, layers=(3, 4, 6, 3), num_classes=1000, width=64):
        super().__init__()
        self.inplanes = width
        self.conv1 = nn.Conv2d(3, width, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.relu = nn.ReLU(inplace=False)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        self.layer1 = self._make_layer(width, layers[0])
        self.layer2 = self._make_layer(width * 2, layers[1], stride=2)
        self.layer3 = self._make_layer(width * 4, layers[2], stride=2)
        self.layer4 = self._make_layer(width * 8, layers[3], stride=2)
        self.avgpool = nn.AdaptiveAvgPool2d(1)
        self.flatten = nn.Flatten(1)
        self.fc = nn.Linear(width * 8 * 4, num_classes)

    def _make_layer(self, planes, blocks, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * 4:
            downsample = nn.Sequential(
                nn.Conv2d(self.inplanes, planes * 4, 1, stride, bias=False),
                nn.BatchNorm2d(planes * 4),
            )
        layers = [Bottleneck(self.inplanes, planes, stride, downsample)]
        self.inplanes = planes * 4
        layers += [Bottleneck(self.inplanes, planes) for _ in range(1, blocks)]
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = self.flatten(self.avgpool(x))
        return self.fc(x)


def create_torch(seed: int = 0, num_classes: int = 1000, layers=(3, 4, 6, 3),
                 width: int = 64) -> nn.Module:
    torch.manual_seed(seed)
    m = ResNet(layers=layers, num_classes=num_classes, width=width).eval()
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, nn.BatchNorm2d):
                mod.running_mean.copy_(torch.randn(mod.num_features, generator=g) * 0.1)
                mod.running_var.copy_(torch.rand(mod.num_features, generator=g) + 0.5)
    return m


def build(batch: int = 1, image_size: int = 224, seed: int = 0,
          num_classes: int = 1000, layers=(3, 4, 6, 3), width: int = 64):
    from ..frontend.torch_export import export_torch

    m = create_torch(seed, num_classes, layers, width)
    example = torch.randn(batch, 3, image_size, image_size)
    g = export_torch(m, example, name="resnet50", opset=17)
    return g, m, (batch, 3, image_size, image_size)
