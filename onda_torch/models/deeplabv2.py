"""DeepLab-v2 (dilated ResNet-50/101, stride 8) with ASPP / ProDA heads — PyTorch, NCHW.

Counterpart of `onda_tpu/models/deeplabv2.py` (reference
framework/model/deeplabv2.py:7-395). Module names follow the reference OnDA
state_dict layout (`layer1.0.downsample.1.running_var`,
`layer6.conv2d_list.2.1.weight`, `layer6.bottleneck.0.se.0.weight`,
`layer6.head.1.weight`, ...), so reference `.pth` files load with
`strict=True`. Every module takes `train`, `update_stats` and a dropout
`generator` as call arguments, like the JAX modules, so the adaptation step
can drive one module tree with several parameter and buffer sets through
`torch.func.functional_call`.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dropout2d, GroupNorm, TorchBatchNorm, max_pool_ceil


def conv(cin, cout, kernel, stride=1, dilation=1, padding=0, bias=False):
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, dilation=dilation,
                     bias=bias)


class Bottleneck(nn.Module):
    """ResNet bottleneck (reference deeplabv2.py:7-68): stride on conv1, dilated conv2."""

    expansion = 4

    def __init__(self, inplanes, planes, stride=1, dilation=1, downsample=False,
                 bn_momentum=0.1):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 1, stride=stride)
        self.bn1 = TorchBatchNorm(planes, bn_momentum)
        self.conv2 = conv(planes, planes, 3, padding=dilation, dilation=dilation)
        self.bn2 = TorchBatchNorm(planes, bn_momentum)
        self.conv3 = conv(planes, planes * 4, 1)
        self.bn3 = TorchBatchNorm(planes * 4, bn_momentum)
        self.downsample = None
        if downsample:
            self.downsample = nn.ModuleList([
                conv(inplanes, planes * 4, 1, stride=stride),
                TorchBatchNorm(planes * 4, bn_momentum),
            ])

    def forward(self, x, train=False, update_stats=True):
        out = F.relu(self.bn1(self.conv1(x), train, update_stats))
        out = F.relu(self.bn2(self.conv2(out), train, update_stats))
        out = self.bn3(self.conv3(out), train, update_stats)
        residual = x
        if self.downsample is not None:
            residual = self.downsample[1](self.downsample[0](x), train, update_stats)
        return F.relu(out + residual)


class ResLayer(nn.ModuleList):
    """A stage of bottlenecks (reference _make_layer, deeplabv2.py:333-373); the
    first block always downsamples for these stages."""

    def __init__(self, inplanes, planes, blocks, stride=1, dilation=1, bn_momentum=0.1):
        super().__init__([Bottleneck(inplanes, planes, stride, dilation, True, bn_momentum)])
        for _ in range(1, blocks):
            self.append(Bottleneck(planes * 4, planes, 1, dilation, False, bn_momentum))

    def forward(self, x, train=False, update_stats=True):
        for block in self:
            x = block(x, train, update_stats)
        return x


class ASPPClassifier(nn.Module):
    """Classic ASPP head: sum of 4 dilated 3×3 convs (reference deeplabv2.py:71-95)."""

    def __init__(self, inplanes, num_classes, dilations=(6, 12, 18, 24)):
        super().__init__()
        self.conv2d_list = nn.ModuleList(
            conv(inplanes, num_classes, 3, padding=d, dilation=d, bias=True) for d in dilations)

    def forward(self, x, train=False, generator=None):
        out = None
        for branch in self.conv2d_list:
            out = branch(x) if out is None else out + branch(x)
        return out


class SEBlock(nn.Module):
    """Squeeze-and-excitation over the concatenated ASPP branches."""

    def __init__(self, channels, reduction=16):
        super().__init__()
        self.se = nn.Sequential(nn.Linear(channels, channels // reduction), nn.ReLU(),
                                nn.Linear(channels // reduction, channels), nn.Sigmoid())

    def forward(self, x):
        return x * self.se(x.mean(dim=(2, 3)))[:, :, None, None]


class ProDAClassifier(nn.Module):
    """ProDA `Classifier_Module2` (reference deeplabv2.py:117-257): five ASPP
    branches (1×1 + four dilated 3×3, each Conv→GroupNorm→ReLU) → concat → SE →
    3×3 bottleneck conv → GroupNorm → Dropout2d → 1×1 classifier. Returns
    {"feat": post-dropout 256-d features, "out": logits}."""

    def __init__(self, inplanes, num_classes, dilations=(6, 12, 18, 24), droprate=0.1,
                 use_se=True):
        super().__init__()
        branches = [nn.Sequential(conv(inplanes, 256, 1, bias=True), GroupNorm(256), nn.ReLU())]
        for d in dilations:
            branches.append(nn.Sequential(conv(inplanes, 256, 3, padding=d, dilation=d, bias=True),
                                          GroupNorm(256), nn.ReLU()))
        self.conv2d_list = nn.ModuleList(branches)
        width = 256 * len(branches)
        self.bottleneck = nn.Sequential(SEBlock(width) if use_se else nn.Identity(),
                                        conv(width, 256, 3, padding=1, bias=True), GroupNorm(256))
        self.head = nn.ModuleList([Dropout2d(droprate), conv(256, num_classes, 1)])

    def forward(self, x, train=False, generator=None):
        out = torch.cat([branch(x) for branch in self.conv2d_list], dim=1)
        out = self.bottleneck(out)
        feat = self.head[0](out, train, generator)
        return {"feat": feat, "out": self.head[1](feat)}


class DeepLabV2(nn.Module):
    """The full model (reference ResNetMulti, deeplabv2.py:260-395).

    forward(x, train, update_stats, generator, with_aux) → (aux_or_None, main)
    where main is {"feat","out"} for the ProDA classifier or raw logits for the
    classic one. The `layer5` aux head is structural: it always exists
    (reference checkpoints carry it) and runs only when `multi_level` is set
    and the caller does not pass `with_aux=False`. Callers that never read
    `aux` pass it; the compiled JAX step likewise never runs the unused head
    (XLA drops it)."""

    def __init__(self, num_classes=19, layers: Sequence[int] = (3, 4, 23, 3),
                 classifier="ProDA", multi_level=False, bn_momentum=0.1, droprate=0.1):
        super().__init__()
        self.multi_level = multi_level
        m = bn_momentum
        self.conv1 = conv(3, 64, 7, stride=2, padding=3)
        self.bn1 = TorchBatchNorm(64, m)
        self.layer1 = ResLayer(64, 64, layers[0], bn_momentum=m)
        self.layer2 = ResLayer(256, 128, layers[1], stride=2, bn_momentum=m)
        self.layer3 = ResLayer(512, 256, layers[2], dilation=2, bn_momentum=m)
        self.layer4 = ResLayer(1024, 512, layers[3], dilation=4, bn_momentum=m)
        if classifier == "ProDA":
            make = lambda cin: ProDAClassifier(cin, num_classes, droprate=droprate)  # noqa: E731
        else:
            make = lambda cin: ASPPClassifier(cin, num_classes)  # noqa: E731
        self.layer5 = make(1024)
        self.layer6 = make(2048)

    def forward(self, x, train=False, update_stats=True, generator=None, with_aux=True):
        x = F.relu(self.bn1(self.conv1(x), train, update_stats))
        x = max_pool_ceil(x, window=3, stride=2, padding=1)
        x = self.layer1(x, train, update_stats)
        x = self.layer2(x, train, update_stats)
        x = self.layer3(x, train, update_stats)
        aux = self.layer5(x, train, generator) if self.multi_level and with_aux else None
        x = self.layer4(x, train, update_stats)
        return aux, self.layer6(x, train, generator)


def build_deeplab_v2(num_classes: int = 19, layers: Sequence[int] = (3, 4, 23, 3),
                     classifier: str = "ProDA", multi_level: bool = False,
                     bn_momentum: float = 0.1, droprate: float = 0.1) -> DeepLabV2:
    """BN-backbone DeepLab-v2; the GN backbone and the Microsoft-ProDA layout
    are not ported yet."""
    return DeepLabV2(num_classes, tuple(layers), classifier, multi_level, bn_momentum, droprate)
