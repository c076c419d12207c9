"""DeepLab-v3 / v3+ family (ResNet-50/101 and MobileNetV2 backbones) — PyTorch, NCHW.

Counterpart of `onda_tpu/models/deeplabv3.py`. The reference vendors this zoo
(reference framework/model/deeplabv3/modeling.py:114-215, _deeplab.py,
backbone/resnet.py, backbone/mobilenetv2.py) but never wires it into the live
pipeline; neither does this package: `registry.get_model` and the CLI do not
reach it. ASPP with image-level pooling, the v3+ decoder with low-level skip
features, and an output_stride 8/16 switch through dilated stages.

Module names follow the JAX scopes (`backbone.block3_1.depthwise.conv.weight`,
`aspp.pool.bn.running_var`, `classifier.bias`); the ResNet backbone's stages
are `deeplabv2.ResLayer`s (`backbone.layer1.0.downsample.1.weight`), so
`convert.flax_v3_to_state_dict` maps the JAX variables mechanically. Every
BatchNorm is `layers.TorchBatchNorm`: in train mode its statistics come from
K2. Each module takes `train` and `update_stats` as call arguments, as the
DeepLab-v2 modules do.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.interp import upsample_bilinear_ac
from .deeplabv2 import ResLayer, conv
from .layers import Conv2d, TorchBatchNorm, max_pool_ceil


class _ConvBNReLU(nn.Module):
    """Conv (no bias, torch-style symmetric padding) → BatchNorm → ReLU, or
    ReLU6 for a grouped conv only (`deeplabv3.py:37`: MobileNetV2's stem and
    expand convs take a plain ReLU, unlike the paper)."""

    def __init__(self, cin, features, kernel=3, stride=1, dilation=1, groups=1):
        super().__init__()
        pad = (kernel - 1) // 2 * dilation
        self.conv = Conv2d(cin, features, kernel, stride=stride, padding=pad, dilation=dilation,
                           groups=groups, bias=False)
        self.bn = TorchBatchNorm(features)
        self.groups = groups

    def forward(self, x, train=False, update_stats=True):
        x = self.bn(self.conv(x), train, update_stats)
        return F.relu6(x) if self.groups > 1 else F.relu(x)


class InvertedResidual(nn.Module):
    """MobileNetV2 block (reference backbone/mobilenetv2.py)."""

    def __init__(self, inp, features, stride=1, expand=6, dilation=1):
        super().__init__()
        hidden = inp * expand
        self.expand = _ConvBNReLU(inp, hidden, kernel=1) if expand != 1 else None
        self.depthwise = _ConvBNReLU(hidden, hidden, kernel=3, stride=stride, dilation=dilation,
                                     groups=hidden)
        self.project = Conv2d(hidden, features, 1, bias=False)
        self.project_bn = TorchBatchNorm(features)
        self.residual = stride == 1 and inp == features

    def forward(self, x, train=False, update_stats=True):
        out = x if self.expand is None else self.expand(x, train, update_stats)
        out = self.depthwise(out, train, update_stats)
        out = self.project_bn(self.project(out), train, update_stats)
        return out + x if self.residual else out


class MobileNetV2Backbone(nn.Module):
    # t, c, n, s (MobileNetV2 paper)
    CFG = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
    channels, low_channels = 320, 24

    def __init__(self, output_stride=16):
        super().__init__()
        self.stem = _ConvBNReLU(3, 32, stride=2)
        self.order = []
        inp, stride_so_far, dilation = 32, 2, 1
        for bi, (t, c, n, s) in enumerate(self.CFG):
            for i in range(n):
                # the JAX rule as written (`deeplabv3.py:80-87`)
                stride = s if i == 0 else 1
                if stride > 1 and stride_so_far >= output_stride:
                    dilation *= stride
                    stride = 1
                else:
                    stride_so_far *= stride if i == 0 else 1
                name = f"block{bi}_{i}"
                self.add_module(name, InvertedResidual(inp, c, stride=stride, expand=t,
                                                       dilation=dilation))
                self.order.append(name)
                inp = c
        self.low_after = f"block1_{self.CFG[1][2] - 1}"  # 24-ch low-level features for v3+

    def forward(self, x, train=False, update_stats=True):
        x = self.stem(x, train, update_stats)
        low = None
        for name in self.order:
            x = getattr(self, name)(x, train, update_stats)
            if name == self.low_after:
                low = x
        return {"out": x, "low_level": low}


class ResNetBackbone(nn.Module):
    channels, low_channels = 2048, 256

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), output_stride=16):
        super().__init__()
        if output_stride == 8:
            strides, dils = (1, 1), (2, 4)
        else:
            strides, dils = (2, 1), (1, 2)
        self.conv1 = conv(3, 64, 7, stride=2, padding=3)
        self.bn1 = TorchBatchNorm(64)
        self.layer1 = ResLayer(64, 64, layers[0])
        self.layer2 = ResLayer(256, 128, layers[1], stride=2)
        self.layer3 = ResLayer(512, 256, layers[2], stride=strides[0], dilation=dils[0])
        self.layer4 = ResLayer(1024, 512, layers[3], stride=strides[1], dilation=dils[1])

    def forward(self, x, train=False, update_stats=True):
        x = F.relu(self.bn1(self.conv1(x), train, update_stats))
        x = max_pool_ceil(x, 3, 2, 1)
        low = x = self.layer1(x, train, update_stats)  # 256-ch low-level features
        x = self.layer2(x, train, update_stats)
        x = self.layer3(x, train, update_stats)
        x = self.layer4(x, train, update_stats)
        return {"out": x, "low_level": low}


class ASPPv3(nn.Module):
    """ASPP with image pooling (reference _deeplab.py ASPP). The pooling
    branch normalises an (N, C, 1, 1) map: in train mode its BatchNorm's
    statistics run over N values a channel (at N = 1 a zero variance)."""

    def __init__(self, inplanes, features=256, rates: Sequence[int] = (12, 24, 36)):
        super().__init__()
        self.b0 = _ConvBNReLU(inplanes, features, kernel=1)
        for i, r in enumerate(rates, 1):
            self.add_module(f"b{i}", _ConvBNReLU(inplanes, features, kernel=3, dilation=r))
        self.n_branches = 1 + len(rates)
        self.pool = _ConvBNReLU(inplanes, features, kernel=1)
        self.proj = _ConvBNReLU(features * (self.n_branches + 1), features, kernel=1)

    def forward(self, x, train=False, update_stats=True):
        branches = [getattr(self, f"b{i}")(x, train, update_stats) for i in range(self.n_branches)]
        pooled = self.pool(x.mean(dim=(2, 3), keepdim=True), train, update_stats)
        branches.append(pooled.expand(-1, -1, *x.shape[2:]))
        return self.proj(torch.cat(branches, dim=1), train, update_stats)


class DeepLabV3(nn.Module):
    """v3 (plain ASPP head) or v3+ (decoder with low-level skip).

    forward(x, train, update_stats) → (None, {"out": logits at the input
    size, "feat": the classifier's input}), the v2 model's return form. The
    upsample sizes come from the tensors (ASPP output to the low-level grid,
    logits to the input), both bilinear with align_corners."""

    def __init__(self, num_classes=19, backbone="resnet50", plus=True, output_stride=16):
        super().__init__()
        if backbone == "mobilenetv2":
            self.backbone = MobileNetV2Backbone(output_stride)
        else:
            layers = (3, 4, 6, 3) if backbone == "resnet50" else (3, 4, 23, 3)
            self.backbone = ResNetBackbone(layers, output_stride)
        self.aspp = ASPPv3(self.backbone.channels)
        self.plus = plus
        if plus:
            self.low_proj = _ConvBNReLU(self.backbone.low_channels, 48, kernel=1)
            self.fuse = _ConvBNReLU(256 + 48, 256, kernel=3)
        self.classifier = Conv2d(256, num_classes, 1, bias=True)

    def forward(self, x, train=False, update_stats=True):
        feats = self.backbone(x, train, update_stats)
        out = self.aspp(feats["out"], train, update_stats)
        if self.plus:
            low = self.low_proj(feats["low_level"], train, update_stats)
            out = upsample_bilinear_ac(out, low.shape[-2:])
            out = self.fuse(torch.cat([out, low], dim=1), train, update_stats)
        logits = self.classifier(out)
        return None, {"out": upsample_bilinear_ac(logits, x.shape[-2:]), "feat": out}


def build_deeplab_v3(num_classes=19, backbone="resnet50", plus=True, output_stride=16):
    return DeepLabV3(num_classes=num_classes, backbone=backbone, plus=plus,
                     output_stride=output_stride)
