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

The options of the JAX model: a GroupNorm backbone (`DeepLabv2-Resnet50-GN`,
reference model_handler.py:31-40), Microsoft ProDA's layout
(`DeepLabv2-Resnet101-ProDA`, reference deeplabv2_proda.py:310-419: the only
head at `layer5`, an optional bn_clr `bn_pretrain` BatchNorm(2048) before it),
a compute dtype (bf16 over f32 parameters) and per-bottleneck activation
rematerialisation.

Under OTHERS.TENSOR_PARALLEL the parameter dicts hold channel shards of the
wide layers (`parallel.tensor`): each sharded conv takes its whole input
through `fan_in`, its norm returns the whole output, and the rest (ReLU,
residual add, concat, SE, dropout, classifier) runs on whole tensors, alike
on every model rank. The stem's conv (64 channels), the SE's squeeze (80)
and the classifiers (one channel a class) are narrower than JAX's 128 and
never sharded, so they take their input as it is. With whole parameters
none of it does anything.

On a spatial axis (`parallel.spatial`) every rank runs the model on its
block of the image's rows: the forward enters the image's global height in
the row table (`spatial.begin`), the layers fetch the rows their windows
read (`layers`), and the SE block's mean is a sum and a count over the
spatial group.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import distributed as dist
from ..parallel import spatial as S
from ..parallel import tensor as T
from .layers import (Conv2d, Dropout2d, GroupNorm, Linear, TorchBatchNorm, max_pool_ceil,
                     rematerialized)


def conv(cin, cout, kernel, stride=1, dilation=1, padding=0, bias=False, dtype=None):
    return Conv2d(cin, cout, kernel, stride=stride, padding=padding, dilation=dilation,
                  bias=bias, compute_dtype=dtype)


class Bottleneck(nn.Module):
    """ResNet bottleneck (reference deeplabv2.py:7-68): stride on conv1, dilated conv2."""

    expansion = 4

    def __init__(self, inplanes, planes, stride=1, dilation=1, downsample=False,
                 norm=TorchBatchNorm, dtype=None):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 1, stride=stride, dtype=dtype)
        self.bn1 = norm(planes)
        self.conv2 = conv(planes, planes, 3, padding=dilation, dilation=dilation, dtype=dtype)
        self.bn2 = norm(planes)
        self.conv3 = conv(planes, planes * 4, 1, dtype=dtype)
        self.bn3 = norm(planes * 4)
        self.downsample = None
        if downsample:
            self.downsample = nn.ModuleList([
                conv(inplanes, planes * 4, 1, stride=stride, dtype=dtype),
                norm(planes * 4),
            ])

    def forward(self, x, train=False, update_stats=True):
        ds = self.downsample
        x1, xd = T.fan_in(x, self.conv1, None if ds is None else ds[0])
        out = F.relu(self.bn1(self.conv1(x1), train, update_stats))
        out = F.relu(self.bn2(self.conv2(T.fan_in(out, self.conv2)[0]), train, update_stats))
        out = self.bn3(self.conv3(T.fan_in(out, self.conv3)[0]), train, update_stats)
        residual = x if ds is None else ds[1](ds[0](xd), train, update_stats)
        return F.relu(out + residual)


class ResLayer(nn.ModuleList):
    """A stage of bottlenecks (reference _make_layer, deeplabv2.py:333-373); the
    first block always downsamples for these stages. With `remat`, each block
    that autograd records runs under `rematerialized`."""

    def __init__(self, inplanes, planes, blocks, stride=1, dilation=1, norm=TorchBatchNorm,
                 dtype=None, remat=False):
        super().__init__([Bottleneck(inplanes, planes, stride, dilation, True, norm, dtype)])
        for _ in range(1, blocks):
            self.append(Bottleneck(planes * 4, planes, 1, dilation, False, norm, dtype))
        self.remat = remat

    def forward(self, x, train=False, update_stats=True):
        for block in self:
            if self.remat and torch.is_grad_enabled():
                x = rematerialized(block, x, train, update_stats)
            else:
                x = block(x, train, update_stats)
        return x


class ASPPClassifier(nn.Module):
    """Classic ASPP head: sum of 4 dilated 3×3 convs (reference deeplabv2.py:71-95)."""

    def __init__(self, inplanes, num_classes, dilations=(6, 12, 18, 24), dtype=None):
        super().__init__()
        self.conv2d_list = nn.ModuleList(
            conv(inplanes, num_classes, 3, padding=d, dilation=d, bias=True, dtype=dtype)
            for d in dilations)

    def forward(self, x, train=False, generator=None):
        out = None
        for branch in self.conv2d_list:
            out = branch(x) if out is None else out + branch(x)
        return out


class SEBlock(nn.Module):
    """Squeeze-and-excitation over the concatenated ASPP branches."""

    def __init__(self, channels, reduction=16, dtype=None):
        super().__init__()
        self.se = nn.Sequential(Linear(channels, channels // reduction, compute_dtype=dtype),
                                nn.ReLU(),
                                Linear(channels // reduction, channels, compute_dtype=dtype),
                                nn.Sigmoid())

    def forward(self, x):
        fc1, relu, fc2, sigmoid = self.se
        if S.active():  # the mean over every rank's rows of a sample
            total = dist.summed(x.float().sum(dim=(2, 3)), group="spatial")[0]
            mean = (total / (S.global_height(x.shape[2]) * x.shape[3])).to(x.dtype)
        else:
            mean = x.mean(dim=(2, 3))
        s = fc2(T.fan_in(relu(fc1(mean)), fc2)[0])
        if T.shards(fc2) > 1:
            s = T.gather_channels(s)
        return x * sigmoid(s)[:, :, None, None]


class ProDAClassifier(nn.Module):
    """ProDA `Classifier_Module2` (reference deeplabv2.py:117-257): five ASPP
    branches (1×1 + four dilated 3×3, each Conv→GroupNorm→ReLU) → concat → SE →
    3×3 bottleneck conv → GroupNorm → Dropout2d → 1×1 classifier. Returns
    {"feat": post-dropout 256-d features, "out": logits}."""

    def __init__(self, inplanes, num_classes, dilations=(6, 12, 18, 24), droprate=0.1,
                 use_se=True, dtype=None):
        super().__init__()
        branches = [nn.Sequential(conv(inplanes, 256, 1, bias=True, dtype=dtype), GroupNorm(256),
                                  nn.ReLU())]
        for d in dilations:
            branches.append(nn.Sequential(
                conv(inplanes, 256, 3, padding=d, dilation=d, bias=True, dtype=dtype),
                GroupNorm(256), nn.ReLU()))
        self.conv2d_list = nn.ModuleList(branches)
        width = 256 * len(branches)
        self.bottleneck = nn.Sequential(SEBlock(width, dtype=dtype) if use_se else nn.Identity(),
                                        conv(width, 256, 3, padding=1, bias=True, dtype=dtype),
                                        GroupNorm(256))
        self.head = nn.ModuleList([Dropout2d(droprate), conv(256, num_classes, 1, dtype=dtype)])

    def forward(self, x, train=False, generator=None):
        xs = T.fan_in(x, *(branch[0] for branch in self.conv2d_list))
        out = torch.cat([branch(xb) for branch, xb in zip(self.conv2d_list, xs)], dim=1)
        se, conv, norm = self.bottleneck
        out = norm(conv(T.fan_in(se(out), conv)[0]))
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
    (XLA drops it). Under `proda_layout` the only head is `layer5`, on
    layer4's features (after `bn_pretrain` with `bn_clr`), and there is no
    aux head. `compute_dtype` is the dtype the image is cast to on entry and
    every convolution computes in; parameters and buffers stay f32."""

    feature_width = 256  # the ProDA classifier's "feat" (reference deeplabv2.py:205)

    def __init__(self, num_classes=19, layers: Sequence[int] = (3, 4, 23, 3),
                 classifier="ProDA", multi_level=False, norm=TorchBatchNorm, droprate=0.1,
                 proda_layout=False, bn_clr=False, dtype=None, remat=False):
        super().__init__()
        if proda_layout and multi_level:
            raise ValueError("the ProDA layout has no aux head (reference deeplabv2_proda.py:397-419)")
        self.multi_level = multi_level
        self.proda_layout = proda_layout
        self.compute_dtype = dtype
        self.conv1 = conv(3, 64, 7, stride=2, padding=3, dtype=dtype)
        self.bn1 = norm(64)
        stage = partial(ResLayer, norm=norm, dtype=dtype, remat=remat)
        self.layer1 = stage(64, 64, layers[0])
        self.layer2 = stage(256, 128, layers[1], stride=2)
        self.layer3 = stage(512, 256, layers[2], dilation=2)
        self.layer4 = stage(1024, 512, layers[3], dilation=4)
        if classifier == "ProDA":
            make = partial(ProDAClassifier, num_classes=num_classes, droprate=droprate, dtype=dtype)
        else:
            make = partial(ASPPClassifier, num_classes=num_classes, dtype=dtype)
        self.bn_pretrain = norm(2048) if proda_layout and bn_clr else None
        if proda_layout:
            self.layer5 = make(2048)
        else:
            self.layer5 = make(1024)
            self.layer6 = make(2048)

    def forward(self, x, train=False, update_stats=True, generator=None, with_aux=True):
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        if S.active():
            S.begin(x)
        x = F.relu(self.bn1(self.conv1(x), train, update_stats))
        x = max_pool_ceil(x, window=3, stride=2, padding=1)
        x = self.layer1(x, train, update_stats)
        x = self.layer2(x, train, update_stats)
        x = self.layer3(x, train, update_stats)
        aux = None
        if self.multi_level and with_aux:  # never under the ProDA layout
            aux = self.layer5(x, train, generator)
        x = self.layer4(x, train, update_stats)
        if self.bn_pretrain is not None:
            x = self.bn_pretrain(x, train, update_stats)
        head = self.layer5 if self.proda_layout else self.layer6
        return aux, head(x, train, generator)


def build_deeplab_v2(num_classes: int = 19, layers: Sequence[int] = (3, 4, 23, 3),
                     classifier: str = "ProDA", multi_level: bool = False,
                     group_norm_backbone: bool = False, bn_momentum: float = 0.1,
                     droprate: float = 0.1, proda_layout: bool = False, bn_clr: bool = False,
                     dtype: torch.dtype | None = None, remat: bool = False) -> DeepLabV2:
    """The JAX `build_deeplab_v2`'s keywords: a GroupNorm(32) backbone
    (statistics in f32, f32 out) or BatchNorm with `bn_momentum`; `dtype`
    the compute dtype (None: f32); `remat` per-bottleneck rematerialisation."""
    norm = (partial(GroupNorm, f32_out=True) if group_norm_backbone
            else partial(TorchBatchNorm, momentum=bn_momentum))
    return DeepLabV2(num_classes, tuple(layers), classifier, multi_level, norm, droprate,
                     proda_layout, bn_clr, dtype, remat)
