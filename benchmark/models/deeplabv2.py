"""DeepLab-v2: a dilated ResNet with the ProDA head at `layer6` on layer4
and the structural aux head at `layer5` on layer3, the reference model of
the configurations whose "model" is "deeplabv2". Its shape key is
"layers", the bottlenecks of each of the four stages ((3, 4, 6, 3): R50).

Parameter names follow the OnDA checkpoints' layout, which is the
program's (`onda_torch.models.build_deeplab_v2`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchkit import reference

SHAPE_KEYS = ("layers",)
STAGES = ((64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4))  # planes, stride, dilation
HEAD_DILATIONS = (6, 12, 18, 24)
FEATURES = 256
AUX, MAIN = "layer5", "layer6"  # the heads' modules
HEADS = (f"{AUX}.", f"{MAIN}.")  # the prefixes of the leaves stepped at the head's LR


def feature_grid(hw):
    """The output grid of an (H, W) input: 1/8 + 1."""
    return hw[0] // 8 + 1, hw[1] // 8 + 1


def _head_shapes(prefix: str, cin: int, classes: int) -> dict:
    out = {}
    for i in range(5):
        k = 1 if i == 0 else 3
        out[f"{prefix}.conv2d_list.{i}.0.weight"] = (FEATURES, cin, k, k)
        out[f"{prefix}.conv2d_list.{i}.0.bias"] = (FEATURES,)
        out[f"{prefix}.conv2d_list.{i}.1.weight"] = (FEATURES,)
        out[f"{prefix}.conv2d_list.{i}.1.bias"] = (FEATURES,)
    width = 5 * FEATURES
    out[f"{prefix}.bottleneck.0.se.0.weight"] = (width // 16, width)
    out[f"{prefix}.bottleneck.0.se.0.bias"] = (width // 16,)
    out[f"{prefix}.bottleneck.0.se.2.weight"] = (width, width // 16)
    out[f"{prefix}.bottleneck.0.se.2.bias"] = (width,)
    out[f"{prefix}.bottleneck.1.weight"] = (FEATURES, width, 3, 3)
    out[f"{prefix}.bottleneck.1.bias"] = (FEATURES,)
    out[f"{prefix}.bottleneck.2.weight"] = (FEATURES,)
    out[f"{prefix}.bottleneck.2.bias"] = (FEATURES,)
    out[f"{prefix}.head.1.weight"] = (classes, FEATURES, 1, 1)
    return out


def shapes(layers, classes: int = 19) -> dict:
    """name → shape of every parameter."""
    out = {"conv1.weight": (64, 3, 7, 7), "bn1.weight": (64,), "bn1.bias": (64,)}
    cin = 64
    for s, ((planes, _, _), blocks) in enumerate(zip(STAGES, layers), start=1):
        for j in range(blocks):
            p = f"layer{s}.{j}"
            out[f"{p}.conv1.weight"] = (planes, cin, 1, 1)
            out[f"{p}.conv2.weight"] = (planes, planes, 3, 3)
            out[f"{p}.conv3.weight"] = (planes * 4, planes, 1, 1)
            for b, width in (("bn1", planes), ("bn2", planes), ("bn3", planes * 4)):
                out[f"{p}.{b}.weight"] = (width,)
                out[f"{p}.{b}.bias"] = (width,)
            if j == 0:
                out[f"{p}.downsample.0.weight"] = (planes * 4, cin, 1, 1)
                out[f"{p}.downsample.1.weight"] = (planes * 4,)
                out[f"{p}.downsample.1.bias"] = (planes * 4,)
            cin = planes * 4
    out.update(_head_shapes(AUX, 1024, classes))
    out.update(_head_shapes(MAIN, 2048, classes))
    return out


def multiplicity(name: str, aux_trained: bool) -> int:
    """0 for a leaf SGD never moves, else how many chained updates a step
    gives it: the reference's backbone generator yields a bottleneck's
    parameters three times and a downsample's four (the heads, and the stem,
    once); the BatchNorms' affine parameters are frozen, and so is the aux
    head unless the model is multi-level."""
    parts = name.split(".")
    if parts[0] == AUX and not aux_trained:
        return 0
    if parts[0] in (AUX, MAIN):
        return 1
    norm = "bn" in parts[-2] or parts[-3:-1] == ["downsample", "1"]
    if parts[-1] in ("weight", "bias") and norm:
        return 0
    if parts[0].startswith("layer"):
        return 4 if "downsample" in parts else 3
    return 1


class Net(reference.Net):
    """The forward of one parameter set; `aux` adds the aux head's output."""

    def __init__(self, layers, compute=None, observe=None):
        super().__init__(compute, observe)
        self.layers = tuple(layers)

    def head(self, P, pre, x, train, gen):
        outs = []
        for i in range(5):
            d = 1 if i == 0 else HEAD_DILATIONS[i - 1]
            pad = 0 if i == 0 else d
            branch = f"{pre}.conv2d_list.{i}"
            y = self.conv(x, P[f"{branch}.0.weight"], P[f"{branch}.0.bias"], padding=pad,
                          dilation=d)
            y = F.group_norm(y, 32, P[f"{pre}.conv2d_list.{i}.1.weight"],
                             P[f"{pre}.conv2d_list.{i}.1.bias"], 1e-5)
            outs.append(F.relu(y))
        y = torch.cat(outs, dim=1)
        s = F.relu(self.linear(y.mean(dim=(2, 3)), P[f"{pre}.bottleneck.0.se.0.weight"],
                               P[f"{pre}.bottleneck.0.se.0.bias"]))
        s = torch.sigmoid(self.linear(s, P[f"{pre}.bottleneck.0.se.2.weight"],
                                      P[f"{pre}.bottleneck.0.se.2.bias"]))
        y = y * s[:, :, None, None]
        y = self.conv(y, P[f"{pre}.bottleneck.1.weight"], P[f"{pre}.bottleneck.1.bias"], padding=1)
        feat = F.group_norm(y, 32, P[f"{pre}.bottleneck.2.weight"], P[f"{pre}.bottleneck.2.bias"],
                            1e-5)
        if train and gen is not None:
            feat = self.dropout(feat, gen)
        return feat, self.conv(feat, P[f"{pre}.head.1.weight"])

    def __call__(self, P, x, train, gen=None, aux=False):
        """(aux (feat, logits) or None, main (feat, logits))."""
        h = F.relu(self.bn(P, "bn1", self.conv(x, P["conv1.weight"], stride=2, padding=3), train))
        h = F.max_pool2d(h, 3, 2, 1, ceil_mode=True)
        aux_out = None
        for s, ((_, stride, dil), blocks) in enumerate(zip(STAGES, self.layers), start=1):
            for j in range(blocks):
                p = f"layer{s}.{j}"
                st = stride if j == 0 else 1
                y = F.relu(self.bn(P, f"{p}.bn1", self.conv(h, P[f"{p}.conv1.weight"], stride=st),
                                   train))
                y = F.relu(self.bn(P, f"{p}.bn2", self.conv(y, P[f"{p}.conv2.weight"],
                                                            padding=dil, dilation=dil), train))
                y = self.bn(P, f"{p}.bn3", self.conv(y, P[f"{p}.conv3.weight"]), train)
                res = h if j else self.bn(P, f"{p}.downsample.1",
                                          self.conv(h, P[f"{p}.downsample.0.weight"], stride=st),
                                          train)
                h = F.relu(y + res)
            if s == 3 and aux:
                aux_out = self.head(P, AUX, h, train, gen)
        return aux_out, self.head(P, MAIN, h, train, gen)
