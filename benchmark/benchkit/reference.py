"""The plain reference: DeepLab-v2 (dilated ResNet, ProDA head), the hybrid
teacher policy's adaptation step and ADVENT's step, in plain PyTorch.

It follows the published method (OnDA, CVPR 2022; ProDA's classifier;
ADVENT) as the configurations state it, with no kernel, cache or batching
of the program's: every convolution is `F.conv2d`, every normalisation
takes its statistics with `mean` / `var`, the prototypes' distances are
`torch.cdist`, the gradients come from autograd. It imports nothing of the
program. Parameter names follow the OnDA checkpoints' layout, so that
`seeded_weights` gives both sides the same weights by name.

`compute` is the dtype the convolutions and dense layers compute in: None
for float32 (the reference proper, with TF32 off), torch.bfloat16 for the
control that stands one precision below the configuration's.

Only what the comparison reads is computed: the running BatchNorm
statistics are never read inside the three compared steps (every
train-mode forward normalises with its batch's statistics, and the eval-mode
teachers keep the statistics of the start), so they are not updated.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

STAGES = ((64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4))  # planes, stride, dilation
HEAD_DILATIONS = (6, 12, 18, 24)
FEATURES = 256
BN_EPS = 1e-5
DROPOUT = 0.1
D_WIDTHS = (64, 128, 256, 512, 1)  # FCDiscriminator


# ---------------------------------------------------------------------------
# Parameters: names, shapes and the seeded draw
# ---------------------------------------------------------------------------


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


def model_shapes(layers, classes: int = 19) -> dict:
    """name → shape of every parameter of DeepLab-v2 with the ProDA head at
    `layer6` on layer4 and the structural aux head at `layer5` on layer3."""
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
    out.update(_head_shapes("layer5", 1024, classes))
    out.update(_head_shapes("layer6", 2048, classes))
    return out


def disc_shapes(prefix: str, classes: int = 19) -> dict:
    widths = (classes,) + D_WIDTHS
    out = {}
    for i in range(5):
        out[f"{prefix}.conv{i}.weight"] = (widths[i + 1], widths[i], 4, 4)
        out[f"{prefix}.conv{i}.bias"] = (widths[i + 1],)
    return out


def seeded_weights(shapes: dict, g: torch.Generator, device) -> dict:
    """Weights for `shapes` from one draw of `g`: every weight of two or more
    dimensions and every bias beside one, normal with the standard deviation
    of PyTorch's default uniform init (1/sqrt(3·fan_in)); the 1-D weights
    and biases of the normalisations 1 and 0. Leaves in name order."""
    names = sorted(shapes)
    fan_in = {n: math.prod(shapes[n][1:]) for n in names if len(shapes[n]) >= 2}

    def fan(name):
        if name in fan_in:
            return fan_in[name]
        if name.endswith(".bias"):
            return fan_in.get(name[:-len("bias")] + "weight")
        return None

    drawn = [n for n in names if fan(n) is not None]
    flat = torch.randn(sum(math.prod(shapes[n]) for n in drawn), generator=g, device=device)
    out, pos = {}, 0
    for n in names:
        size = math.prod(shapes[n])
        if fan(n) is not None:
            out[n] = flat[pos:pos + size].view(shapes[n]) / math.sqrt(3.0 * fan(n))
            pos += size
        elif n.endswith(".weight"):
            out[n] = torch.ones(shapes[n], device=device)
        else:
            out[n] = torch.zeros(shapes[n], device=device)
    return out


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


class Net:
    """The forward of one parameter set. `train`: batch statistics in every
    BatchNorm and channel dropout drawn from `gen` (None: no dropout);
    otherwise the initial running statistics (mean 0, var 1)."""

    def __init__(self, layers, compute=None, observe=None):
        self.layers = tuple(layers)
        self.compute = compute
        self.observe = observe  # called with each BatchNorm's input (the FLOP and byte counts)

    def conv(self, x, w, b=None, stride=1, padding=0, dilation=1):
        cd = self.compute
        if cd is None:
            return F.conv2d(x, w, b, stride, padding, dilation)
        return F.conv2d(x.to(cd), w.to(cd), None if b is None else b.to(cd), stride, padding,
                        dilation).float()

    def linear(self, x, w, b):
        cd = self.compute
        if cd is None:
            return F.linear(x, w, b)
        return F.linear(x.to(cd), w.to(cd), b.to(cd)).float()

    def bn(self, P, name, x, train):
        if self.observe is not None:
            self.observe(x)
        if train:
            mean, var = x.mean(dim=(0, 2, 3)), x.var(dim=(0, 2, 3), unbiased=False)
        else:
            mean, var = torch.zeros_like(P[f"{name}.weight"]), torch.ones_like(P[f"{name}.weight"])
        scale = torch.rsqrt(var + BN_EPS) * P[f"{name}.weight"]
        return (x - mean.view(1, -1, 1, 1)) * scale.view(1, -1, 1, 1) + P[f"{name}.bias"].view(
            1, -1, 1, 1)

    @staticmethod
    def dropout(x, gen):
        keep = 1.0 - DROPOUT
        mask = torch.bernoulli(torch.full((x.shape[0], x.shape[1], 1, 1), keep, device=x.device),
                               generator=gen)
        return x * mask / keep

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
                aux_out = self.head(P, "layer5", h, train, gen)
        return aux_out, self.head(P, "layer6", h, train, gen)

    @staticmethod
    def disc(D, pre, x):
        for i in range(4):
            w, b = D[f"{pre}.conv{i}.weight"], D[f"{pre}.conv{i}.bias"]
            x = F.leaky_relu(F.conv2d(x, w, b, 2, 1), 0.2)
        return F.conv2d(x, D[f"{pre}.conv4.weight"], D[f"{pre}.conv4.bias"], 2, 1)


# ---------------------------------------------------------------------------
# Losses and SGD, as the method states them
# ---------------------------------------------------------------------------


def cross_entropy(logits, labels):
    """Mean CE over the pixels whose label is a class (255 ignored); 0 where
    none is."""
    per = F.cross_entropy(logits, labels.long(), ignore_index=255, reduction="none")
    return per.sum() / (labels != 255).sum().clamp(min=1)


def reverse_ce(logits, labels, classes):
    """RCE: −Σ_c p_c · log(clamp(onehot, 1e-4, 1)), summed over the valid
    pixels and divided by their count (+1e-6)."""
    valid = labels != 255
    onehot = F.one_hot(torch.where(valid, labels, 0).long(), classes).permute(0, 3, 1, 2).float()
    onehot = torch.where(valid[:, None], onehot, torch.zeros_like(onehot)).clamp(1e-4, 1.0)
    per = -(F.softmax(logits, dim=1) * torch.log(onehot)).sum(dim=1)
    return (per * valid).sum() / (valid.sum() + 1e-6)


def mrkld(logits):
    """The MRKLD regulariser: −mean over pixels and classes of log p."""
    return -F.log_softmax(logits, dim=1).mean()


def bce_logits(logits, label: float):
    return F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, label))


def entropy_map(logits):
    p = F.softmax(logits, dim=1)
    return -p * torch.log2(p + 1e-30) / math.log2(p.shape[1])


def sgd_multiplicity(name: str, aux_trained: bool):
    """0 for a leaf SGD never moves, else how many chained updates a step
    gives it: the reference's backbone generator yields a bottleneck's
    parameters three times and a downsample's four (the heads, and the stem,
    once); the BatchNorms' affine parameters are frozen, and so is the aux
    head unless the model is multi-level."""
    parts = name.split(".")
    if parts[0] == "layer5" and not aux_trained:
        return 0
    if parts[0] in ("layer5", "layer6"):
        return 1
    norm = "bn" in parts[-2] or parts[-3:-1] == ["downsample", "1"]
    if parts[-1] in ("weight", "bias") and norm:
        return 0
    if parts[0].startswith("layer"):
        return 4 if "downsample" in parts else 3
    return 1


def sgd(params, momentum, grads, mult, lr_backbone, lr_head, mu, wd):
    with torch.no_grad():
        for name, g in grads.items():
            k = mult[name]
            lr = lr_head if name.startswith(("layer5", "layer6")) else lr_backbone
            for _ in range(k):
                momentum[name] = mu * momentum[name] + g + wd * params[name]
                params[name] = params[name] - lr * momentum[name]


def adam(params, state, grads, lr, b1=0.9, b2=0.99, eps=1e-8):
    with torch.no_grad():
        state["t"] += 1
        t = state["t"]
        for name, g in grads.items():
            m = state["m"][name] = b1 * state["m"][name] + (1 - b1) * g
            v = state["v"][name] = b2 * state["v"][name] + (1 - b2) * g * g
            params[name] = params[name] - lr * (m / (1 - b1**t)) / ((v / (1 - b2**t)).sqrt() + eps)


def leaf_norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def host_copy(tree: dict) -> dict:
    return {k: v.detach().to("cpu", torch.float64) for k, v in tree.items()}


def change_norms(after: dict, before: dict) -> dict:
    return {k: float(torch.linalg.vector_norm((after[k] - before[k]).double())) for k in after}
