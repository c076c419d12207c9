"""The plain reference: the operations a model is written in, the seeded
weights, ADVENT's discriminator, the losses and the optimizers, in plain
PyTorch. Each model's forward and layout are a model file of their own
(`benchmark/models/<name>.py`, named by a configuration's "model"), each
method's steps a reference of their own (`benchmark/references/`).

It follows the published method (OnDA, CVPR 2022; ProDA's classifier;
ADVENT) as the configurations state it, with no kernel, cache or batching
of the program's: every convolution is `F.conv2d`, every normalisation
takes its statistics with `mean` / `var`, the prototypes' distances are
`torch.cdist`, the gradients come from autograd. It imports nothing of the
program. A model file names its parameters as the program's model does, so
that `seeded_weights` gives both sides the same weights by name.

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

BN_EPS = 1e-5
DROPOUT = 0.1
D_WIDTHS = (64, 128, 256, 512, 1)  # FCDiscriminator


# ---------------------------------------------------------------------------
# Parameters: names, shapes and the seeded draw
# ---------------------------------------------------------------------------


def disc_shapes(prefix: str, classes: int = 19) -> dict:
    widths = (classes,) + D_WIDTHS
    out = {}
    for i in range(5):
        out[f"{prefix}.conv{i}.weight"] = (widths[i + 1], widths[i], 4, 4)
        out[f"{prefix}.conv{i}.bias"] = (widths[i + 1],)
    return out


def seeded_weights(shapes: dict, g: torch.Generator, device, drawn=None) -> dict:
    """Weights for `shapes` from one draw of `g`: every weight of two or more
    dimensions and every bias beside one, normal with the standard deviation
    of PyTorch's default uniform init (1/sqrt(3·fan_in)); the 1-D weights
    and biases of the normalisations 1 and 0. `drawn`: leaf → fan_in of the
    leaves that rule gets wrong (a model file's `drawn`), drawn normal at
    that fan's spread. Leaves in name order."""
    names = sorted(shapes)
    fan_in = {n: math.prod(shapes[n][1:]) for n in names if len(shapes[n]) >= 2}
    drawn = drawn or {}

    def fan(name):
        if name in drawn:
            return drawn[name]
        if name in fan_in:
            return fan_in[name]
        if name.endswith(".bias"):
            return fan_in.get(name[:-len("bias")] + "weight")
        return None

    picked = [n for n in names if fan(n) is not None]
    flat = torch.randn(sum(math.prod(shapes[n]) for n in picked), generator=g, device=device)
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
# The operations a model file's forward is written in
# ---------------------------------------------------------------------------


class Net:
    """The operations of a forward. A model file subclasses it with its
    forward, `net(P, x, train, gen=None, aux=False)` → (aux (feat, logits)
    or None, main (feat, logits)) of the parameters P on the batch x.
    `train`: batch statistics in every BatchNorm and channel dropout drawn
    from `gen` (None: no dropout); otherwise the initial running statistics
    (mean 0, var 1)."""

    def __init__(self, compute=None, observe=None):
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


def sgd(params, momentum, grads, mult, lr_backbone, lr_head, mu, wd, heads):
    """`mult[name]` chained SGD updates of each leaf, at `lr_head` where the
    leaf's name starts with one of the model's `heads` prefixes."""
    with torch.no_grad():
        for name, g in grads.items():
            k = mult[name]
            lr = lr_head if name.startswith(heads) else lr_backbone
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
