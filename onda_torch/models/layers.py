"""Building-block layers with the semantics of `onda_tpu/models/layers.py`, NCHW.

Train-mode BatchNorm takes its batch statistics from the hand-written kernel
K2 (`ops/kernels.bn_stats`) inside a `torch.autograd.Function` whose backward
is the closed form of `_bn_train_bwd` in plain torch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import kernels


class _BNTrain(torch.autograd.Function):
    """y = (x − mean)·(γ·rsqrt(var + eps)) + β with batch statistics, computed
    in f32 and cast back to x's type (`_bn_train_math`). mean and var enter as
    constants: the backward is the full closed form
        dx = γ·inv · (dy − mean(dy) − x̂·mean(dy·x̂)),
    which already accounts for the statistics' dependence on x."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, eps):
        inv = torch.rsqrt(var + eps)
        shape = (1, -1, 1, 1)
        y = ((x.float() - mean.view(shape)) * (inv * weight).view(shape) + bias.view(shape))
        ctx.save_for_backward(x, mean, inv, weight)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, mean, inv, weight = ctx.saved_tensors
        shape = (1, -1, 1, 1)
        dy = dy.float()
        n = x.shape[0] * x.shape[2] * x.shape[3]
        x_hat = (x.float() - mean.view(shape)) * inv.view(shape)
        dbeta = dy.sum(dim=(0, 2, 3))
        dgamma = (dy * x_hat).sum(dim=(0, 2, 3))
        dx = None
        if ctx.needs_input_grad[0]:
            dx = (weight * inv).view(shape) * (
                dy - (dbeta / n).view(shape) - x_hat * (dgamma / n).view(shape))
            dx = dx.to(x.dtype)
        return (dx, dgamma if ctx.needs_input_grad[1] else None,
                dbeta if ctx.needs_input_grad[2] else None, None, None, None)


def bn_train(x, weight, bias, eps: float = 1e-5):
    """Train-mode batch norm: returns (y, batch mean, biased batch var)."""
    mean, var = kernels.bn_stats(x.detach())
    return _BNTrain.apply(x, weight, bias, mean, var, eps), mean, var


class TorchBatchNorm(nn.Module):
    """BatchNorm2d with torch semantics and an explicit stats-update switch
    (`onda_tpu/models/layers.py::TorchBatchNorm`):

    * batch statistics whenever `train` is set, whatever `update_stats` says;
    * running statistics in eval mode;
    * the running update uses the unbiased batch variance n/(n−1), with a
      per-module momentum (0.1 by default).

    The running buffers are updated in place. State names follow
    `torch.nn.BatchNorm2d` (`num_batches_tracked` included, never advanced),
    so reference checkpoints load with `strict=True`."""

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x, train: bool = False, update_stats: bool = True):
        if train:
            y, mean, var = bn_train(x, self.weight, self.bias, self.eps)
            if update_stats:
                n = x.shape[0] * x.shape[2] * x.shape[3]
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(1 - m).add_(m * mean)
                    self.running_var.mul_(1 - m).add_(m * var * (n / max(n - 1, 1)))
            return y
        shape = (1, -1, 1, 1)
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean.view(shape)) * inv.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """GroupNorm(32) as used by the ProDA classifier head (reference deeplabv2.py:141)."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__(num_groups, channels, eps=eps)


def max_pool_ceil(x, window: int, stride: int, padding: int):
    """MaxPool2d with ceil_mode=True (reference deeplabv2.py:289-291): 256 → 129
    for k=3, s=2, p=1, which gives the 1/8+1 output grid."""
    return F.max_pool2d(x, window, stride, padding, ceil_mode=True)


def dropout2d(x, rate: float, train: bool, generator=None):
    """Channel-wise dropout (torch nn.Dropout2d) drawing from `generator`; a
    None generator in train mode disables it, as a None rng does in JAX."""
    if not train or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    probs = torch.full((x.shape[0], x.shape[1], 1, 1), keep, device=x.device)
    mask = torch.bernoulli(probs, generator=generator).to(x.dtype)
    return x * mask / keep


class Dropout2d(nn.Module):
    """Parameter-free slot for `dropout2d`; it holds the rate and keeps the
    reference's module indices (`head.0` dropout, `head.1` conv)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, train: bool = False, generator=None):
        return dropout2d(x, self.rate, train, generator)
