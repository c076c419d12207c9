"""Building-block layers with the semantics of `onda_tpu/models/layers.py`, NCHW.

Train-mode BatchNorm takes its batch statistics from the hand-written kernel
K2 (`ops/kernels.bn_stats`) inside a `torch.autograd.Function` whose backward
is the closed form of `_bn_train_bwd` in plain torch.

Convolutions and dense layers compute in an optional `compute_dtype` (bf16)
over f32 parameters, cast on entry as flax's `nn.Conv(dtype=bf16,
param_dtype=f32)` casts them; normalisations take their statistics in f32.
`rematerialized` runs a block under activation checkpointing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..ops import kernels

def rematerialized(block, x, train: bool, update_stats: bool):
    """block(x, train, update_stats) with its activations dropped after the
    forward and recomputed in the backward (`nn.remat` per bottleneck in the
    JAX model). The recompute runs the block on the parameters and buffers
    the forward ran it on, taken when it is called, so it sees the step's
    tensors even after a `functional_call` around the model has put the
    module's own back; and it leaves the BatchNorm running statistics alone,
    so a step moves them by one momentum update, as the functional `nn.remat`
    does. The parameters enter the checkpoint as arguments; the buffers,
    which the forward updates in place, are held by reference (train mode
    normalises by the batch's statistics, so the recompute does not read
    them)."""
    params = dict(block.named_parameters())
    buffers = dict(block.named_buffers())
    calls = []  # the forward is the first call of `run`, a recompute any later one

    def run(x, *tensors):
        first = not calls
        calls.append(None)
        return functional_call(block, {**buffers, **dict(zip(params, tensors))},
                               (x, train, update_stats and first))

    return checkpoint(run, x, *params.values(), use_reentrant=False, preserve_rng_state=False)


def _cast(t, dtype):
    return t if t is None or dtype is None else t.to(dtype)


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in `compute_dtype` (None: the input's) over its
    f32 weight and bias; their gradients reach the f32 tensors through the
    cast (`onda_tpu/models/layers.py::conv`)."""

    def __init__(self, *args, compute_dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return self._conv_forward(_cast(x, dt), _cast(self.weight, dt), _cast(self.bias, dt))


class Linear(nn.Linear):
    """nn.Linear computing in `compute_dtype`, as `Conv2d` (the SE block's
    `nn.Dense(dtype=...)`)."""

    def __init__(self, *args, compute_dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(_cast(x, dt), _cast(self.weight, dt), _cast(self.bias, dt))


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
    """GroupNorm(32) (reference deeplabv2.py:141) with its statistics and
    affine in f32, as flax's `nn.GroupNorm` computes them. The ProDA head's
    returns the input's type (built with `dtype` there, so bf16 under bf16);
    the GN backbone's (`f32_out`) returns f32 whatever comes in, as flax's
    does when built with no dtype: f32 parameters promote a bf16 input, so
    that backbone passes f32 between its convolutions. Takes the BatchNorm
    slot's `train` and `update_stats` and ignores them."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5,
                 f32_out: bool = False):
        super().__init__(num_groups, channels, eps=eps)
        self.f32_out = f32_out

    def forward(self, x, train: bool = False, update_stats: bool = True):
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)
        return y if self.f32_out else y.to(x.dtype)


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
