"""Building-block layers with the semantics of `onda_tpu/models/layers.py`, NCHW.

Train-mode BatchNorm takes its batch statistics from the hand-written kernel
K2 (`ops/kernels.bn_stats`); the normalisation, with the running update, is
one more kernel (`kernels.bn_apply`, eval mode's too), inside a
`torch.autograd.Function` whose backward is the closed form of
`_bn_train_bwd` in two kernels (`kernels.bn_grad_sums`, `bn_grad_dx`); on
the CPU each wrapper takes its plain version. Under data parallelism
(`parallel.distributed`) the statistics are those of the global batch, as
GSPMD computes them for the JAX step on a `data` mesh: K2 gives each rank's
raw moments in f64 (`kernels.bn_moments`), one all-reduce over the data
group sums them, and the variance is taken once from the global moments; the
backward all-reduces the per-channel sums of dy and dy·x̂ before its closed
form, and the running update uses the global count. Dropout and drop path
(SegFormer's stochastic depth) draw their masks for the global batch and
keep this rank's rows.

On a spatial axis (`parallel.spatial`) each rank holds a block of every
tensor's rows: a convolution whose window spans rows, and the ceil-mode max
pool, fetch the rows their output block reads from the ranks that hold
them; BatchNorm weights each rank's raw moments by its element count (the
blocks may be uneven) and takes the global count in its backward and its
running update; GroupNorm sums its per-sample moments over the spatial
group; dropout draws one mask for every spatial rank of a data index.

Under tensor parallelism (`parallel.tensor`) a norm whose weight is a
channel shard normalises its shard (K2 at (N, C/tp, H, W)) and gathers the
result over the model group; a sharded GroupNorm does so when its groups
fall within a shard, and otherwise gathers its input and affine first.

Convolutions and dense layers compute in an optional `compute_dtype` (bf16)
over f32 parameters, cast on entry as flax's `nn.Conv(dtype=bf16,
param_dtype=f32)` casts them; normalisations (SegFormer's LayerNorm too)
take their statistics in f32.
`rematerialized` runs a block under activation checkpointing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..ops import kernels
from ..parallel import distributed as dist
from ..parallel import spatial as S
from ..parallel import tensor as T

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
        x, weight, bias = _cast(x, dt), _cast(self.weight, dt), _cast(self.bias, dt)
        if S.active() and (self.kernel_size[0] > 1 or self.stride[0] > 1):
            return S.conv2d(x, weight, bias, self.stride, self.padding, self.dilation)
        return self._conv_forward(x, weight, bias)


class Linear(nn.Linear):
    """nn.Linear computing in `compute_dtype`, as `Conv2d` (the SE block's
    `nn.Dense(dtype=...)`)."""

    def __init__(self, *args, compute_dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(_cast(x, dt), _cast(self.weight, dt), _cast(self.bias, dt))


class _BatchNorm(torch.autograd.Function):
    """y = (x − mean)·(γ·rsqrt(var + eps)) + β, computed in f32 and cast back
    to x's type (`_bn_train_math`), in one kernel that also takes the
    `running` update. mean and var enter as constants. With batch statistics
    (`count` pixels) the backward is the full closed form
        dx = γ·inv · (dy − mean(dy) − x̂·mean(dy·x̂)),
    which already accounts for the statistics' dependence on x; with running
    statistics (`count` None, eval mode) it is dx = γ·inv·dy. Under data
    parallelism, and on a spatial axis, the means run over the global batch's
    `count` pixels (one all-reduce of the two sums, between the backward's
    two kernels), while dγ and dβ stay this rank's: the gradient bucket sums
    them over the ranks (`optim.grads`)."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, eps, count, running):
        y, inv = kernels.bn_apply(x, mean, var, weight, bias, eps, running, with_inv=True)
        ctx.save_for_backward(x, mean, inv, weight)
        ctx.count = count
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mean, inv, weight = ctx.saved_tensors
        # the kernels take dy in x's layout, whatever layout autograd hands over
        dy = dy.contiguous(memory_format=torch.contiguous_format if x.is_contiguous()
                           else torch.channels_last)
        frozen = ctx.count is None
        dgamma = dbeta = dx = None
        if not frozen or ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dbeta, dgamma = kernels.bn_grad_sums(x, dy, mean, inv)
        if ctx.needs_input_grad[0]:
            if frozen:
                dx = kernels.bn_grad_dx(x, dy, mean, inv, weight)
            else:
                sum_dy, sum_dy_xhat = dist.all_sum(dbeta, dgamma, group="pixels")
                dx = kernels.bn_grad_dx(x, dy, mean, inv, weight, sum_dy, sum_dy_xhat, ctx.count)
        return (dx, dgamma if ctx.needs_input_grad[1] else None,
                dbeta if ctx.needs_input_grad[2] else None, None, None, None, None, None)


def _normalise(x, weight, bias, mean, var, eps, count, running):
    """`_BatchNorm` where autograd needs it, else its forward kernel alone."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _BatchNorm.apply(x, weight, bias, mean, var, eps, count, running)
    return kernels.bn_apply(x, mean, var, weight, bias, eps, running)


def bn_train(x, weight, bias, eps: float = 1e-5, running=None):
    """Train-mode batch norm: returns (y, batch mean, biased batch var), the
    statistics of the global batch under data parallelism and on a spatial
    axis (each rank's raw moments weighted by its share of the pixels,
    `distributed.pixel_means`). `running` (running_mean, running_var,
    momentum) takes the running update, in place, with the unbiased variance
    of the global batch."""
    count = x.shape[0] * x.shape[2] * x.shape[3]
    total = S.global_pixels(x.shape[0], x.shape[2], x.shape[3])
    if dist.pixel_world() == 1:
        mean, var = kernels.bn_stats(x.detach())
    else:
        (moments,), _ = dist.pixel_means([kernels.bn_moments(x.detach())], count, total)
        mean, mean_sq = moments
        mean, var = mean.float(), torch.clamp(mean_sq - mean * mean, min=0.0).float()
    if running is not None:
        running = (*running, total)
    return _normalise(x, weight, bias, mean, var, eps, total, running), mean, var


class TorchBatchNorm(nn.Module):
    """BatchNorm2d with torch semantics and an explicit stats-update switch
    (`onda_tpu/models/layers.py::TorchBatchNorm`):

    * batch statistics whenever `train` is set, whatever `update_stats` says;
    * running statistics in eval mode;
    * the running update uses the unbiased batch variance n/(n−1), with a
      per-module momentum (0.1 by default); n counts the global batch under
      data parallelism and on a spatial axis;
    * with a channel shard of its weight (tensor parallelism) it normalises
      those channels of its input (cut from a whole input when it gets one)
      and returns the whole output, gathered over the model group.

    The running buffers are updated in place, by the normalising kernel.
    State names follow `torch.nn.BatchNorm2d` (`num_batches_tracked`
    included, never advanced), so reference checkpoints load with
    `strict=True`."""

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.num_features = features
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x, train: bool = False, update_stats: bool = True):
        sharded = T.shards(self) > 1
        if sharded and x.shape[1] == self.num_features:
            x = T.split_channels(x)
        if train:
            running = ((self.running_mean, self.running_var, self.momentum) if update_stats
                       else None)
            y, _, _ = bn_train(x, self.weight, self.bias, self.eps, running)
        else:
            y = _normalise(x, self.weight, self.bias, self.running_mean, self.running_var,
                           self.eps, None, None)
        return T.gather_channels(y) if sharded else y


class GroupNorm(nn.GroupNorm):
    """GroupNorm(32) (reference deeplabv2.py:141) with its statistics and
    affine in f32, as flax's `nn.GroupNorm` computes them. The ProDA head's
    returns the input's type (built with `dtype` there, so bf16 under bf16);
    the GN backbone's (`f32_out`) returns f32 whatever comes in, as flax's
    does when built with no dtype: f32 parameters promote a bf16 input, so
    that backbone passes f32 between its convolutions. On a spatial axis the
    per-sample moments are sums over the spatial group (in f64). Takes the
    BatchNorm slot's `train` and `update_stats` and ignores them."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5,
                 f32_out: bool = False):
        super().__init__(num_groups, channels, eps=eps)
        self.f32_out = f32_out

    def forward(self, x, train: bool = False, update_stats: bool = True):
        n = T.shards(self)
        weight, bias, groups = self.weight, self.bias, self.num_groups
        local = n > 1 and groups % n == 0
        if local:
            groups //= n
        elif n > 1:
            x = T.gather_channels(x)
            weight, bias = T.gather_channels(weight, 0), T.gather_channels(bias, 0)
        if S.active():
            y = _group_norm_rows(x.float(), groups, weight, bias, self.eps)
        else:
            y = F.group_norm(x.float(), groups, weight, bias, self.eps)
        y = y if self.f32_out else y.to(x.dtype)
        return T.gather_channels(y) if local else y


def _group_norm_rows(x, groups: int, weight, bias, eps: float):
    """GroupNorm of this rank's rows on a spatial axis: each sample's
    moments per group summed in f64 over the spatial group (differentiably),
    the normalisation in f32."""
    n, c, h, w = x.shape
    xs = x.reshape(n, groups, -1)
    x64 = xs.double()
    count = torch.full((n, groups), float(xs.shape[-1]), dtype=torch.float64, device=x.device)
    s1, s2, count = dist.summed(x64.sum(-1), (x64 * x64).sum(-1), count, group="spatial")
    mean = s1 / count
    var = torch.clamp(s2 / count - mean * mean, min=0.0)
    y = (xs - mean.float()[..., None]) * torch.rsqrt(var + eps).float()[..., None]
    return y.reshape(n, c, h, w) * weight.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)


def max_pool_ceil(x, window: int, stride: int, padding: int):
    """MaxPool2d with ceil_mode=True (reference deeplabv2.py:289-291): 256 → 129
    for k=3, s=2, p=1, which gives the 1/8+1 output grid. On a spatial axis
    the ceil row exists on the last rank only (`spatial.max_pool_ceil`)."""
    if S.active():
        return S.max_pool_ceil(x, window, stride, padding)
    return F.max_pool2d(x, window, stride, padding, ceil_mode=True)


def dropout2d(x, rate: float, train: bool, generator=None):
    """Channel-wise dropout (torch nn.Dropout2d) drawing from `generator`; a
    None generator in train mode disables it, as a None rng does in JAX.
    Under data parallelism every rank draws the global batch's mask and keeps
    its own rows, so the ranks' generators stay equal; the model ranks, and
    the spatial ranks, of one data index, which hold the same samples, draw
    the same mask."""
    if not train or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    return x * _batch_mask(x, (x.shape[1], 1, 1), keep, generator) / keep


def _batch_mask(x, tail, keep: float, generator):
    """A Bernoulli(keep) mask of shape (N, *tail) in x's type, drawn from
    `generator` for the global batch's rows and cut to this rank's."""
    n, r = x.shape[0], dist.data_rank()
    probs = torch.full((n * dist.data_world(), *tail), keep, device=x.device)
    return torch.bernoulli(probs, generator=generator)[r * n:(r + 1) * n].to(x.dtype)


def drop_path(x, rate: float, train: bool, generator=None):
    """Stochastic depth on a residual branch x (N, ...): each sample's
    branch dropped with probability `rate` and the kept ones scaled by
    1/(1 − rate) (timm's `drop_path`), the mask drawn from `generator` as an
    (N, 1, ..., 1) Bernoulli draw; off in eval mode, at rate 0 (no draw) and
    with a None generator. Under data parallelism every rank draws the
    global batch's mask and keeps its rows, as `dropout2d` does."""
    if not train or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    return x * _batch_mask(x, (1,) * (x.dim() - 1), keep, generator) / keep


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis with its statistics and affine in f32,
    returning the input's type (bf16 under OTHERS.PRECISION bf16)."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


class Dropout2d(nn.Module):
    """Parameter-free slot for `dropout2d`; it holds the rate and keeps the
    reference's module indices (`head.0` dropout, `head.1` conv)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, train: bool = False, generator=None):
        return dropout2d(x, self.rate, train, generator)
