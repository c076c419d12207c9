"""OTHERS.TENSOR_PARALLEL: the channel-sharding rule and the autograd pieces
that carry activations across the model group
(`onda_tpu/parallel/mesh.py::tensor_parallel_shardings`).

JAX shards the LAST (channel) axis of every state leaf with at least
`min_dim` channels that the model axis divides, and replicates the rest;
GSPMD then adds the collectives. In the port's layouts that axis is C_out,
axis 0 of every tensor (`models.convert.channel_axis`): a conv weight's
(C_out, C_in, kh, kw), a Linear's (out, in), and the only axis of BN/GN
vectors, conv biases and BN running statistics. `tensor_parallel_plan`
applies the rule to a state's names, `shard_state` cuts a whole state into
one model rank's shards, and `gather_state` (a collective every rank of the
model group joins) puts them back together.

A sharded Conv2d or Linear computes its C_out shard from the whole input,
which enters through `copy_to_model` (identity forward; the backward sums
the input gradient over the model group: each rank saw only its output
channels). The norm after it runs on the shard and its output is gathered
(`gather_channels`: all-gather along the channels; the backward keeps this
rank's slice, since everything after the gather is computed alike on every
model rank). This is Megatron's pair of column-parallel layers over the
model group. The models call `fan_in` and `gather_channels` where a layer
needs every channel: the residual add, the concat, the next conv, the SE's
mean, the classifier.

The prototypes (C, F) and `global_var` stay whole: JAX shards them on F,
but K1 reads every feature of a pixel and they are 19×256 floats. Monitor
windows and the dropout generator stay whole, as in JAX.
"""

from __future__ import annotations

import torch

from ..models.convert import channel_axis
from . import distributed as dist

MIN_DIM = 128  # JAX's min_dim: narrower channel axes stay whole


def tensor_parallel_plan(state: dict, tp: int, min_dim: int = MIN_DIM) -> dict:
    """name → the axis to shard, for every tensor of `state` (name → tensor
    or shape) that JAX's rule shards on a model axis of `tp`: its channel
    axis has at least `min_dim` entries and `tp` divides them. The names
    left out stay whole (replicated)."""
    plan = {}
    for name, t in state.items():
        shape = tuple(getattr(t, "shape", t))
        if not shape:
            continue
        axis = channel_axis(len(shape))
        if shape[axis] >= min_dim and shape[axis] % tp == 0:
            plan[name] = axis
    return plan


def shard_state(full: dict, plan: dict, model_rank: int, tp: int) -> dict:
    """The tensors of a whole state (a state_dict, or any tree keyed by its
    names) as model rank `model_rank` holds them: each planned one cut to
    its block along the planned axis (the ranks hold consecutive blocks in
    model order, as JAX's NamedSharding lays them), the others as they are."""
    out = dict(full)
    for k, axis in plan.items():
        if k in full:
            c = full[k].shape[axis] // tp
            out[k] = full[k].narrow(axis, model_rank * c, c).clone()
    return out


def gather_state(state: dict, plan: dict) -> dict:
    """The whole tensors of a state held in shards (`shard_state`'s output on
    each model rank): one gather over the model group per dtype, a
    collective every rank of the group joins. The unplanned tensors are
    returned as they are; on a model axis of 1, the state itself."""
    if dist.model_world() == 1:
        return dict(state)
    out = dict(state)
    by_dtype = {}
    for k in state:
        if k in plan:
            by_dtype.setdefault(state[k].dtype, []).append(k)
    tp = dist.model_world()
    for keys in by_dtype.values():
        flat = torch.cat([state[k].movedim(plan[k], 0).reshape(-1) for k in keys])
        rows = dist.gather_model(flat, dim=0).view(tp, -1)  # row m: model rank m's shards
        start = 0
        for k in keys:
            shard = state[k].movedim(plan[k], 0)
            n = shard.numel()
            whole = rows[:, start:start + n].reshape(tp * shard.shape[0], *shard.shape[1:])
            out[k] = whole.movedim(0, plan[k]).contiguous()
            start += n
    return out


class ShardedModel:
    """What an adapter or trainer that holds a model's tensors needs on a
    grid: `plan_shards` records the whole shapes of the model's tensors
    (`full_shapes`) and the plan of those each rank holds as a channel shard
    (`plan`, empty at tp 1); `_shard` cuts a tree of whole tensors into this
    rank's and `_whole` gathers them, both the tree itself without a plan.
    Either takes another plan for another model's tree (the discriminators)."""

    def plan_shards(self, trees: dict, tp: int) -> None:
        self.full_shapes = {k: tuple(v.shape) for tree in trees.values() for k, v in tree.items()}
        self.plan = tensor_parallel_plan(self.full_shapes, tp) if tp > 1 else {}

    def _shard(self, tree: dict, plan: dict | None = None) -> dict:
        """This rank's tensors of a tree of whole ones."""
        plan = self.plan if plan is None else plan
        return shard_state(tree, plan, dist.model_rank(), dist.model_world()) if plan else tree

    def _whole(self, tree: dict, plan: dict | None = None) -> dict:
        """The whole tensors of a tree of this rank's: a gather over the
        model group that every rank joins."""
        plan = self.plan if plan is None else plan
        return gather_state(tree, plan) if plan else tree


def shards(module) -> int:
    """How many model ranks share the output channels of a Conv2d, Linear,
    BatchNorm or GroupNorm: its declared width over its weight's (1: whole)."""
    full = next(getattr(module, a) for a in ("out_channels", "out_features", "num_features",
                                             "num_channels") if hasattr(module, a))
    return full // module.weight.shape[0]


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model group."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return dist.all_sum(dy.contiguous(), group="model")[0]


class _GatherChannels(torch.autograd.Function):
    """All-gather along `dim` forward; the backward keeps this rank's slice."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.width = dim, x.shape[dim]
        return dist.gather_model(x.contiguous(), dim)

    @staticmethod
    def backward(ctx, dy):
        start = dist.model_rank() * ctx.width
        return dy.narrow(ctx.dim, start, ctx.width).contiguous(), None


class _SplitChannels(torch.autograd.Function):
    """This rank's slice along `dim` forward; the backward all-gathers the
    gradient (each rank has its channels' share of a whole tensor's)."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        width = x.shape[dim] // dist.model_world()
        return x.narrow(dim, dist.model_rank() * width, width).contiguous()

    @staticmethod
    def backward(ctx, dy):
        return dist.gather_model(dy.contiguous(), ctx.dim), None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """x, whole on every model rank, entering a layer sharded on its output."""
    return _CopyToModel.apply(x) if dist.model_world() > 1 else x


def gather_channels(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The whole tensor from this rank's channel shard x (every rank of the
    model group calls it)."""
    return _GatherChannels.apply(x, dim) if dist.model_world() > 1 else x


def split_channels(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's channels of a whole tensor x (for a sharded norm whose
    input no sharded layer made)."""
    return _SplitChannels.apply(x, dim) if dist.model_world() > 1 else x


def fan_in(x: torch.Tensor, *modules):
    """x as each of `modules` takes it (None: not there): through one
    `copy_to_model`, shared, for the sharded ones, so that their input
    gradients are summed in one all-reduce; as it is for the whole ones,
    whose gradient every model rank already has in full."""
    through = None
    out = []
    for m in modules:
        if m is not None and shards(m) > 1:
            through = copy_to_model(x) if through is None else through
            out.append(through)
        else:
            out.append(x)
    return out
