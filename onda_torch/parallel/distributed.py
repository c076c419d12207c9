"""The ranks under `torchrun`, their (data × model) grid and the collectives
(`onda_tpu/parallel/distributed.py`).

The JAX package scales out with its multi-process recipe: every process runs
the same program, loads its own shard of every global batch, and GSPMD
inserts the all-reduces of the replicated step. PyTorch's idiom for that is
`torchrun --nproc-per-node N -m onda_torch.train_ouda --cfg ...`: a rank is a
JAX process with one device. TRAINING.BATCH_SIZE is the global batch, each
rank holds the same state and takes the local batch, and the step reduces
over the global batch with the helpers below, so every rank ends each step
with the same bits.

* `initialize()` is a no-op without torchrun's environment (WORLD_SIZE unset
  or 1), as JAX's is without a cluster; otherwise it joins the process group
  and, on the card, pins the rank to `cuda:LOCAL_RANK % device_count`.
* The backend is decided from the layout, before any collective
  (`choose_backend`): NCCL where every rank has a card of its own, gloo on the
  CPU and where ranks share a card (NCCL refuses two ranks on one card). Under
  gloo on a card the tensors stay on the card: a group whose ranks all hold
  one card sums and gathers them through the card's memory
  (`shared_card`), any other group through gloo, which stages them through
  the host. Either way the host waits for the card at every call.
* `all_sum` and `all_mean` reduce any number of tensors of one type in one
  all-reduce (a flat bucket). At world size 1 they return their arguments and
  make no collective call. `counts()` counts the calls and their bytes.
* Host decisions that steer collectives agree across ranks: `from_primary`
  gives every rank rank 0's value of a small host object (the checkpoints
  that EVALUATION lists, the sweep's "keep polling"), and `any_true` makes a
  failure on any rank a failure on every rank (a checkpoint that one rank
  cannot load is skipped by all). Both work under gloo (host tensors) and
  NCCL (card tensors), and make no collective call at world size 1.

Under OTHERS.TENSOR_PARALLEL = tp the ranks form a (data × model) grid
(`form_grid`, JAX's 2-D mesh): rank r sits at (r // tp, r % tp), as JAX
reshapes its device list. The data group holds the ranks of one model index
(they split the batch), the model group the ranks of one data index (they
split the channels, `parallel.tensor`, and load the same rows). Whatever
means "how the batch is split" reads the data axis (`data_world`,
`data_rank`), and `all_sum`/`all_mean` reduce over the data group unless
told otherwise; at tp 1 it is the world, so data parallelism makes the same
calls as before. `gather_model` concatenates the model ranks' channel
shards. `COUNTS` counts the calls and bytes by group.

The spatial mesh axis (`parallel.spatial`, JAX's `make_mesh(shape=(d, s),
axes=("data", "spatial"))`) arranges the ranks as a (data × spatial) grid
the same way (`form_grid(1, s)`: rank r at (r // s, r % s)): the spatial
group holds the ranks of one data index (they split the image's rows), the
data group those of one spatial index. Every sum over pixels then runs over
data × spatial, the "pixels" group (`pixel_world`, `pixel_rank`): the world
on that grid, the data group otherwise, so the other paths make the calls
they made before. The shares of the pixels may be uneven (65 feature rows
split 33/32), so a mean over pixels is a sum and a count (`pixel_means`),
and `summed` is the all-reduce that autograd differentiates (its backward
sums the gradients over the group: each rank's loss reads the sum).

Only rank 0 writes files (`is_primary`): metrics, checkpoints, prototype
pickles, samples and prediction dumps. The ranks of one model index compute
the same state; under tensor parallelism each holds its own channel shards.
"""

from __future__ import annotations

import datetime
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from . import shared_card

# collective calls made (all-reduces, broadcasts, all-gathers) and the bytes
# they moved since the last reset, by group (`counts()` adds the groups up);
# the spatial group's entry comes with its first call
COUNTS = {name: {"collectives": 0, "bytes": 0} for name in ("data", "model", "world")}
TIMEOUT = datetime.timedelta(minutes=10)  # a rank that stops waits this long, then fails
# the grid: the model and spatial axes' sizes (one of them 1) and this rank's
# data, model and spatial groups (none on an axis of 1: the data group is
# then the world)
_GRID = {"tp": 1, "sp": 1, "data": None, "model": None, "spatial": None}


def reset_counts() -> None:
    for group in COUNTS.values():
        for key in group:
            group[key] = 0


def counts() -> dict:
    """The collective calls and bytes of every group together."""
    return {key: sum(group[key] for group in COUNTS.values()) for key in ("collectives", "bytes")}


def _count(group: str, nbytes: int) -> None:
    entry = COUNTS.setdefault(group, {"collectives": 0, "bytes": 0})
    entry["collectives"] += 1
    entry["bytes"] += nbytes


def choose_backend(device_type: str, ranks_on_host: int, cards_on_host: int) -> str:
    """The process group's backend for this layout: "nccl" when the ranks run
    on cards and each of the host's ranks has a card of its own, else "gloo"
    (the CPU, or ranks that share a card: NCCL refuses two ranks on one)."""
    if device_type == "cuda" and ranks_on_host <= cards_on_host:
        return "nccl"
    return "gloo"


def initialize(device: str | torch.device = "cuda") -> torch.device:
    """Join torchrun's process group (env:// rendezvous: MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK, LOCAL_WORLD_SIZE) and return
    the device this rank computes on. A no-op returning `device` when
    WORLD_SIZE is unset or 1, or when the group is already up."""
    device = torch.device(device)
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return device
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if device.type == "cuda":
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    ranks_on_host = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    backend = choose_backend(device.type, ranks_on_host, cards)
    if device.type == "cuda" and backend == "gloo" and local_rank == 0:
        print(f"parallel: {ranks_on_host} ranks share {cards} card(s): gloo backend "
              "(NCCL needs a card per rank); the tensors stay on the card")
    dist.init_process_group(backend, timeout=TIMEOUT)
    return device


def destroy() -> None:
    """Leave the process group, if this process joined one, and its grid."""
    _GRID.update(tp=1, sp=1, data=None, model=None, spatial=None)
    if dist.is_initialized():
        shared_card.close_all()
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def form_grid(tp: int, sp: int = 1) -> None:
    """Arrange the ranks as a (world // n) × n grid, n the model axis's size
    tp or the spatial axis's sp (the other one 1): rank r at data index
    r // n and inner index r % n. Every rank makes every group, in the same
    order (`dist.new_group` is a collective). n 1 is the plain world; a grid
    already formed at (tp, sp) is kept."""
    w = world()
    if tp > 1 and sp > 1:
        raise ValueError("the spatial axis does not combine with a model axis "
                         "(OTHERS.TENSOR_PARALLEL): JAX's meshes have one or the other")
    if tp < 1 or w % tp:
        raise ValueError(f"a model axis of {tp} does not divide the {w} ranks")
    if sp < 1 or w % sp:
        raise ValueError(f"a spatial axis of {sp} does not divide the {w} ranks")
    if (tp, sp) == (_GRID["tp"], _GRID["sp"]):
        return
    n = max(tp, sp)
    data = inner = None
    if n > 1:
        r = rank()
        for d in range(w // n):
            ranks = [d * n + m for m in range(n)]
            group = dist.new_group(ranks)
            inner = group if r in ranks else inner
        for m in range(n):
            ranks = [d * n + m for d in range(w // n)]
            group = dist.new_group(ranks)
            data = group if r in ranks else data
    _GRID.update(tp=tp, sp=sp, data=data, model=inner if tp > 1 else None,
                 spatial=inner if sp > 1 else None)


def model_world() -> int:
    """The model axis's size: the ranks that share one data index."""
    return _GRID["tp"]


def model_rank() -> int:
    return rank() % _GRID["tp"]


def spatial_world() -> int:
    """The spatial axis's size: the ranks that split one data index's rows."""
    return _GRID["sp"]


def spatial_rank() -> int:
    return rank() % _GRID["sp"]


def data_world() -> int:
    """The data axis's size: the ranks that split the global batch."""
    return world() // (_GRID["tp"] * _GRID["sp"])


def data_rank() -> int:
    return rank() // (_GRID["tp"] * _GRID["sp"])


def pixel_world() -> int:
    """The ranks that split the pixels of the global batch: data × spatial."""
    return data_world() * _GRID["sp"]


def pixel_rank() -> int:
    return rank() // _GRID["tp"]


def _group(name: str):
    """(process group, size, this rank's index in it, the group's name in
    `COUNTS`) of "data", "model", "spatial", "world" or "pixels" (data ×
    spatial: the world on a spatial grid, else the data group); the group
    None is the world."""
    if name == "pixels":
        name = "world" if _GRID["sp"] > 1 else "data"
    if name == "data":
        return _GRID["data"], data_world(), data_rank(), name
    if name == "model":
        return _GRID["model"], model_world(), model_rank(), name
    if name == "spatial":
        return _GRID["spatial"], spatial_world(), spatial_rank(), name
    if name == "world":
        return None, world(), rank(), name
    raise ValueError(f"no group {name!r}")


def is_primary() -> bool:
    """True on the rank that writes files (rank 0)."""
    return rank() == 0


def backend() -> str | None:
    return dist.get_backend() if dist.is_initialized() else None


def shard_rows(n_rows: int) -> range:
    """This rank's rows of a table of n_rows: every n-th row from its data
    index, n the data axis's size, cut to n_rows // n so that every rank has
    as many (the tail that does not split evenly is dropped on every rank, as
    the JAX CLI's per-host split drops it). The model ranks of one data index
    load the same rows."""
    n = data_world()
    return range(data_rank(), n * (n_rows // n), n)


def host_local_batch_indices(n_samples: int, global_batch: int, process_index: int | None = None,
                             process_count: int | None = None, seed: int = 0,
                             shuffle: bool = True):
    """Per-epoch sample indices of this rank's slice of every global batch
    (`onda_tpu/parallel/distributed.py::host_local_batch_indices`): one
    permutation from `seed` on every rank, data index p taking the p-th
    contiguous block of each global batch; the last partial global batch is
    dropped."""
    p = data_rank() if process_index is None else process_index
    n = data_world() if process_count is None else process_count
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} hosts")
    local = global_batch // n
    order = np.random.default_rng(seed).permutation(n_samples) if shuffle else np.arange(n_samples)
    for start in range(0, n_samples - global_batch + 1, global_batch):
        yield order[start + p * local: start + (p + 1) * local]


def all_sum(*tensors: torch.Tensor, group: str = "data"):
    """The elementwise sums of `tensors` over the ranks of `group` ("data",
    the default, "model", "spatial", "world" or "pixels"), in one all-reduce
    of a flat bucket
    (the tensors must share a dtype and a device). Returns a tuple of new
    tensors, views of the bucket; in a group of one rank the arguments
    themselves, with no collective call."""
    handle, size, _, group = _group(group)
    if size == 1:
        return tensors
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise TypeError(f"all_sum: one dtype per bucket, got {sorted(map(str, dtypes))}")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _count(group, flat.numel() * flat.element_size())
    card = _card_channel(flat, handle, size, group)
    if card is not None:
        flat = card.all_sum(flat)
    else:
        dist.all_reduce(flat, group=handle)
    return tuple(part.view(t.shape) for part, t in zip(flat.split([t.numel() for t in tensors]),
                                                       tensors))


def all_mean(*tensors: torch.Tensor, group: str = "data"):
    """The means over the ranks of `group` of per-rank means over equal
    shares of the global batch: the global means. One all-reduce; the
    arguments themselves in a group of one rank."""
    _, size, _, _ = _group(group)
    if size == 1:
        return tensors
    return tuple(t / size for t in all_sum(*tensors, group=group))


def pixel_means(means, count: int, total: int, sums=()):
    """Global reductions over the pixels of the global batch, in one
    all-reduce over the "pixels" group: `means` are this rank's means over
    its `count` pixels of the global batch's `total` (tensors of one dtype
    with `sums`), `sums` its sums. Returns (the global means, the global
    sums). Off a spatial grid every data rank holds as many pixels and the
    means are averaged (`all_mean`); on one the shares may be uneven, and
    each mean enters weighted by its count."""
    means, sums = list(means), list(sums)
    if _GRID["sp"] == 1:
        out = all_sum(*means, *sums, group="pixels")
        w = data_world()
        return [m / w if w > 1 else m for m in out[:len(means)]], list(out[len(means):])
    out = all_sum(*(m * count for m in means), *sums, group="pixels")
    return [s / total for s in out[:len(means)]], list(out[len(means):])


class _Summed(torch.autograd.Function):
    """`all_sum` that autograd differentiates: every rank reads the sum, so
    each one's gradient of its own part is the sum of the ranks' gradients
    of the result."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(t.clone() for t in all_sum(*tensors, group=group))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *all_sum(*(g.contiguous() for g in grads), group=ctx.group))


def summed(*tensors: torch.Tensor, group: str):
    """`all_sum(*tensors, group=group)`, differentiable; the arguments
    themselves in a group of one rank."""
    if _group(group)[1] == 1:
        return tensors
    return _Summed.apply(group, *tensors)


def _card_channel(t: torch.Tensor, handle, size: int, group: str):
    """The card-memory channel for a card tensor under gloo (the ranks share
    cards), or None: NCCL, the CPU, or a group whose ranks hold different
    cards (it stays on gloo)."""
    if t.device.type != "cuda" or backend() != "gloo":
        return None
    return shared_card.channel(handle, size, _group(group)[2], group)


def _host_side_device() -> torch.device:
    """Where a collective's small host-side values travel: the rank's card
    under NCCL (which moves card tensors only), the host under gloo."""
    if backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _broadcast(t: torch.Tensor) -> torch.Tensor:
    _count("world", t.numel() * t.element_size())
    dist.broadcast(t, 0)
    return t


def from_primary(obj):
    """Rank 0's value of `obj`, a JSON-able host object, on every rank: two
    broadcasts, its length and its bytes. `obj` itself at world size 1."""
    if world() == 1:
        return obj
    dev = _host_side_device()
    data = json.dumps(obj).encode() if is_primary() else b""
    size = _broadcast(torch.tensor([len(data)], dtype=torch.int64, device=dev))
    buf = torch.zeros(int(size.item()), dtype=torch.uint8, device=dev)
    if is_primary():
        buf.copy_(torch.frombuffer(bytearray(data), dtype=torch.uint8))
    return json.loads(bytes(_broadcast(buf).cpu().numpy()).decode())


def any_true(flag: bool) -> bool:
    """Whether `flag` is true on any rank, on every rank (one all-reduce of a
    count). `flag` itself at world size 1."""
    if world() == 1:
        return bool(flag)
    count = torch.tensor([int(bool(flag))], dtype=torch.int32, device=_host_side_device())
    return int(all_sum(count, group="world")[0].item()) > 0


def _gather(x: torch.Tensor, group: str, dim: int) -> torch.Tensor:
    """The ranks of `group`'s x (equal shapes), concatenated along `dim` in
    their order: a group that shares a card gathers them through its memory
    (`shared_card`); otherwise an all-reduce of a zero-filled bucket (every
    rank's slot but its own zero: the sum is exact) gathers them, which gloo
    can do for card tensors too (it moves them by all-reduce and broadcast
    only). `x` itself in a group of one rank."""
    handle, size, index, group = _group(group)
    if size == 1:
        return x
    card = _card_channel(x, handle, size, group)
    if card is not None:
        _count(group, size * x.numel() * x.element_size())
        out = card.gather(x)
    else:
        out = torch.zeros((size, *x.shape), dtype=x.dtype, device=x.device)
        out[index] = x
        out = all_sum(out, group=group)[0]
    out = out.movedim(0, dim)
    return out.reshape(*x.shape[:dim], size * x.shape[dim], *x.shape[dim + 1:])


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every data index's x (equal shapes), concatenated along the first
    axis in data order: the global batch of per-rank slices (the model ranks
    of a data index hold the same rows)."""
    return _gather(x, "data", 0)


def gather_spatial(x: torch.Tensor) -> torch.Tensor:
    """The spatial ranks' x (equal shapes), stacked in spatial order:
    (spatial_world(), *x.shape), on every rank of the spatial group."""
    return _gather(x[None], "spatial", 0)


def gather_model(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The model ranks' channel shards of x, concatenated along `dim` in
    model order: the whole tensor, on every rank of the model group."""
    return _gather(x, "model", dim)
