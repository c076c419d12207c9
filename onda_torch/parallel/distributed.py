"""Data parallelism across ranks: one process per rank under `torchrun`
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
  gloo on a card the tensors stay on the card; gloo stages them through the
  host, which synchronises the host with the card at every call.
* `all_sum` and `all_mean` reduce any number of tensors of one type in one
  all-reduce (a flat bucket). At world size 1 they return their arguments and
  make no collective call. `COUNTS` counts the calls and their bytes.

Only rank 0 writes files (`is_primary`): metrics, checkpoints, prototype
pickles, samples and prediction dumps. Every rank computes the same state.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

# all-reduce calls made and the bytes they reduced, since the last reset
COUNTS = {"collectives": 0, "bytes": 0}
TIMEOUT = datetime.timedelta(minutes=10)  # a rank that stops waits this long, then fails


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


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
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the rank that writes files (rank 0)."""
    return rank() == 0


def backend() -> str | None:
    return dist.get_backend() if dist.is_initialized() else None


def shard_rows(n_rows: int) -> range:
    """This rank's rows of a table of n_rows: every world-th row from its
    rank, cut to n_rows // world so that every rank has as many (the tail
    that does not split evenly is dropped on every rank, as the JAX CLI's
    per-host split drops it)."""
    w = world()
    return range(rank(), w * (n_rows // w), w)


def host_local_batch_indices(n_samples: int, global_batch: int, process_index: int | None = None,
                             process_count: int | None = None, seed: int = 0,
                             shuffle: bool = True):
    """Per-epoch sample indices of this rank's slice of every global batch
    (`onda_tpu/parallel/distributed.py::host_local_batch_indices`): one
    permutation from `seed` on every rank, rank p taking the p-th contiguous
    block of each global batch; the last partial global batch is dropped."""
    p = rank() if process_index is None else process_index
    n = world() if process_count is None else process_count
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} hosts")
    local = global_batch // n
    order = np.random.default_rng(seed).permutation(n_samples) if shuffle else np.arange(n_samples)
    for start in range(0, n_samples - global_batch + 1, global_batch):
        yield order[start + p * local: start + (p + 1) * local]


def all_sum(*tensors: torch.Tensor):
    """The elementwise sums of `tensors` over the ranks, in one all-reduce of
    a flat bucket (the tensors must share a dtype and a device). Returns a
    tuple of new tensors, views of the bucket; at world size 1 the arguments
    themselves, with no collective call."""
    if world() == 1:
        return tensors
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise TypeError(f"all_sum: one dtype per bucket, got {sorted(map(str, dtypes))}")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    COUNTS["collectives"] += 1
    COUNTS["bytes"] += flat.numel() * flat.element_size()
    dist.all_reduce(flat)
    return tuple(part.view(t.shape) for part, t in zip(flat.split([t.numel() for t in tensors]),
                                                       tensors))


def all_mean(*tensors: torch.Tensor):
    """The means over the ranks of per-rank means over equal shares of the
    global batch: the global means. One all-reduce; the arguments themselves
    at world size 1."""
    w = world()
    if w == 1:
        return tensors
    return tuple(t / w for t in all_sum(*tensors))


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's x (equal shapes), concatenated along the first axis in
    rank order: the global batch of per-rank slices. An all-reduce of a
    zero-filled bucket, so that gloo can gather card tensors too."""
    w = world()
    if w == 1:
        return x
    bucket = torch.zeros((w, *x.shape), dtype=x.dtype, device=x.device)
    bucket[rank()] = x
    return all_sum(bucket)[0].reshape(w * x.shape[0], *x.shape[1:])
