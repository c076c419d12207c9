"""Collectives among ranks that share one card, through the card's own
memory (CUDA IPC), for the layouts where NCCL cannot run.

NCCL refuses two ranks on one card, so such ranks join a gloo group
(`distributed.choose_backend`), and gloo moves a card tensor by copying it
to the host, through a socket and back: under 1 GB/s, and milliseconds for
the smallest call, on an H100's host (chip_smoke.py's phase 13.0 times both
ways). A group whose ranks all hold the same card instead exchanges
its card tensors in place: each rank owns a staging buffer on the card and
maps every other rank's (`torch.multiprocessing`'s CUDA IPC handles, swapped
once over the gloo group); the ranks meet at a host barrier of counters in a
file they all map, and every rank then reads the others' buffers. A call:

    copy my part into my buffer → wait for my stream → barrier →
    read (gather) or add in rank order (sum) every rank's buffer →
    wait for my stream → barrier (the buffers may be written again)

so every rank gets the same bits, whatever the order the ranks arrive in.
A tensor larger than the buffer goes in pieces. The host waits for the card
twice a call; the copies run at the card's memory rate.

`channel(group)` makes a group's channel on the first collective of card
tensors that the group makes (a collective every rank of the group joins),
or None when the ranks hold different cards (the group then stays on gloo).
Ranks that share a card and cannot make the channel (a buffer that cannot
be allocated, a handle that cannot be mapped) all raise with the error: gloo's
host staging would be two orders of magnitude slower. `close_all()`
releases them.
"""

from __future__ import annotations

import mmap
import os
import socket
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

BUFFER_BYTES = 256 * 2**20  # a rank's staging buffer on the card
TIMEOUT_S = 600.0           # a barrier that waits this long fails

_channels: dict = {}  # group key → SharedCard, or None (ranks on different cards: gloo)
STATS = {"host_waits": 0}  # the host's waits for its stream, two a call


class SharedCard:
    """The card-memory channel of one group of ranks on one card: `buffer`
    is this rank's staging buffer, `peers` every rank's (this one's among
    them, in rank order), `flags` the barrier's counters (an int64 array of
    one entry a rank, which every rank maps). Over host tensors (buffers
    and peers on the CPU) it waits for no stream."""

    def __init__(self, index: int, buffer: torch.Tensor, peers: list, flags: np.ndarray,
                 group=None, mapping=None):
        self.group, self.index, self.size = group, index, len(peers)
        self.buffer, self.peers = buffer, peers
        self.flags, self._map = flags, mapping
        self.generation = 0

    def _meet(self) -> None:
        """Wait for this rank's stream, then for every rank of the group."""
        if self.buffer.is_cuda:
            torch.cuda.current_stream().synchronize()
            STATS["host_waits"] += 1
        self.generation += 1
        self.flags[self.index] = self.generation
        deadline = time.monotonic() + TIMEOUT_S
        while (self.flags < self.generation).any():
            if time.monotonic() > deadline:
                raise RuntimeError(f"a rank of this card's group stopped (barrier "
                                   f"{self.generation} waited {TIMEOUT_S:.0f} s)")
            time.sleep(0)  # let the rank's other threads (its loaders) run

    def _pieces(self, flat: torch.Tensor):
        """(start, the piece's view in every rank's buffer) for each piece of
        a 1-D tensor that fits the buffer, once this rank's piece is in its
        buffer and every rank's is in theirs."""
        step = self.buffer.numel() // flat.element_size()
        for start in range(0, flat.numel(), step):
            part = flat[start:start + step]
            nbytes = part.numel() * part.element_size()
            self.buffer[:nbytes].view(flat.dtype).copy_(part)
            self._meet()
            yield start, [peer[:nbytes].view(flat.dtype) for peer in self.peers]
            self._meet()

    def all_sum(self, flat: torch.Tensor) -> torch.Tensor:
        """The sum over the group's ranks of a contiguous 1-D card tensor, on
        every rank the same bits (the ranks' parts added in rank order)."""
        out = torch.empty_like(flat)
        for start, parts in self._pieces(flat):
            acc = out[start:start + parts[0].numel()]
            acc.copy_(parts[0])
            for part in parts[1:]:
                acc.add_(part)
        return out

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The group's ranks' x (equal shapes), stacked in rank order:
        (size, *x.shape)."""
        flat = x.contiguous().view(-1)
        out = torch.empty((self.size, flat.numel()), dtype=x.dtype, device=x.device)
        for start, parts in self._pieces(flat):
            for j, part in enumerate(parts):
                out[j, start:start + part.numel()].copy_(part)
        return out.view(self.size, *x.shape)

    def close(self) -> None:
        """Drop the other ranks' buffers, then (once every rank has) this
        rank's own."""
        self.peers = []
        torch.cuda.synchronize()
        dist.barrier(group=self.group)
        self.flags = None
        self._map.close()
        self.buffer = None


def _shared_flags(group, index: int, size: int, path: str):
    """(mapping, its int64 counters) of a zeroed file of `size` counters
    that every rank of `group` maps; the file is gone once all have."""
    if index == 0:
        with open(path, "wb") as f:
            f.write(b"\0" * 8 * size)
    dist.barrier(group=group)
    with open(path, "r+b") as f:
        mapping = mmap.mmap(f.fileno(), 8 * size)
    dist.barrier(group=group)
    if index == 0:
        os.unlink(path)
    return mapping, np.ndarray((size,), dtype=np.int64, buffer=mapping)


def _where() -> tuple:
    return socket.gethostname(), torch.cuda.current_device()


def channel(group, size: int, index: int, name: str):
    """The card-memory channel of `group` (None: the world), named `name`,
    for card tensors: made on first use, or None when its ranks hold
    different cards (they stay on gloo). Every step that can fail on one
    rank (the buffer, mapping the others') is agreed on before any rank goes
    on, and a failure raises on every rank."""
    ranks = (dist.get_process_group_ranks(group) if group is not None
             else list(range(dist.get_world_size())))
    key = f"{os.environ.get('MASTER_PORT', '0')}_{name}_{'-'.join(map(str, ranks))}"
    if key in _channels:
        return _channels[key]
    places = [None] * size
    dist.all_gather_object(places, _where(), group=group)
    if len(set(places)) != 1:
        _channels[key] = None
        return None
    from torch.multiprocessing.reductions import reduce_tensor

    buffer = handle = peers = None
    error = ""
    try:
        buffer = torch.empty(BUFFER_BYTES, dtype=torch.uint8,
                             device=torch.device("cuda", places[0][1]))
        handle = reduce_tensor(buffer)
    except Exception as exc:  # noqa: BLE001 - agreed on, then raised below
        error = repr(exc)
    handles = [None] * size
    dist.all_gather_object(handles, handle, group=group)
    if all(h is not None for h in handles):
        try:
            peers = [buffer if j == index else rebuild(*args)
                     for j, (rebuild, args) in enumerate(handles)]
        except Exception as exc:  # noqa: BLE001
            error = repr(exc)
    errors = [None] * size
    dist.all_gather_object(errors, error, group=group)
    if any(errors):
        raise RuntimeError(f"the {size} ranks of the {name} group share card {places[0][1]} but "
                           f"cannot exchange card tensors through its memory (CUDA IPC): "
                           + "; ".join(f"rank {j}: {e}" for j, e in enumerate(errors) if e))
    path = os.path.join(tempfile.gettempdir(), f"onda_card_{key}.flags")
    mapping, flags = _shared_flags(group, index, size, path)
    made = SharedCard(index, buffer, peers, flags, group=group, mapping=mapping)
    if index == 0:
        print(f"parallel: the {size} ranks of the {name} group share card {places[0][1]}: card "
              "tensors move through the card's memory (CUDA IPC)")
    _channels[key] = made
    return made


def close_all() -> None:
    for made in _channels.values():
        if made is not None:
            made.close()
    _channels.clear()
