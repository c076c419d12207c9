"""Batched loading with background prefetch, and the host-to-device feed
(`onda_tpu/data/loader.py`).

`Loader` runs a few host threads that each have the dataset prepare a whole
batch (the C++ executor does the pixel work with the GIL released) into a
bounded reorder buffer. Training loaders drop the final partial batch;
evaluation loaders pad it by repeating the last row and report `valid`.

`DeviceFeeder` keeps the next batch's host-to-device copy in flight on a side
CUDA stream while the current step runs. Batches a `Loader` made with
`pin_memory` already lie in page-locked memory, written there by the
executor, and are copied from it directly; anything else is first copied
into page-locked memory. Page-locked blocks come from PyTorch's caching host
allocator, which hands a block out again only after the copies recorded on
it have completed.
"""

from __future__ import annotations

import queue
import threading
from collections import Counter
from typing import Iterator

import numpy as np
import torch

_STACK_KEYS = ("image", "label", "label_res", "label_raw", "soft_predictions", "stored_predictions")

# batches made by each path since the last reset: "executor" (the dataset's
# prepare_batch) or "collate" (per-sample __getitem__ + collate)
BATCHES: Counter = Counter()
_batches_lock = threading.Lock()


def reset_batches() -> None:
    with _batches_lock:
        BATCHES.clear()


def collate(samples: list[dict]) -> dict:
    """Stack array fields (uint8 label maps widen to int32), keep the rest as lists."""
    keys0 = set(samples[0])
    for i, s in enumerate(samples[1:], 1):
        ragged = keys0.symmetric_difference(s) & set(_STACK_KEYS)
        if ragged:
            raise ValueError(f"inconsistent batch: samples 0 and {i} disagree on array "
                             f"field(s) {sorted(ragged)} (present for some samples only)")
    batch = {}
    for key in samples[0].keys():
        vals = [s[key] for s in samples]
        if key in _STACK_KEYS:
            arr = np.stack([np.asarray(v) for v in vals])
            if arr.dtype == np.uint8 and key != "image":
                arr = arr.astype(np.int32)
            batch[key] = arr
        else:
            batch[key] = vals
    return batch


def load_batch(dataset, indices, alloc=np.empty) -> dict:
    """The batch of rows `indices`: the dataset's own batch prep where it has
    one, else its samples collated."""
    if hasattr(dataset, "prepare_batch"):
        batch, path = dataset.prepare_batch(indices, alloc=alloc), "executor"
    else:
        batch, path = collate([dataset[int(j)] for j in indices]), "collate"
    with _batches_lock:
        BATCHES[path] += 1
    return batch


def pinned_empty(shape, dtype) -> np.ndarray:
    """An uninitialised numpy array in page-locked memory (a view of a pinned tensor)."""
    return torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                       pin_memory=True).numpy()


class Loader:
    """Shuffling, prefetching batch iterator over a map-style dataset.

    `pin_memory` has the dataset write each batch into page-locked memory,
    ready for an asynchronous copy to a card."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 123,
                 drop_last: bool = False, pad_last: bool = False, num_threads: int = 2,
                 prefetch: int = 3, pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self.alloc = pinned_empty if pin_memory else np.empty

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _index_batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            order = self.rng.permutation(order)
        for start in range(0, len(order), self.batch_size):
            chunk = order[start: start + self.batch_size]
            if len(chunk) < self.batch_size:
                if self.drop_last:
                    return
                if self.pad_last:
                    pad = np.full(self.batch_size - len(chunk), chunk[-1])
                    yield np.concatenate([chunk, pad]), len(chunk)
                    return
            yield chunk, len(chunk)

    def __iter__(self) -> Iterator[dict]:
        work: "queue.Queue" = queue.Queue()
        batches = list(self._index_batches())
        for i, item in enumerate(batches):
            work.put((i, item))
        results: dict[int, dict] = {}
        cond = threading.Condition()
        # bound how far the workers run ahead of the consumer: without it a
        # whole epoch would sit in host memory
        budget = threading.Semaphore(max(self.prefetch, self.num_threads))
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                # take a permit before a batch: every batch taken and not yet
                # consumed holds one, so the lowest outstanding batch is always
                # being made or stored and the consumer cannot starve
                budget.acquire()
                if stop.is_set():
                    return
                try:
                    i, (idxs, valid) = work.get_nowait()
                except queue.Empty:
                    budget.release()
                    return
                try:
                    batch = load_batch(self.dataset, idxs, self.alloc)
                    batch["valid"] = valid
                except BaseException as exc:  # noqa: BLE001 - handed to the consumer, raised there
                    batch = exc
                with cond:
                    results[i] = batch
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self.num_threads)]
        for t in threads:
            t.start()
        try:
            for next_i in range(len(batches)):
                with cond:
                    while next_i not in results:
                        cond.wait()
                    batch = results.pop(next_i)
                budget.release()
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            # the consumer may stop mid-epoch: wake workers parked on a permit
            stop.set()
            for _ in threads:
                budget.release()


def cycle(loader) -> Iterator[dict]:
    """Endless iterator, re-iterating (and reshuffling) each epoch."""
    while True:
        yield from loader


def host_tensor(x) -> torch.Tensor:
    """x as a CPU tensor in page-locked memory: the pinned tensor a `Loader`'s
    array is a view of, else a pinned copy."""
    if isinstance(x, np.ndarray):
        root = x
        while isinstance(root, np.ndarray) and root.base is not None:
            root = root.base
        if (isinstance(root, torch.Tensor) and x.flags.c_contiguous and root.is_pinned()
                and root.data_ptr() == x.ctypes.data
                and root.numel() * root.element_size() == x.nbytes):
            return root.view(x.shape)
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x if x.is_pinned() else x.pin_memory()


def to_device(x, device) -> torch.Tensor:
    """x as a tensor on `device`. A copy to a card starts from page-locked
    memory, so it neither waits for the device nor lets the host memory go
    before the copy has read it."""
    device = torch.device(device)
    if device.type == "cuda":
        return host_tensor(x).to(device, non_blocking=True)
    return torch.as_tensor(x)


class DeviceFeeder:
    """Batches of `iterator` with their `keys` on `device`.

    On a card each batch's copies run on a side stream, one batch ahead when
    `ahead` (the copy of batch i+1 overlaps step i); the compute stream waits
    on the copy's event before it reads the batch, and the device tensors are
    marked as used by the compute stream so that their memory is not handed
    out again before the step is done. No call here waits for the device. On
    the CPU the arrays become tensors and nothing is copied."""

    def __init__(self, iterator, device, keys=("image",), ahead: bool = True):
        self.iterator = iter(iterator)
        self.device = torch.device(device)
        self.keys = keys
        self.ahead = ahead
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._next = self._put(next(self.iterator, None)) if ahead else None

    def _put(self, batch):
        if batch is None:
            return None
        out = dict(batch)
        keys = [k for k in self.keys if k in out]
        if self.stream is None:
            for key in keys:
                out[key] = torch.as_tensor(out[key])
            return out, None
        with torch.cuda.stream(self.stream):
            for key in keys:
                out[key] = host_tensor(out[key]).to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self.stream)
        return out, ready

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        item = self._next if self.ahead else self._put(next(self.iterator, None))
        if item is None:
            raise StopIteration
        batch, ready = item
        if ready is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(ready)
            for key in self.keys:
                if key in batch:
                    batch[key].record_stream(compute)
        if self.ahead:
            self._next = self._put(next(self.iterator, None))
        return batch
