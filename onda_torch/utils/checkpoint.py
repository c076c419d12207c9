"""Checkpoint files (`onda_tpu/utils/checkpoint.py` and the snapshot listing
of `onda_tpu/methods/evaluation.py::_checkpoints_by_mtime`).

A checkpoint is written under a hidden temporary name in its directory and
renamed over the target, so a crash while writing leaves the previous
snapshot whole; AUTO_RESUME exists for exactly that crash. The file gets the
mode a plain `torch.save` would give it (0o666 less the umask).

OTHERS.ASYNC_SAVE (`save_atomic(..., wait=False)`): the call returns once
every tensor of the object has a copy in host memory, and the disk write
goes on in a background thread. The caller may then change its tensors in
place at once. A tensor on the card is copied on the current stream (the one
that produced it, so the copy is ordered after its writers and before any
later in-place kernel) into a pinned host buffer kept per path, and the
stream is synchronised before the call returns. At most one write per path
is in flight: a new save to the path waits for the earlier write, and so
does any load of it (`load`, `wait_for`). `wait_for_saves()` drains every
write and raises a writer's exception; a failed write is also raised by the
next save.

Under data parallelism every rank holds the same state and rank 0 alone
writes: `save_atomic` returns at once on the other ranks.
"""

from __future__ import annotations

import atexit
import copy
import os
import secrets
import threading
from pathlib import Path

import torch

from ..parallel import distributed as dist

_lock = threading.Lock()
_inflight: dict[str, "_Write"] = {}   # path → its background write
_failed: list[tuple[str, BaseException]] = []  # writes whose error is not raised yet
_pinned: dict[str, list[torch.Tensor]] = {}   # path → the host buffers of its snapshots


class _Write:
    def __init__(self, obj, path: str):
        self.error: BaseException | None = None
        self.thread = threading.Thread(target=self._run, args=(obj, path),
                                       name=f"save {os.path.basename(path)}")
        self.thread.start()

    def _run(self, obj, path):
        try:
            _write(obj, path)
        except BaseException as exc:  # noqa: BLE001 - kept and raised by the caller's barrier
            self.error = exc


def _write(obj, path: str) -> None:
    """`torch.save(obj)` to a hidden temporary in path's directory, then
    `os.replace` onto path. The temporary is opened with mode 0o666, so the
    kernel applies the umask as it does for a plain `torch.save`."""
    directory, name = os.path.split(path)
    os.makedirs(directory, exist_ok=True)
    while True:
        tmp = os.path.join(directory, f".{name}.{secrets.token_hex(4)}.tmp")
        try:
            fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o666)
            break
        except FileExistsError:
            continue
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(obj, f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _drain(path: str) -> None:
    """Wait for the write in flight to path, if any; its error is kept."""
    with _lock:
        pending = _inflight.pop(path, None)
    if pending is not None:
        pending.thread.join()
        if pending.error is not None:
            with _lock:
                _failed.append((path, pending.error))


def _raise_failed() -> None:
    """Raise the error of a failed write: one recorded by a barrier, or one
    of a write to any path that has ended."""
    with _lock:
        ended = [p for p, w in _inflight.items() if not w.thread.is_alive()]
    for path in ended:
        _drain(path)
    with _lock:
        failed = list(_failed)
        _failed.clear()
    if failed:
        path, exc = failed[0]
        others = f" (and {len(failed) - 1} more failed writes)" if len(failed) > 1 else ""
        raise RuntimeError(f"the background write of {path} failed{others}") from exc


def _snapshot(obj, path: str):
    """obj with every tensor copied to host memory: card tensors into the
    pinned buffers kept for path (the n-th card tensor reuses the n-th buffer
    while its shape and type stay the same), host tensors cloned; other
    leaves deep-copied."""
    buffers = _pinned.setdefault(path, [])
    n_card = 0
    streams = set()

    def copy_of(x):
        nonlocal n_card
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.device.type == "cuda":
                if n_card == len(buffers):
                    buffers.append(None)
                dst = buffers[n_card]
                if dst is None or dst.shape != x.shape or dst.dtype != x.dtype:
                    dst = buffers[n_card] = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                n_card += 1
                dst.copy_(x, non_blocking=True)  # on the stream that produced x
                streams.add(torch.cuda.current_stream(x.device))
                return dst
            return x.clone()
        if isinstance(x, dict):
            return {k: copy_of(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(copy_of(v) for v in x) if type(x) in (list, tuple) else [
                copy_of(v) for v in x]
        return copy.deepcopy(x)

    snap = copy_of(obj)
    del buffers[n_card:]
    for stream in streams:  # the snapshot is whole before the caller goes on
        stream.synchronize()
    return snap


def save_atomic(obj, path: str, wait: bool = True) -> str:
    """`torch.save(obj, path)`, with the old file replaced only once the new
    one is whole. With `wait=False` the call returns once obj's tensors are
    copied to host memory, and the write goes on in the background. Either
    way an earlier write to path is waited for first, and an earlier failed
    write is raised. Only rank 0 writes (the other ranks return the path)."""
    path = os.path.abspath(path)
    if not dist.is_primary():
        return path
    _drain(path)
    _raise_failed()
    if wait:
        _write(obj, path)
        return path
    snap = _snapshot(obj, path)
    with _lock:
        _inflight[path] = _Write(snap, path)
    return path


def wait_for(path) -> None:
    """The load barrier: wait for a write in flight to path (its error, if
    any, is raised by the next save or by `wait_for_saves`)."""
    _drain(os.path.abspath(str(path)))


def load(path, **kwargs):
    """`torch.load(path, **kwargs)` once no write to path is in flight."""
    wait_for(path)
    return torch.load(path, **kwargs)


def wait_for_saves() -> None:
    """Wait for every write in flight, free the pinned buffers, and raise if
    any write failed. The CLI calls it before it returns."""
    with _lock:
        paths = list(_inflight)
    for path in paths:
        _drain(path)
    _pinned.clear()
    _raise_failed()


def _atexit_warn_unfinished() -> None:
    # the writer threads are not daemons, so the interpreter has waited for
    # them by now: what is left is a write nobody waited for, or its error
    with _lock:
        unwaited = list(_inflight)
    if unwaited or _failed:
        try:
            wait_for_saves()
            print(f"WARNING: checkpoint writes {unwaited} finished after the program stopped "
                  "waiting; call onda_torch.utils.checkpoint.wait_for_saves() before exiting.",
                  flush=True)
        except Exception as exc:  # noqa: BLE001
            print(f"WARNING: a background checkpoint write failed and nobody waited for it: "
                  f"{exc!r} ({exc.__cause__!r})", flush=True)


atexit.register(_atexit_warn_unfinished)


EVALUATION_PREFIXES = ("adapt_state", "model_train", "advent_state")


def checkpoints_by_mtime(dirpath: str, prefixes: tuple = EVALUATION_PREFIXES,
                         allow_pth: bool = True) -> list[Path]:
    """The checkpoints in `dirpath` the port can load, oldest to newest by
    mtime: `.pt` files whose name starts with one of `prefixes` (by default
    every snapshot a prototype runner loads: full-state `adapt_state*`,
    `model_train*` and ADVENT's `advent_state*`, whose student it lifts) and,
    with `allow_pth`, student-only `*.pth` files (SEGMENT's
    `model_train_*.pth` among them). AUTO_RESUME, an exact resume, lists the
    adapter's own snapshots only. Hidden files (checkpoints still being
    written) never count."""
    def compatible(p: Path) -> bool:
        if p.name.startswith(".") or not p.is_file():
            return False
        return (p.name.startswith(tuple(prefixes)) and p.suffix == ".pt") or (
            allow_pth and p.suffix == ".pth")

    return sorted((p for p in Path(dirpath).iterdir() if compatible(p)),
                  key=lambda p: p.stat().st_mtime)
