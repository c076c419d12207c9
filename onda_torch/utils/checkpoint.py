"""Checkpoint files (`onda_tpu/utils/checkpoint.py` and the snapshot listing
of `onda_tpu/methods/evaluation.py::_checkpoints_by_mtime`).

A checkpoint is written under a hidden temporary name in its directory and
renamed over the target, so a crash while writing leaves the previous
snapshot whole; AUTO_RESUME exists for exactly that crash.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path

import torch


def save_atomic(obj, path: str) -> str:
    """`torch.save(obj, path)`, with the old file replaced only once the new one is whole."""
    directory, name = os.path.split(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{name}.", suffix=".tmp", dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(obj, f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


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
