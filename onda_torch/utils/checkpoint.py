"""Checkpoint files (`onda_tpu/utils/checkpoint.py` and the snapshot listing
of `onda_tpu/methods/evaluation.py`).

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


def checkpoints_by_mtime(dirpath: str, prefix: str = "adapt_state") -> list[Path]:
    """The full-state snapshots `<prefix>*.pt` in `dirpath`, oldest to newest
    by mtime. Hidden files (checkpoints still being written) never count."""
    return sorted((p for p in Path(dirpath).glob(f"{prefix}*.pt") if p.is_file()),
                  key=lambda p: p.stat().st_mtime)
