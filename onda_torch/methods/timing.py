"""Stage timers and throughput meters (`onda_tpu/methods/timing.py`).

Host wall-clock between marks; a caller that wants device time synchronises
before marking (reference utils/monitoring.py:139-161).
"""

from __future__ import annotations

import time
from collections import deque


class SpeedMeter:
    """Sliding-window stage timer (host wall-clock between marks)."""

    def __init__(self, limit: int = 10, enabled: bool = True):
        self.enabled = enabled
        self.limit = limit
        self.windows: dict[str, deque] = {}
        self._last = time.perf_counter()

    def reset(self):
        self._last = time.perf_counter()

    def mark(self, stage: str):
        if not self.enabled:
            return
        now = time.perf_counter()
        self.windows.setdefault(stage, deque(maxlen=self.limit)).append(now - self._last)
        self._last = now

    def averages(self) -> dict:
        return {f"time/{k}": sum(v) / len(v) for k, v in self.windows.items() if v}


class ThroughputMeter:
    """frames/sec over wall-clock, with warmup exclusion."""

    def __init__(self):
        self.frames = 0
        self.t0 = None

    def start(self):
        self.t0 = time.perf_counter()
        self.frames = 0

    def count(self, n: int):
        self.frames += n

    def fps(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.frames / dt if dt > 0 else 0.0


def samples_due(samples_every: int, i_iter: int, n_target: int) -> bool:
    """Whether epoch-boundary sample rendering fires at step ``i_iter``: the
    reference's double-modulo cadence (reference methods/prototypes.py:516),
    which fires every epoch for any positive setting; 0 or less opts out."""
    return samples_every > 0 and (i_iter + 1) % n_target % samples_every == 0
