"""Sliding-window confidence monitor held as device tensors (`onda_tpu/ops/monitor.py`).

Reimplements the reference `Monitor` (framework/utils/monitoring.py:7-96) as
fixed-shape ring buffers that never leave the device:

* ``avg``  = median of the current window; 1 for a key never added;
* ``exp_avg`` = exponential moving average with ``exp_const``; 1 before the first add;
* ``dev_avg`` = one-step derivative of a windowed mean (hamming | median |
  mean) over the last ``limit`` values; 0 until the window is full.

Every read and update is tensor arithmetic (no host sync); ``add`` with
``enable`` False leaves the state as it was (the reference's frozen monitor).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass
class MonitorState:
    ring: torch.Tensor     # (K, W) recorded values, ring order
    count: torch.Tensor    # (K,)  total adds, saturating at W (int64)
    ptr: torch.Tensor      # (K,)  next write slot (int64)
    exp: torch.Tensor      # (K,)  exponential moving average
    started: torch.Tensor  # (K,)  bool — key has been added at least once


class Monitor:
    """Static definition (keys, window size, window function) + state ops."""

    def __init__(self, keys: Sequence[str], limit: int = 200, exp_const: float = 0.01,
                 dev_func: str = "hamming", device="cpu"):
        self.keys = tuple(keys)
        self.index = {k: i for i, k in enumerate(self.keys)}
        self.limit = int(limit)
        self.exp_const = float(exp_const)
        self.dev_func = dev_func
        self.device = torch.device(device)
        sig = np.hamming(self.limit - 1)  # reference monitoring.py:24-25
        self._signal = torch.tensor(sig, dtype=torch.float32, device=self.device)
        self._signal_sum = float(sig.sum())
        self._slots = torch.arange(self.limit, device=self.device)

    def init(self) -> MonitorState:
        k, w, dev = len(self.keys), self.limit, self.device
        return MonitorState(
            ring=torch.zeros((k, w), dtype=torch.float32, device=dev),
            count=torch.zeros((k,), dtype=torch.long, device=dev),
            ptr=torch.zeros((k,), dtype=torch.long, device=dev),
            exp=torch.ones((k,), dtype=torch.float32, device=dev),
            started=torch.zeros((k,), dtype=torch.bool, device=dev),
        )

    # --- updates ----------------------------------------------------------
    def add(self, state: MonitorState, key: str, value, enable=True) -> MonitorState:
        """Record `value` under `key`; no change when `enable` is False."""
        i = self.index[key]
        value = torch.as_tensor(value, dtype=torch.float32, device=self.device)
        if isinstance(enable, bool):  # decided on the host: no device tensor, no copy
            if not enable:
                return state

            def pick(new, old):
                return new
        else:
            def pick(new, old):
                return torch.where(enable, new, old)
        ptr = state.ptr[i]
        ring = state.ring.clone()
        ring[i] = pick(torch.where(self._slots == ptr, value, state.ring[i]), state.ring[i])
        count = state.count.clone()
        count[i] = pick((state.count[i] + 1).clamp(max=self.limit), state.count[i])
        new_ptr = state.ptr.clone()
        new_ptr[i] = pick((ptr + 1) % self.limit, ptr)
        # the first add sets the value directly (reference monitoring.py:45-47)
        blended = (1.0 - self.exp_const) * state.exp[i] + self.exp_const * value
        exp = state.exp.clone()
        exp[i] = pick(torch.where(state.started[i], blended, value), state.exp[i])
        started = state.started.clone()
        started[i] = pick(torch.ones_like(state.started[i]), state.started[i])
        return MonitorState(ring=ring, count=count, ptr=new_ptr, exp=exp, started=started)

    # --- reads ------------------------------------------------------------
    def avg(self, state: MonitorState, key: str) -> torch.Tensor:
        """Median of the window; 1 if never added (reference monitoring.py:83-89).
        Slots [0, n) hold the live window while n < limit (the pointer wraps
        only once the window is full)."""
        i = self.index[key]
        n = state.count[i]
        padded = torch.where(self._slots < n, state.ring[i], torch.full_like(state.ring[i], float("inf")))
        ordered = torch.sort(padded).values
        lo = ordered.index_select(0, torch.div(n - 1, 2, rounding_mode="floor").clamp(min=0).view(1))
        hi = ordered.index_select(0, torch.div(n, 2, rounding_mode="floor").view(1))
        med = ((lo + hi) / 2.0)[0]
        return torch.where(n > 0, med, torch.ones_like(med))

    def exp_avg(self, state: MonitorState, key: str) -> torch.Tensor:
        i = self.index[key]
        return torch.where(state.started[i], state.exp[i], torch.ones_like(state.exp[i]))

    def _window_mean(self, vals: torch.Tensor) -> torch.Tensor:
        if self.dev_func == "hamming":
            return (self._signal * vals).sum() / self._signal_sum
        if self.dev_func == "mean":
            return vals.mean()
        if self.dev_func == "median":
            return torch.quantile(vals, 0.5)
        raise ValueError(self.dev_func)

    def dev_avg(self, state: MonitorState, key: str) -> torch.Tensor:
        """Derivative of the windowed mean; 0 until the window fills
        (reference monitoring.py:64-73)."""
        i = self.index[key]
        chron = state.ring[i].index_select(0, (self._slots + state.ptr[i]) % self.limit)
        dev = self._window_mean(chron[1:]) - self._window_mean(chron[:-1])
        return torch.where(state.count[i] >= self.limit, dev, torch.zeros_like(dev))
