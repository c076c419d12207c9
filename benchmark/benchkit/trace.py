"""The traced window: `torch.profiler` over whole steps, reduced to what the
per-layer readers and the result line take.

`Tracer.start` and `Tracer.stop` are called at step boundaries, right after
a step's logs were read on the host, when the device has nothing queued; the
window is the host time between them. The profiler's Chrome trace gives
every kernel, copy and memset on the device's timeline and every host
operator and runtime call on the host's; `summarize` keeps:

* `kernel_s`: device seconds by kernel name;
* `busy_s`: the union of the device's intervals (kernels, copies, memsets);
* `gap_s`: the device's idle intervals inside the window, summed by the
  innermost event of the launching thread that covers each one's middle
  (what the host was doing while the device waited).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

from .counts import union_seconds

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "python_function", "user_annotation")


class Tracer:
    def __init__(self, device):
        self.device = device
        self.profiler = None
        self.t0 = self.wall_s = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.profiler = profile(activities=activities)
        self.profiler.start()
        self.t0 = time.perf_counter()

    def stop(self) -> dict:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.wall_s = time.perf_counter() - self.t0
        self.profiler.stop()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="onda_bench_trace_")
        os.close(fd)
        try:
            self.profiler.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.profiler = None
        return summarize(events, self.wall_s)


def summarize(events, wall_s: float) -> dict:
    """The reduction of a Chrome trace's events (µs) over a window of
    `wall_s` host seconds."""
    device = [(e["ts"], e["ts"] + e["dur"], e.get("name", "?"), e["cat"]) for e in events
              if e.get("cat") in DEVICE_CATS and "dur" in e]
    kernel_s = defaultdict(float)
    for start, end, name, cat in device:
        kernel_s[name if cat == "kernel" else cat] += (end - start) * 1e-6
    busy_us = union_seconds((s, e) for s, e, _, _ in device)
    host = launching_thread(events)
    gaps = []
    if device and host:
        spans = sorted((s, e) for s, e, _, _ in device)
        reach, last = host[0][0], max(h[1] for h in host)
        for s, e in spans + [(last, last)]:
            if s > reach:
                gaps.append((reach, s))
            reach = max(reach, e)
    named = defaultdict(float)
    for (gs, ge), name in zip(gaps, innermost(host, [0.5 * (gs + ge) for gs, ge in gaps])):
        named[name] += (ge - gs) * 1e-6
    return {"kernel_s": dict(kernel_s), "busy_s": busy_us * 1e-6, "window_s": wall_s,
            "gap_s": dict(named), "n_device_events": len(device)}


def launching_thread(events):
    """The host events (start, end, name) of the thread that launches the
    kernels, by start (the longer first at a tie): on one thread they nest."""
    launches = defaultdict(int)
    for e in events:
        if e.get("cat") == "cuda_runtime":
            launches[(e.get("pid"), e.get("tid"))] += 1
    if not launches:
        return []
    main = max(launches, key=launches.get)
    return sorted(((e["ts"], e["ts"] + e["dur"], e.get("name", "?")) for e in events
                   if e.get("cat") in HOST_CATS and "dur" in e
                   and (e.get("pid"), e.get("tid")) == main), key=lambda h: (h[0], -h[1]))


def innermost(host, times):
    """For each of `times` (ascending), the name of the innermost host event
    open at that time, or what the host does between traced operations."""
    names, stack, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        names.append(stack[-1][2] if stack else "host Python between traced ops")
    return names


def top(table: dict, n: int = 10, width: int = 160):
    """The n largest entries as [name, value], names cut to `width` letters."""
    return [[name[:width], value]
            for name, value in sorted(table.items(), key=lambda kv: -kv[1])[:n]]


def seconds_of(kernel_s: dict, names) -> float:
    """Device seconds of the kernels whose name contains one of `names`."""
    return sum(v for k, v in kernel_s.items() if any(n in k for n in names))
