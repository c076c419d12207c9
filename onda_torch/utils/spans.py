"""Spans of the train loops, the steps and the models' passes
(`onda_tpu/methods/timing.py` holds the JAX package's meters).

Each adapter owns one `SpanRecorder` (`adapter.spans`) and hands it to its
model with `attach`: a model that records spans of its own (SegFormer's
`encoder`, `decoder` and `attention`) records them into the same recorder.
A loop opens one `step` span a loop iteration and splits it into phases,
its children:
`fetch` (the iteration's top to the fed batches), `dispatch` (the call of
the step function), `host_work` (buffer insertions, evaluation, samples,
checkpoints), `log_sync` (the read of the step's packed logs) and `log`
(the logger's call). The step functions open their stages, children of
`dispatch`, with `span`; every host read of device data is a `sync` span.

A span keeps its name, its parent span, the loop's step index and its host
start and end on `time.perf_counter`. While `torch.profiler` is active each
span is also a `record_function` range, a `user_annotation` on the
profiler's clock beside the kernels it launched. A span opened with
`device=True` on a card also records a timing CUDA event on the compute
stream at its entry and at its exit; its device time is the elapsed time
between them, taken once the end event has completed (a query, never a
wait: the step's packed-log read completes it). The recorder keeps the last
`STEPS_KEPT` steps in memory and writes nothing.

Spans are on under OTHERS.SCHEDULE, or while OTHERS.PROFILE traces. Off,
`span`, `sync` and `step` return one shared null context and `phase` returns
at once: no `record_function`, no CUDA event, no record.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque

import torch
from torch.autograd import profiler as _profiler

STEPS_KEPT = 64
NULL = contextlib.nullcontext()
# the loop phases' OTHERS.SCHEDULE log keys (host seconds) and the step
# stages' (device ms, on a card)
LOOP_KEYS = {"fetch": "time/Batch Fetch", "dispatch": "time/Step Dispatch",
             "host_work": "time/Host Work", "log_sync": "time/Log Sync"}
STAGE_KEYS = {"teachers": "time/Teachers device", "student": "time/Student device",
              "update": "time/Update device"}


class Span:
    __slots__ = ("name", "parent", "step", "start", "end", "device_ms", "_annotation", "_events")

    def __init__(self, name: str, parent, step: int, start: float):
        self.name, self.parent, self.step, self.start = name, parent, step, start
        self.end = self.device_ms = self._annotation = self._events = None


class SpanRecorder:
    def __init__(self, device, enabled: bool = False):
        self.cuda = torch.device(device).type == "cuda"
        self.device = torch.device(device)
        self.enabled = enabled
        self.ring: deque[list[Span]] = deque(maxlen=STEPS_KEPT)  # each step's spans, `step` first
        self._open: list[Span] = []  # the open spans, outermost first

    # --- recording ---------------------------------------------------------
    def step(self, index: int):
        """The loop iteration `index` as a `step` span."""
        return self._step(index) if self.enabled else NULL

    @contextlib.contextmanager
    def _step(self, index: int):
        span = Span("step", None, index, time.perf_counter())
        self._begin(span)
        try:
            yield span
        finally:
            now = time.perf_counter()
            while self._open:  # the open phase, and whatever an exception left open
                self._end(self._open[-1], now)

    def phase(self, name: str) -> None:
        """End the open step's current phase and begin phase `name`, at one
        clock reading."""
        if not (self.enabled and self._open):
            return
        now = time.perf_counter()
        if len(self._open) > 1:
            self._end(self._open[-1], now)
        self._begin(Span(name, self._open[0], self._open[0].step, now))

    def span(self, name: str, device: bool = False):
        """A span `name` under the innermost open one; with `device`, its
        device time too. Nothing outside a step."""
        if not (self.enabled and self._open):
            return NULL
        return self._span(name, device)

    def sync(self, site: str):
        """A host read of device data at `site`: a `sync` span (on the
        profiler's clock `sync.<site>`)."""
        if not (self.enabled and self._open):
            return NULL
        return self._span("sync", False, f"sync.{site}")

    @contextlib.contextmanager
    def _span(self, name: str, device: bool, label: str | None = None):
        parent = self._open[-1]
        span = Span(name, parent, parent.step, time.perf_counter())
        self._begin(span, device, label)
        try:
            yield span
        finally:
            self._end(span, time.perf_counter())

    def _begin(self, span: Span, device: bool = False, label: str | None = None) -> None:
        if span.parent is None:
            self.ring.append([span])
        else:
            self.ring[-1].append(span)
        self._open.append(span)
        if torch.autograd._profiler_enabled():
            span._annotation = _profiler.record_function(label or span.name)
            span._annotation.__enter__()
        if device and self.cuda:
            stream = torch.cuda.current_stream(self.device)
            span._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            span._events[0].record(stream)

    def _end(self, span: Span, now: float) -> None:
        if span._events is not None:
            span._events[1].record(torch.cuda.current_stream(self.device))
        if span._annotation is not None:
            span._annotation.__exit__(None, None, None)
            span._annotation = None
        span.end = now
        self._open.remove(span)

    # --- reading -----------------------------------------------------------
    def steps(self, start: float | None = None, end: float | None = None) -> list[list[Span]]:
        """The kept steps' spans, oldest step first, each step's `step` span
        first; device times resolved where their events have completed. With
        `start` and `end` (host clock), only the steps dispatched between
        them: a `step` span begun at or after `start` whose `dispatch` ended
        by `end`."""
        out = []
        for spans in self.ring:
            for span in spans:
                self._resolve(span)
            if start is None or (spans[0].start >= start and any(
                    s.name == "dispatch" and s.end is not None and s.end <= end for s in spans)):
                out.append(list(spans))
        return out

    @staticmethod
    def _resolve(span: Span) -> None:
        if span._events is not None and span.end is not None and span._events[1].query():
            span.device_ms = span._events[0].elapsed_time(span._events[1])
            span._events = None

    def averages(self, keys: dict, last: int = 20, device: bool = False) -> dict:
        """{keys[name]: the mean over the last `last` ended spans named name}:
        host seconds, or with `device` device ms (only spans whose device
        time is known)."""
        values = {name: [] for name in keys}
        for spans in reversed(self.ring):
            for span in spans:
                if span.name in values and span.end is not None:
                    self._resolve(span)
                    value = span.device_ms if device else span.end - span.start
                    if value is not None and len(values[span.name]) < last:
                        values[span.name].append(value)
        return {keys[name]: sum(v) / len(v) for name, v in values.items() if v}

    def loop_logs(self) -> dict:
        """OTHERS.SCHEDULE's log keys of a step loop: the phases' and the
        stages' averages over the last 20 steps, and the open step's host
        reads."""
        return {**self.averages(LOOP_KEYS), **self.averages(STAGE_KEYS, device=True),
                "host reads": self.reads()}

    def reads(self) -> int:
        """The open step's host reads so far (its `sync` spans)."""
        return sum(span.name == "sync" for span in self.ring[-1]) if self._open else 0


def attach(model, recorder: SpanRecorder) -> None:
    """Hand `recorder` to `model` where the model records spans of its own
    (it has `attach_spans`); other models record none."""
    hook = getattr(model, "attach_spans", None)
    if hook is not None:
        hook(recorder)
