"""dispatch_ms: the host's time to enqueue a step: the train loop's
`dispatch` span (the call of the step function) less its `sync` spans (the
host reads inside it, the gate's wait), from the program's span recorder
(`adapter.spans`, on under OTHERS.SCHEDULE, which the traced run sets) on
the host clock: the median over the steps dispatched inside the traced
window (`SpanRecorder.steps`), in ms. Nothing to read where the program
records no such span."""

from statistics import median


def read(run):
    recorder = getattr(run.adapter, "spans", None)
    if recorder is None or run.tracer.t0 is None:
        return None
    per_step = []
    for step in recorder.steps(run.tracer.t0, run.tracer.t0 + run.tracer.wall_s):
        dispatch = next(s for s in step if s.name == "dispatch")
        waits = sum(s.end - s.start for s in step if s.name == "sync" and within(s, dispatch))
        per_step.append(1e3 * (dispatch.end - dispatch.start - waits))
    return median(per_step) if per_step else None


def within(span, ancestor) -> bool:
    while span is not None:
        if span is ancestor:
            return True
        span = span.parent
    return False
