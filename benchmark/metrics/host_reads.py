"""host_reads: the host reads of device data a step (the program's `sync`
spans: the gate's decision, the packed logs, the replay insertions'
copies), from its span recorder (`adapter.spans`, on under
OTHERS.SCHEDULE, which the traced run sets): the median over the steps
dispatched inside the traced window (`SpanRecorder.steps`). Nothing to read
where the program records no spans."""

from statistics import median


def read(run):
    recorder = getattr(run.adapter, "spans", None)
    if recorder is None or run.tracer.t0 is None:
        return None
    steps = recorder.steps(run.tracer.t0, run.tracer.t0 + run.tracer.wall_s)
    return median(sum(s.name == "sync" for s in step) for step in steps) if steps else None
