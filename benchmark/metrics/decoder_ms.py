"""decoder_ms: the device time of a step's decoder passes (SegFormer's
`decoder` spans: the all-MLP decoder of every forward of the step, the EMA,
static and gated dynamic teachers' and the student's source and target
passes, their backward aside), between the CUDA events the model's spans
(the adapter's span recorder, on under OTHERS.SCHEDULE, which the traced
run sets) record on the compute stream at each pass's entry and exit: the
step's sum, its median over the steps dispatched inside the traced window
(`SpanRecorder.steps`), in ms. Nothing to read where the program records no
such span.

The events bound the passes' stretch of the device's timeline, not its busy
time: where the host enqueues the pass's kernels slower than the device runs
them, the device's idle time between them counts too, so the reading rises
with the host's pace (`idle_share` says how far). A reading of the kernels'
own time inside the spans would need the trace to keep each host range's
kernels, which `benchkit.trace.summarize` does not."""

from statistics import median


def read(run):
    recorder = getattr(run.adapter, "spans", None)
    if recorder is None or run.tracer.t0 is None:
        return None
    per_step = []
    for step in recorder.steps(run.tracer.t0, run.tracer.t0 + run.tracer.wall_s):
        times = [s.device_ms for s in step if s.name == "decoder"]
        if times and None not in times:
            per_step.append(sum(times))
    return median(per_step) if per_step else None
