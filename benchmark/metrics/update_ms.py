"""update_ms: the device time of the step's `update` stage (the hybrid
step's log shares, SGD, the model EMA and the packed logs; ADVENT's
discriminator losses and gradients, SGD, Adam and the packed logs), between
the CUDA events the program's span recorder (`adapter.spans`, on under
OTHERS.SCHEDULE, which the traced run sets) records on the compute stream
at the stage's entry and exit: the median over the steps dispatched inside
the traced window (`SpanRecorder.steps`), in ms. Nothing to read where the
program records no such span."""

from statistics import median


def read(run):
    recorder = getattr(run.adapter, "spans", None)
    if recorder is None or run.tracer.t0 is None:
        return None
    per_step = []
    for step in recorder.steps(run.tracer.t0, run.tracer.t0 + run.tracer.wall_s):
        times = [s.device_ms for s in step if s.name == "update"]
        if times and None not in times:
            per_step.append(sum(times))
    return median(per_step) if per_step else None
