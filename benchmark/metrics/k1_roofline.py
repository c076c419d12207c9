"""k1_roofline: K1's least time over the traced steps (its calls a step, as
the configuration's `launches_per_step` counts them, on the batch's pixels
of the reference model's feature grid, at the model's width F, C = 19: the
bytes at HBM3's 3.35 TB/s, or the operations at f32's 67 TF/s where they
bound it; `benchkit.counts.k1_step_bound_s`) over its kernel's device time
in the trace, in %. Nothing to read where K1 does not run."""

from benchkit import counts
from benchkit.trace import seconds_of


def read(run):
    log, cell = run.logger, run.cell
    calls = cell.config["launches_per_step"].get("pseudo_labels_kernel", 0)
    if log.summary is None or not calls:
        return None
    device_s = seconds_of(log.summary["kernel_s"], counts.K1_KERNELS)
    if device_s <= 0:
        return None
    first, last = log.trace_steps
    bound_s = (last - first) * counts.k1_step_bound_s(calls, cell.model, cell.hw, cell.batch)
    return 100.0 * bound_s / device_s
