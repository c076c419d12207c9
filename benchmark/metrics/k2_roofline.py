"""k2_roofline: K2's least time over the traced steps (each BatchNorm
input of the reference model's forward, as the model's norm inputs give
them, read once and its mean and variance written once, at HBM3's
3.35 TB/s, or its operations at f32's 67 TF/s where they bound it;
`benchkit.counts.k2_step_bound_s`, over the configuration's
`k2_forwards_per_step`) over its kernels' device time in the
trace, in %."""

from benchkit import counts
from benchkit.trace import seconds_of


def read(run):
    log, cell = run.logger, run.cell
    if log.summary is None:
        return None
    device_s = seconds_of(log.summary["kernel_s"], counts.K2_KERNELS)
    if device_s <= 0:
        return None
    first, last = log.trace_steps
    bound_s = (last - first) * counts.k2_step_bound_s(cell.config["k2_forwards_per_step"],
                                                     cell.model, cell.hw, cell.batch)
    return 100.0 * bound_s / device_s
