"""mfu: the traced steps' required convolution and matmul operations (the
analytic count over the cell's reference model's forward,
`benchkit.counts.step_flops`, with the configuration's
forward-equivalents; a gated forward only on the steps its gate fired) over
the traced window's seconds at H100 SXM's dense TF32 peak, in %."""

from benchkit import counts


def read(run):
    log, cell = run.logger, run.cell
    if log.summary is None:
        return None
    first, last = log.trace_steps
    flops = sum(counts.step_flops(cell.config["step_flops"], cell.model, cell.hw, cell.batch,
                                  fired) for fired in log.fired[first:last])
    return 100.0 * flops / (log.summary["window_s"] * counts.TF32_FLOPS)
