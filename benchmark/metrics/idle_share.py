"""idle_share: the share of the traced window in which nothing ran on the
device (1 − the union of kernel, copy and memset intervals over the
window), in %."""


def read(run):
    summary = run.logger.summary
    if summary is None or summary["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
