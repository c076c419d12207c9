"""fetch_ms: the train loop's own host wait for its fed batches
(`time/Batch Fetch` of OTHERS.SCHEDULE, on in the traced run only): its
mean over the window's steps before the trace, as the loop's meter averages
them. Nothing to read where the loop has no such meter (`run_adversarial`)."""


def read(run):
    fetch_s = run.logger.fetch_s
    return None if fetch_s is None else 1e3 * fetch_s
