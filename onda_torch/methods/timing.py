"""The epoch-sample cadence (`onda_tpu/methods/timing.py`); the spans of the
loops and the steps are in `utils.spans`."""


def samples_due(samples_every: int, i_iter: int, n_target: int) -> bool:
    """Whether epoch-boundary sample rendering fires at step ``i_iter``: the
    reference's double-modulo cadence (reference methods/prototypes.py:516),
    which fires every epoch for any positive setting; 0 or less opts out."""
    return samples_every > 0 and (i_iter + 1) % n_target % samples_every == 0
