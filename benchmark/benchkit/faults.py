"""Faults planted under the timed path, for the check that `correct` comes out
false when the program is wrong. Each patches the program in this process
only; `benchmark/test_bench_harness.py` and `benchmark/control.py` use them,
the benchmark's own runs never do.

Every method can have:

* `unchanged`: the optimizers leave every parameter as it was;
* `head_lr`: the heads' leaves stepped at the backbone's learning rate (a
  wrong LR_RATIO), a fault that touches only a third of the leaves.

Each method's module (`benchmark/methods/<name>.py`) adds those only its
step can have under its `FAULTS` (there: half of the batch left out, the
means taken over the rest; an answer altered where it is produced).
"""

from __future__ import annotations

COMMON = ("unchanged", "head_lr")


def names(method) -> tuple:
    """Every fault a method's cell can have."""
    return COMMON + tuple(method.FAULTS)


def plant(name: str, method, adapter):
    """Plant the fault; returns the call that takes it out again."""
    from onda_torch.methods import optim

    saved = optim.update, optim.adam_update

    def restore():
        optim.update, optim.adam_update = saved

    if name == "unchanged":
        optim.update = lambda params, grads, buf, *a, **k: (params, buf)
        optim.adam_update = lambda params, grads, state, *a, **k: (params, state)
        return restore
    if name == "head_lr":
        update = saved[0]
        optim.update = (lambda params, grads, buf, labels, lr_backbone, lr_head, *a, **k:
                        update(params, grads, buf, labels, lr_backbone, lr_backbone, *a, **k))
        return restore
    return method.plant(name, adapter)
