"""The harness's hooks for PROTO_ONLINE_HYBRIDSWITCH (`ProtoOnlineAdapter`):
what its per-step log holds, which of the adapter's state the comparison
reads, the start it bootstraps, and the faults that only its step can have.

A configuration names this file by its "method"; the plain reference of the
same name is `benchmark/references/hybrid.py`.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

LOSS_KEYS = ("Total target loss", "buff_loss")  # logged a step, and compared
READ_KEYS = LOSS_KEYS + ("dynamic forward fired", "time/Batch Fetch")
AUX_TRAINED = False  # the model's structural aux head is frozen
FAULTS = ("half_batch", "altered")


def extra_shapes(model) -> dict:
    """Leaves beside the model's: none."""
    return {}


def load_extra(adapter, weights: dict) -> None:
    """Nothing beside the model to load."""


def program_tree(state, which: str) -> dict:
    """The student's SGD momentum (`momentum`) or its parameters (`params`)."""
    return dict(state.opt_momentum if which == "momentum" else state.params)


def read_start(snapshot_dir: str):
    """The prototypes the program bootstrapped before its first step, as it
    wrote them (`proto_current.pickle`: mean, mean square, count)."""
    path = os.path.join(snapshot_dir, "proto_current.pickle")
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        mean, sq_mean, count = pickle.load(f)
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.float64)
            for k, v in (("mean", mean), ("sq_mean", sq_mean), ("count", count))}


def plant(name: str, adapter):
    """`half_batch`: each step sees the first half of its batches;
    `altered`: the pseudo-labels shifted by one class where K1 makes them.
    Returns the call that takes the fault out again."""
    from onda_torch.ops import kernels

    if name == "half_batch":
        build = adapter.step_fn

        def step_fn(*key):
            step = build(*key)

            def half(state, trg, src, src_labels, lr):
                h = max(trg.shape[0] // 2, 1)
                return step(state, trg[:h], None if src is None else src[:, :h],
                            None if src_labels is None else src_labels[:, :h], lr)
            return half
        adapter.step_fn = step_fn
        return lambda: None
    if name == "altered":
        original = kernels.pseudo_labels

        def shifted(*args, **kw):
            soft, hard, prop_max = original(*args, **kw)
            return soft, hard.where(hard == 255, (hard + 1) % soft.shape[1]), prop_max
        kernels.pseudo_labels = shifted
        return lambda: setattr(kernels, "pseudo_labels", original)
    raise ValueError(f"unknown fault {name!r}")
