"""The harness's hooks for ADVENT (`AdventAdapter`, which runs
`run_adversarial`): what its per-step log holds, its two discriminators'
leaves and their loading, which of the adapter's state the comparison
reads, and the faults that only its step can have.

A configuration names this file by its "method"; the plain reference of the
same name is `benchmark/references/advent.py`.
"""

from __future__ import annotations

import torch

from benchkit.reference import disc_shapes

LOSS_KEYS = ("Segmentation loss", "Adversarial loss", "Discriminator loss")
READ_KEYS = LOSS_KEYS
AUX_TRAINED = True  # multi-level: the aux head trains
FAULTS = ("half_batch", "altered")
DISCS = ("d_aux", "d_main")


def extra_shapes(model) -> dict:
    """The two discriminators' leaves, named `d_aux.*` and `d_main.*`."""
    out = {}
    for tree in DISCS:
        out.update(disc_shapes(tree))
    return out


def load_extra(adapter, weights: dict) -> None:
    """The discriminators' seeded weights into the adapter's state."""
    with torch.no_grad():
        for tree in DISCS:
            for k, v in getattr(adapter.state, tree).items():
                v.copy_(weights[f"{tree}.{k}"])


def program_tree(state, which: str) -> dict:
    """The student's SGD momentum and the discriminators' first Adam moments
    (`momentum`), or all their parameters (`params`)."""
    if which == "momentum":
        tree = dict(state.opt_momentum)
        for name in DISCS:
            tree.update({f"{name}.{k}": v for k, v in getattr(state, f"{name}_opt")["mu"].items()})
    else:
        tree = dict(state.params)
        for name in DISCS:
            tree.update({f"{name}.{k}": v for k, v in getattr(state, name).items()})
    return tree


def read_start(snapshot_dir: str):
    """ADVENT bootstraps nothing before its first step."""
    return None


def plant(name: str, adapter):
    """`half_batch`: each step sees the first half of its batches;
    `altered`: the entropy maps inverted where they are made. Returns the
    call that takes the fault out again."""
    from onda_torch.methods import advent

    if name == "half_batch":
        build = adapter.build_step

        def build_step():
            step = build()

            def half(state, src, src_labels, trg, lr, lr_d):
                h = max(trg.shape[0] // 2, 1)
                return step(state, src[:h], src_labels[:h], trg[:h], lr, lr_d)
            return half
        adapter.build_step = build_step
        return lambda: None
    if name == "altered":
        original = advent.entropy_map
        advent.entropy_map = lambda logits: 1.0 - original(logits)
        return lambda: setattr(advent, "entropy_map", original)
    raise ValueError(f"unknown fault {name!r}")
