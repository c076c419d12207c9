"""The comparison that decides `correct`: the program's first steps against
the reference's. Each cell's limits file names the numbers compared; the
rest are read beside them.

* `loss_gap`, `loss_gap_<k>`: the largest relative gap of a logged loss at
  step 1 and at step k, |program − reference| / |reference|;
* `grad_gap`: the first step's gradient, leaf by leaf, as the norm of the
  program's leaf against the reference's: |‖g_p‖ − ‖g_r‖| over the larger
  of ‖g_r‖ and the median leaf's ‖g_r‖ (some gradients are all but zero);
  over the leaves its median, its 90th percentile (`_q90`) and its worst
  (`_worst`);
* `change_gap`: the same of each leaf's change over the compared steps,
  leaving out the leaves whose reference gradient is under a thousandth of
  the median leaf's (they move under SGD's weight decay and momentum by
  rounding alone);
* `grad_diff`: the first step's gradient, leaf by leaf, as the norm of the
  difference ‖g_p − g_r‖ over the larger of ‖g_r‖ and the median leaf's.
  A precision lower than the configuration's shows here rather than in the
  gaps of norms, since its rounding is unbiased from one element to the
  next; it shows most in the heads' quietest leaves (`grad_diff_head_q10`),
  where the network amplifies it least;
* `proto_mean_diff` (hybrid): the prototypes the program bootstrapped from
  the source frames before its first step (its own `proto_current.pickle`),
  ‖mean_p − mean_r‖ / ‖mean_r‖ over the classes' mean features: the start,
  checked by itself, through forwards that no pseudo-label touches.

The worst leaf is read, not compared: it is a leaf near the input, whose
gradient is a sum over hundreds of thousands of positions that nearly
cancels, so that TF32's rounding (and, over the later steps, which pixels
pass the pseudo-label threshold) moves it by several percent. The 90th
percentile stays clear of it.

The program's gradient is read from its optimizers' state after its first
step: SGD's momentum after k chained updates (`first_gradients`, k the
model's multiplicity of the leaf), Adam's first moment.
"""

from __future__ import annotations

import math
import statistics

ADAM_B1 = 0.9
QUIET = 1e-3  # a leaf whose reference gradient is under this share of the median's


def chain(k: int, lr: float, mu: float, wd: float):
    """(a, c) with SGD's momentum after k chained updates from zero, all with
    one gradient g, being a·g + c·p0."""
    a = c = 0.0
    pa, pc = 0.0, 1.0  # the parameter: pa·g + pc·p0
    for _ in range(k):
        a, c = mu * a + 1.0 + wd * pa, mu * c + wd * pc
        pa, pc = pa - lr * a, pc - lr * c
    return a, c


def first_gradients(momentum: dict, p0: dict, model, aux_trained: bool, lr_backbone: float,
                    lr_head: float, mu: float, wd: float) -> dict:
    """Each trained leaf's first gradient, worked out from its optimizer's
    state after one step: the student's from SGD's momentum, after the
    chained updates `model.multiplicity` gives the leaf at the head's LR
    where it starts with one of `model.HEADS`; the discriminators' from
    Adam's first moment."""
    out = {}
    for name, buf in momentum.items():
        if name.startswith("d_"):
            out[name] = buf.double() / (1.0 - ADAM_B1)
            continue
        k = model.multiplicity(name, aux_trained)
        if not k:
            continue
        lr = lr_head if name.startswith(model.HEADS) else lr_backbone
        a, c = chain(k, lr, mu, wd)
        out[name] = (buf.double() - c * p0[name].double()) / a
    return out


def leaf_gaps(got: dict, want: dict, keys) -> dict:
    keys = list(keys)
    median = statistics.median(want[k] for k in keys)
    return {k: abs(got[k] - want[k]) / max(want[k], median) for k in keys}


def spread_of(name: str, per_leaf: dict) -> dict:
    """A per-leaf number's median, 90th percentile and worst leaf over the
    leaves; the five worst leaves by name and every leaf's value are read,
    not compared."""
    values = sorted(per_leaf.values())
    worst = sorted(per_leaf.items(), key=lambda kv: -kv[1])[:5]
    return {name: statistics.median(values), f"{name}_q90": quantile(values, 0.9),
            f"{name}_worst": values[-1], f"{name}_top": [[k, v] for k, v in worst],
            f"{name}_leaves": dict(per_leaf)}


def quantile(ordered, q: float) -> float:
    """The q-quantile of ascending values, linear between order statistics."""
    pos = q * (len(ordered) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(ordered) - 1)
    return ordered[lo] + (pos - lo) * (ordered[hi] - ordered[lo])


def gaps(got: dict, want: dict, heads) -> dict:
    """Every number the comparison reads: `loss_gap` (the first step's
    losses), `loss_gap_<k>` for each later step k, `grad_gap`, `change_gap`
    and `grad_diff` with their 90th percentile (`_q90`) and worst leaf
    (`_worst`) beside the median, `grad_diff_head`, the heads' leaves'
    gradient difference together over their norm, and `grad_diff_head_q10`,
    the tenth percentile of the heads' leaves' `grad_diff` (the leaves where
    rounding is least amplified; a head's leaf starts with one of the
    model's `heads` prefixes). The cell's limits file names those
    compared."""
    rel = [{k: abs(g[k] - w[k]) / max(abs(w[k]), 1e-12) for k in w}
           for g, w in zip(got["losses"], want["losses"])]
    out = {"loss_gap": max(rel[0].values()),
           **{f"loss_gap_{k}": max(v.values()) for k, v in enumerate(rel[1:], 2)},
           **{f"loss_gap.{key.lower().replace(' ', '_')}": v for key, v in rel[0].items()}}
    if set(got["grad"]) != set(want["grad"]):
        return {**out, **{f"{n}{s}": math.inf for n in ("grad_gap", "change_gap", "grad_diff")
                          for s in ("", "_q90", "_worst")}, "grad_diff_head": math.inf}
    median = statistics.median(want["grad"].values())
    moving = [k for k, v in want["grad"].items() if v >= QUIET * median]
    out.update(spread_of("grad_gap", leaf_gaps(got["grad"], want["grad"], want["grad"])))
    out.update(spread_of("change_gap", leaf_gaps(got["change"], want["change"], moving)))
    if "proto" in got and "proto" in want:
        g, w = got["proto"], want["proto"]
        out.update({f"proto_{k}_diff": float((g[k] - w[k]).norm() / w[k].norm())
                    for k in ("mean", "sq_mean")},
                   proto_count_gap=float((g["count"] - w["count"]).abs().max()))
    if "grad_tensors" in got and "grad_tensors" in want:
        g, w = got["grad_tensors"], want["grad_tensors"]
        diff = {k: float((g[k].double() - w[k].double()).norm()) / max(want["grad"][k], median)
                for k in want["grad"]}
        out.update(spread_of("grad_diff", diff))
        in_heads = [k for k in want["grad"] if k.startswith(heads)]
        if in_heads:  # the quietest tenth of the heads' leaves
            out["grad_diff_head_q10"] = quantile(sorted(diff[k] for k in in_heads), 0.1)
            num = math.sqrt(sum(float((g[k].double() - w[k].double()).norm()) ** 2
                                for k in in_heads))
            den = math.sqrt(sum(want["grad"][k] ** 2 for k in in_heads))
            out["grad_diff_head"] = num / den
    return out
