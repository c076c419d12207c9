"""Teacher-switching policies (`onda_tpu/methods/prior_policy.py`).

A policy takes the monitor and switch state and the EMA / static priors,
decides whether to run the dynamic teacher and how to mix the prior. All
decisions are tensor comparisons on monitor statistics, kept on the device;
the one exception is the gate of the dynamic teacher's forward: skipping a
forward in eager PyTorch needs the decision on the host, so `_gated_dynamic`
reads it with one `.item()` (the JAX package uses `lax.cond`). A policy whose
decision is fixed by the config reads nothing: `base` with DYNAMIC_LAMBDA 0
never runs the dynamic teacher, and with SWITCH_PRIOR_THRESH 0 runs it every
step.

* base    — PROTO_ONLINE: below SWITCH_PRIOR_THRESH the prior is replaced by
            the dynamic prediction (reference methods/prototypes.py:227-248)
* hswitch — confidence switch (+SOFT_TRANS ramp), mixes by percentage_static
            (reference prototypes_hswitch.py:45-68)
* vswitch — 2-state machine on the derivative of the static-confidence MA
            (reference prototypes_vswitch.py:20-70)
* hybrid  — absolute confidence outside GRAY_AREA decides, derivative state
            inside it (reference prototypes_hybrid_switch.py:22-34,66-84)

Each returns (prior, dyn_probs, dyn_computed, switch_state, extra_logs).
"""

from __future__ import annotations

import torch

from ..config import value_or
from ..utils.spans import NULL
from .state import DYNAMIC, STATIC, SwitchState


def _gated_dynamic(dyn_forward, compute, template, spans):
    """Run the dynamic teacher only when `compute` holds (one host read, a
    `sync` span of `spans` where given)."""
    with NULL if spans is None else spans.sync("gate"):
        fire = bool(compute)
    if fire:
        return dyn_forward()
    return torch.zeros_like(template)


def compute_prior(policy: str, spec, monitor, mon_state, switch: SwitchState, prior_ema,
                  prior_static, dyn_forward, frozen: bool, spans=None):
    """Assemble the teacher prior. `prior_static` is None when STATIC_LAMBDA is 0;
    `frozen` keeps the switch state as it is (evaluation); `spans` records
    the gate's host read."""
    ema_l = float(spec.EMA_LAMBDA)
    static_l = float(spec.STATIC_LAMBDA)
    dyn_l = float(spec.DYNAMIC_LAMBDA)
    base_prior = ema_l * prior_ema
    if prior_static is not None:
        base_prior = base_prior + static_l * prior_static
    logs = {}
    dev = prior_ema.device
    false = torch.zeros((), dtype=torch.bool, device=dev)  # a fill, not a host copy

    avg_static = monitor.avg(mon_state, "prior static")
    dev_static = monitor.dev_avg(mon_state, "prior static")

    if policy == "base":
        thresh = float(value_or(spec.SWITCH_PRIOR_THRESH, 0.0))
        if dyn_l <= 0:
            return base_prior, torch.zeros_like(prior_ema), false, switch, logs
        if thresh > 0:
            replace = avg_static < thresh
            calc_dyn = replace
            dyn_p = _gated_dynamic(dyn_forward, calc_dyn, prior_ema, spans)
            prior = torch.where(replace, dyn_l * dyn_p, base_prior + dyn_l * dyn_p)
        else:  # the dynamic teacher runs every step: there is no gate to read
            calc_dyn = torch.ones((), dtype=torch.bool, device=dev)
            dyn_p = dyn_forward()
            prior = base_prior + dyn_l * dyn_p
        return prior, dyn_p, calc_dyn, switch, logs

    if policy == "hswitch":
        if value_or(spec.SOFT_TRANS, False):
            # linear ramp 0→1 over ~[0.82, 0.90] (reference prototypes_hswitch.py:47-48)
            ps = torch.clamp(avg_static * (25.0 / 3.0) - (41.0 / 6.0), 0.0, 1.0)
        else:
            ps = (avg_static > float(value_or(spec.SWITCH_PRIOR_THRESH, 0.86))).float()
        logs["percentage_static"] = ps
        calc_dyn = (ps < 1.0) if dyn_l > 0 else false
        dyn_p = _gated_dynamic(dyn_forward, calc_dyn, prior_ema, spans)
        prior = base_prior * ps + (1.0 - ps) * dyn_l * dyn_p
        return prior, dyn_p, calc_dyn, switch, logs

    if policy == "vswitch":
        # SWITCH_PRIOR_THRESH is the derivative threshold here (reference
        # prototypes_vswitch.py:32-34; class default 0.00028)
        thr = float(value_or(spec.SWITCH_PRIOR_THRESH, 0.00028))
        new_current = torch.where(dev_static > thr, STATIC,
                                  torch.where(dev_static < -thr, DYNAMIC, switch.current))
        current = switch.current if frozen else new_current.long()
        switch = SwitchState(current=current, current_dev=switch.current_dev)
        calc_dyn = (current == DYNAMIC) if dyn_l > 0 else false
        dyn_p = _gated_dynamic(dyn_forward, calc_dyn, prior_ema, spans)
        prior = torch.where(calc_dyn, dyn_l * dyn_p, base_prior)
        return prior, dyn_p, calc_dyn, switch, logs

    if policy == "hybrid":
        if spec.EXP_PR_STATIC != {} and spec.EXP_PR_STATIC:
            conf = monitor.exp_avg(mon_state, "prior static")
        else:
            conf = avg_static
        lo, hi = (float(v) for v in value_or(spec.GRAY_AREA, (0.84, 0.88)))
        dev_thr = float(value_or(spec.DEV_THRESH, 0.0002))
        new_dev = torch.where(dev_static > dev_thr, STATIC,
                              torch.where(dev_static < -dev_thr, DYNAMIC, switch.current_dev))
        new_current = torch.where(conf < lo, DYNAMIC, torch.where(conf > hi, STATIC, new_dev))
        if not frozen:
            switch = SwitchState(current=new_current.long(), current_dev=new_dev.long())
        calc_dyn = (switch.current == DYNAMIC) if dyn_l > 0 else false
        dyn_p = _gated_dynamic(dyn_forward, calc_dyn, prior_ema, spans)
        prior = torch.where(calc_dyn, dyn_l * dyn_p, base_prior)
        return prior, dyn_p, calc_dyn, switch, logs

    raise ValueError(f"unknown prior policy {policy!r}")


POLICY_BY_METHOD = {
    "PROTO_ONLINE": "base",
    "PROTO_ONLINE_HSWITCH": "hswitch",
    "PROTO_ONLINE_VSWITCH": "vswitch",
    "PROTO_ONLINE_HYBRIDSWITCH": "hybrid",
    "PROTO_ADVENT": "hswitch",
}
