"""The complete adaptation state (`onda_tpu/methods/state.py`).

One dataclass of tensor dicts (parameter / buffer name → tensor, in the
model's state_dict key layout) that the adaptation step threads through:
the student, its SGD momentum, the EMA / static / dynamic teachers, the
prototypes, the monitor, the switch, the dropout generator and the step.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.monitor import MonitorState
from ..ops.prototypes import ProtoState

# switch states (reference prototypes_vswitch.py:5-26, prototypes_hybrid_switch.py:5-34)
STATIC, DYNAMIC = 0, 1


@dataclasses.dataclass
class SwitchState:
    current: torch.Tensor      # () int64 — selected teacher
    current_dev: torch.Tensor  # () int64 — derivative-machine memory (hybrid)


@dataclasses.dataclass
class AdaptState:
    # student (trained), reference "model"
    params: dict
    batch_stats: dict
    alt_batch_stats: dict         # second BN-stat set for the "double" policy
    opt_momentum: dict
    # teachers
    ema_params: dict              # EMA of student params; BN stats are the student's
    static_params: dict           # frozen source model
    static_batch_stats: dict
    dynamic_params: dict          # periodically refreshed copy of the student
    dynamic_batch_stats: dict
    # method state
    proto: ProtoState
    monitor: MonitorState
    switch: SwitchState
    generator: torch.Generator    # dropout randomness
    step: int = 0


def init_switch(device="cpu") -> SwitchState:
    return SwitchState(current=torch.tensor(STATIC, device=device),
                       current_dev=torch.tensor(STATIC, device=device))


def clone_tree(tree: dict) -> dict:
    return {k: v.detach().clone() for k, v in tree.items()}


def make_adapt_state(variables: dict, proto: ProtoState, monitor: MonitorState, seed: int,
                     device="cpu") -> AdaptState:
    """Replicate the freshly loaded source model into all four roles
    (reference prototypes.py:45-48: ema/dynamic/static = deepcopy(model))."""
    params = {k: v.detach().to(device) for k, v in variables["params"].items()}
    stats = {k: v.detach().to(device) for k, v in variables.get("batch_stats", {}).items()}
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return AdaptState(
        params=params,
        batch_stats=stats,
        alt_batch_stats=clone_tree(stats),
        opt_momentum={k: torch.zeros_like(v) for k, v in params.items()},
        ema_params=clone_tree(params),
        static_params=clone_tree(params),
        static_batch_stats=clone_tree(stats),
        dynamic_params=clone_tree(params),
        dynamic_batch_stats=clone_tree(stats),
        proto=proto,
        monitor=monitor,
        switch=init_switch(device),
        generator=generator,
    )
