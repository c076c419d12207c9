"""SGD with torch semantics, two LR groups and a frozen-parameter mask, and
Adam for the discriminators (`onda_tpu/methods/optim.py`).

The reference trains with `optim.SGD(model.optim_parameters(lr), momentum, wd)`:
the backbone (minus frozen BN affine params) and the classifier heads form two
groups whose LRs are `lr_poly(...) * ratio[g]` (LR_RATIO "a:b", reference
methods/adaptation_model.py:88-125). Update (dampening 0, no nesterov):
    g ← g + wd·p;  buf ← μ·buf + g;  p ← p − lr·buf

The reference's backbone generator yields each backbone param once per
enclosing module (k=1 stem conv, k=3 inside Bottlenecks, k=4 downsample
convs, reference deeplabv2.py:396-418), and torch SGD applies one update per
occurrence: a k-labelled param gets k chained sub-updates per step. Labels
are keyed by state_dict name; the update works in place on the tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import distributed as dist

FROZEN, HEAD = -1, 0
BACKBONE = 1  # plain backbone leaf (k=1), e.g. the stem conv


def label_params(params: dict, frozen_bn: bool = True, aux_grad: bool = True) -> dict:
    """Name → FROZEN | HEAD | backbone multiplicity k (1/3/4).

    `aux_grad=False` freezes the structural aux head (`layer5` beside `layer6`):
    with multi_level off no loss reaches it (reference model_handler.py:58).
    SegFormer's `decode_head.` is the head; its `backbone.` leaves,
    LayerNorms' affines included, are backbone leaves updated once a step."""
    aux_head = any(k.startswith("layer6.") for k in params) and any(
        k.startswith("layer5.") for k in params)

    def label_one(name: str) -> int:
        parts = name.split(".")
        if parts[0] == "layer5" and aux_head and not aux_grad:
            return FROZEN
        if parts[0] in ("layer5", "layer6"):
            return HEAD
        if parts[0] == "bn_pretrain":
            # the ProDA layout's bn_clr BatchNorm sits in the 10x group,
            # yielded once (reference deeplabv2_proda.py:441-447)
            return HEAD
        module = parts[-2] if len(parts) > 1 else ""
        is_bn_affine = parts[-1] in ("weight", "bias") and (
            "bn" in module or parts[-3:-1] == ["downsample", "1"])
        if frozen_bn and is_bn_affine:
            return FROZEN
        if parts[0] == "decode_head":  # SegFormer's decoder, its BatchNorm's affine aside
            return HEAD
        if parts[0] in ("layer1", "layer2", "layer3", "layer4"):
            return 4 if "downsample" in parts else 3
        return BACKBONE

    return {name: label_one(name) for name in params}


def init(params: dict) -> dict:
    return {k: torch.zeros_like(v) for k, v in params.items()}


def lr_poly(base_lr: float, step, total_steps: int, power: float) -> float:
    """Poly LR (reference utils/func.py:45-47); POWER 0 ⇒ constant."""
    if power == 0:
        return base_lr
    return base_lr * (1.0 - step / total_steps) ** power


def _local_grads(loss: torch.Tensor, live: dict, names: list, unused) -> dict:
    used = [k for k in names if k not in unused]
    got = dict(zip(used, torch.autograd.grad(loss, [live[k] for k in used])))
    return {k: got[k] if k in got else torch.zeros_like(live[k]) for k in names}


def grads(loss: torch.Tensor, live: dict, names: list, unused=()) -> dict:
    """d loss / d live[name] for each name. The names in `unused` are those no
    loss reaches by design (the multi-level aux head where its forward is
    skipped): they get a zero gradient, as `jax.grad` gives, so SGD still
    decays them and runs their momentum. Any other parameter that no loss
    reaches is an error.

    Under data parallelism, and on a spatial axis, the loss is this rank's
    share of the global batch's (its means divide by the global counts), so
    the gradient of the global loss is the sum over the ranks that split the
    pixels (data × spatial: each spatial rank holds a partial weight
    gradient): one all-reduce of a flat bucket of every gradient, one f32
    copy of the trainable parameters, before the update. Every rank then
    updates with the same bits."""
    out = _local_grads(loss, live, names, unused)
    return dict(zip(out, dist.all_sum(*out.values(), group="pixels")))


def grid_grads(loss: torch.Tensor, live: dict, names: list, unused, sharded) -> dict:
    """`grads` on a (data × model) grid, where the names in `sharded` hold
    this rank's channel shard (`sum_on_grid`)."""
    return sum_on_grid(_local_grads(loss, live, names, unused), sharded)


def sum_on_grid(grads: dict, sharded) -> dict:
    """This rank's gradients of its share of the global loss, summed on a
    (data × model) grid. The names in `sharded` hold this rank's channel
    shard: their bucket is summed over the data group. The others are whole
    on every rank, their gradients alike on the ranks of a data index: their
    bucket is summed over every rank and divided by the model axis's size,
    which gives the same sum, and the same bits on every rank even where the
    card's backward kernels are not deterministic."""
    part = [k for k in grads if k in sharded]
    whole = [k for k in grads if k not in sharded]
    summed = dict(zip(part, dist.all_sum(*(grads[k] for k in part)) if part else ()))
    if whole:
        tp = dist.model_world()
        summed.update(zip(whole, (g / tp for g in dist.all_sum(*(grads[k] for k in whole),
                                                                group="world"))))
    return {k: summed[k] for k in grads}


@torch.no_grad()
def update(params: dict, grads: dict, momentum_buf: dict, labels: dict, lr_backbone: float,
           lr_head: float, momentum: float, weight_decay: float):
    """One SGD step in place; returns (params, momentum_buf). A param labelled
    k >= 1 receives k chained sub-updates against its momentum buffer."""
    for name, lab in labels.items():
        if lab == FROZEN:
            continue
        p, b, g = params[name], momentum_buf[name], grads[name]
        lr = lr_head if lab == HEAD else lr_backbone
        for _ in range(1 if lab == HEAD else lab):
            b.mul_(momentum).add_(g + weight_decay * p)
            p.sub_(lr * b)
    return params, momentum_buf


# --- Adam, for the ADVENT discriminators (reference advent_da.py:55-60) -------


def adam_init(params: dict) -> dict:
    return {"mu": init(params), "nu": init(params), "count": 0}


@torch.no_grad()
def adam_update(params: dict, grads: dict, opt_state: dict, lr: float, b1: float = 0.9,
                b2: float = 0.99, eps: float = 1e-8):
    """One torch.optim.Adam step in place (betas (0.9, 0.99) as the reference
    sets them); returns (params, opt_state). eps is added to sqrt(v̂); the
    bias corrections come from the optimizer's own step `count`, in f32 as
    the JAX update computes them."""
    count = opt_state["count"] + 1
    c1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
    c2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
    for name, p in params.items():
        m, v, g = opt_state["mu"][name], opt_state["nu"][name], grads[name]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        p.sub_(lr * (m / c1) / ((v / c2).sqrt() + eps))
    opt_state["count"] = count
    return params, opt_state
