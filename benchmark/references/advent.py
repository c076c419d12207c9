"""The plain reference of ADVENT on a multi-level model: the student's
segmentation CE on the source and adversarial BCE on the target's entropy
maps with SGD, the two discriminators' BCE with Adam, in plain PyTorch on
the configuration's reference model (`benchmark/models/`). It imports
nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchkit.reference import (Net, adam, bce_logits, change_norms, cross_entropy, entropy_map,
                                host_copy, leaf_norms, sgd)


def adapt_steps(spec: dict, model, weights: dict, source: dict, targets, src_order, lrs,
                seed_gen, compute=None, steps=3):
    """The first `steps` ADVENT steps of a multi-level model from `weights`:
    the student's leaves and the discriminators' ("d_aux.*", "d_main.*").
    The student's segmentation CE on the source and its adversarial BCE on
    the target's entropy maps, SGD; the discriminators' BCE on the detached
    maps, Adam. Arguments and result as `references/hybrid.py`'s, without
    "fired" and "proto"."""
    discs = {k: v for k, v in weights.items() if k.startswith("d_")}
    weights = {k: v for k, v in weights.items() if not k.startswith("d_")}
    net = model.Net(compute)
    p0 = {k: v.clone() for k, v in {**weights, **discs}.items()}
    params = {k: v.clone() for k, v in weights.items()}
    D = {k: v.clone() for k, v in discs.items()}
    mult = {k: model.multiplicity(k, aux_trained=True) for k in params}
    trainable = [k for k in params if mult[k]]
    momentum = {k: torch.zeros_like(params[k]) for k in trainable}
    adam_state = {"t": 0, "m": {k: torch.zeros_like(v) for k, v in D.items()},
                  "v": {k: torch.zeros_like(v) for k, v in D.items()}}
    r0, r1 = (float(v) for v in spec.get("LR_RATIO", "1:10").split(":"))
    hw = tuple(source["image"].shape[2:])
    up = (lambda x: F.interpolate(x, size=hw, mode="bilinear", align_corners=True))
    out = {"losses": []}
    for k in range(steps):
        live = {n: (v.detach().requires_grad_(True) if mult[n] else v) for n, v in params.items()}
        rows = src_order[k]
        labels = source["label"][rows]
        (_, s_aux), (_, s_main) = net(live, source["image"][rows], True, seed_gen, aux=True)
        (_, t_aux), (_, t_main) = net(live, targets[k], True, seed_gen, aux=True)
        s_aux, s_main, t_aux, t_main = map(up, (s_aux, s_main, t_aux, t_main))
        seg = (float(spec["LAMBDA_SEG_MAIN"]) * cross_entropy(s_main, labels)
               + float(spec["LAMBDA_SEG_AUX"]) * cross_entropy(s_aux, labels))
        e_main, e_aux = entropy_map(t_main), entropy_map(t_aux)
        adv = (float(spec["LAMBDA_ADV_MAIN"]) * bce_logits(Net.disc(D, "d_main", e_main), 0.0)
               + float(spec["LAMBDA_ADV_AUX"]) * bce_logits(Net.disc(D, "d_aux", e_aux), 0.0))
        grads = dict(zip(trainable, torch.autograd.grad(seg + adv, [live[n] for n in trainable])))
        del live
        d_live = {n: v.detach().requires_grad_(True) for n, v in D.items()}
        d_loss = 0.0
        for pre, src_map, trg_map in (("d_main", s_main, e_main), ("d_aux", s_aux, e_aux)):
            d_loss = d_loss + (bce_logits(Net.disc(d_live, pre, entropy_map(src_map.detach())), 0.0)
                               / 2 + bce_logits(Net.disc(d_live, pre, trg_map.detach()), 1.0) / 2)
        d_grads = dict(zip(d_live, torch.autograd.grad(d_loss, list(d_live.values()))))
        del d_live
        out["losses"].append({"Segmentation loss": float(seg.detach()),
                              "Adversarial loss": float(adv.detach()),
                              "Discriminator loss": float(d_loss.detach())})
        if k == 0:
            out["grad"] = {**leaf_norms(grads), **leaf_norms(d_grads)}
            out["grad_tensors"] = {**host_copy(grads), **host_copy(d_grads)}
        sgd(params, momentum, grads, mult, lrs[k] * r0, lrs[k] * r1, float(spec["MOMENTUM"]),
            float(spec["WEIGHT_DECAY"]), model.HEADS)
        adam(D, adam_state, d_grads, float(spec["LEARNING_RATE_D"]))
        del grads, d_grads
    out["change"] = change_norms({**{k: params[k] for k in trainable}, **D}, p0)
    return out
