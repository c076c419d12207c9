"""The plain reference of PROTO_ONLINE_HYBRIDSWITCH, the hybrid teacher
policy: the prototypes bootstrapped from the source, then the adaptation
steps (EMA, static and gated dynamic teachers, the prototypes' pseudo-labels,
their moving average, the student's CE, RCE and MRKLD on the target and CE
on the source, SGD and the model EMA), in plain PyTorch on the
configuration's reference model (`benchmark/models/`). It imports nothing
of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchkit.reference import (change_norms, cross_entropy, host_copy, leaf_norms, mrkld,
                                reverse_ce, sgd)


def bootstrap_prototypes(net, P, images, labels, gen, classes):
    """Class means and mean squares of the features over the source frames,
    one frame a forward (train-mode BatchNorm, dropout), each pixel counted
    under its label resized by nearest to the feature grid."""
    vect = sq = count = None
    with torch.no_grad():
        for i in range(len(images)):
            _, (feat, _) = net(P, images[i:i + 1], True, gen)
            hh, ww = feat.shape[2:]
            lbl = F.interpolate(labels[i:i + 1, None].float(), size=(hh, ww), mode="nearest")
            lbl = lbl.reshape(-1).long()
            f = feat.permute(0, 2, 3, 1).reshape(-1, feat.shape[1]).double()
            onehot = (lbl[:, None] == torch.arange(classes, device=lbl.device)).double()
            v, s, c = onehot.T @ f, onehot.T @ (f * f), onehot.sum(0)
            vect, sq, count = (v, s, c) if vect is None else (vect + v, sq + s, count + c)
    safe = count.clamp(min=1.0)[:, None]
    return (vect / safe).float(), (sq / safe).float(), count.float()


def proto_labels(feat, mean, sq_mean, count, prior, tau, thresh):
    """Pseudo-labels from the prototypes: the diagonal-Mahalanobis distance
    of each pixel to each class mean (features scaled by the inverse global
    std, the count-weighted std over classes), softmax(−d/τ) fused with the
    teacher prior, renormalised; hard labels are its argmax where its max
    reaches `thresh`, else 255. Returns (soft, hard, max of softmax(−d/τ))."""
    w = count / count.sum()
    g_mean = (mean * w[:, None]).sum(0)
    g_sq = (sq_mean * w[:, None]).sum(0)
    scale = 1.0 / torch.sqrt(g_sq - g_mean**2)
    d = torch.cdist((feat * scale).double(), (mean * scale).double()).float()
    prop = F.softmax(-(d - d.min(dim=1, keepdim=True).values) / tau, dim=1)
    fused = prop * prior
    soft = fused / fused.sum(dim=1, keepdim=True)
    mx, arg = soft.max(dim=1)
    hard = torch.where(mx < thresh, torch.full_like(arg, 255), arg)
    return soft, hard, prop.max(dim=1).values


def _median(values):
    ordered = sorted(values)
    n = len(ordered)
    return 0.5 * (ordered[(n - 1) // 2] + ordered[n // 2])


def adapt_steps(spec: dict, model, weights: dict, source: dict, targets, src_order, lrs,
                seed_gen, compute=None, steps=3):
    """The first `steps` adaptation steps of the hybrid teacher policy from
    `weights`, prototypes bootstrapped from `source`.

    spec: the method's settings (the configuration's block); model: the
    configuration's reference model (`harness.Model`); source: {"image"
    (n, 3, H, W), "label" (n, H, W), "label_res" (n, h, w) at the model's
    feature grid} on the device; targets[k]: step k's target batch; src_order[k]: step k's rows
    of the source; lrs[k]: step k's base LR; seed_gen: the dropout
    generator, seeded as the method seeds it.

    Returns {"losses": [{name: value}], "grad": leaf → norm of step 1's
    gradient, "grad_tensors": that gradient on the host, "change": leaf →
    norm of the change over the steps, "fired": [bool], "proto": the
    bootstrapped prototypes {"mean", "sq_mean", "count"}}."""
    classes = 19
    net = model.Net(compute)
    p0 = {k: v.clone() for k, v in weights.items()}
    params = {k: v.clone() for k, v in weights.items()}
    ema = {k: v.clone() for k, v in weights.items()}
    mult = {k: model.multiplicity(k, aux_trained=False) for k in params}
    trainable = [k for k in params if mult[k]]
    momentum = {k: torch.zeros_like(params[k]) for k in trainable}
    mean, sq_mean, count = bootstrap_prototypes(net, params, source["image"], source["label"],
                                                seed_gen, classes)
    out = {"losses": [], "fired": [],
           "proto": {k: v.detach().to("cpu", torch.float64)
                     for k, v in (("mean", mean), ("sq_mean", sq_mean), ("count", count))}}
    tau = torch.tensor(float(spec["TAU"]), device=mean.device)
    lo, hi = spec["GRAY_AREA"]
    r0, r1 = (float(v) for v in spec.get("LR_RATIO", "1:10").split(":"))
    static_confs, current_dev = [], False
    for k in range(steps):
        trg = targets[k]
        with torch.no_grad():
            _, (feat, logits_ema) = net(ema, trg, True, seed_gen)
            prior_ema = F.softmax(logits_ema, dim=1)
            _, (_, logits_static) = net(p0, trg, False)
            prior_static = F.softmax(logits_static, dim=1)
            static_confs.append(float(prior_static.max(dim=1).values.mean()))
            conf = _median(static_confs)
            # the derivative of the static confidence is 0 until the monitor's
            # window fills, so inside the gray area the state stays as it was
            dynamic = True if conf < lo else (False if conf > hi else current_dev)
            out["fired"].append(dynamic)
            if dynamic:  # the dynamic teacher is the student as the domain began
                _, (_, logits_dyn) = net(p0, trg, False)
                prior = float(spec["DYNAMIC_LAMBDA"]) * F.softmax(logits_dyn, dim=1)
            else:
                prior = (float(spec["EMA_LAMBDA"]) * prior_ema
                         + float(spec["STATIC_LAMBDA"]) * prior_static)
            b, _, hh, ww = prior.shape
            flat_feat = feat.permute(0, 2, 3, 1).reshape(-1, feat.shape[1])
            flat_prior = prior.permute(0, 2, 3, 1).reshape(-1, classes)
            _, hard, _ = proto_labels(flat_feat, mean, sq_mean, count, flat_prior, tau,
                                      float(spec["PSEUDO_THRESH"]))
            pseudo = hard.view(b, hh, ww)
            # the prototypes' moving average over the classes the EMA teacher picks
            pick = logits_ema.permute(0, 2, 3, 1).reshape(-1, classes).argmax(dim=1)
            onehot = F.one_hot(pick, classes).float()
            sums = onehot.sum(0)
            present = (sums > 0)[:, None]
            lam = float(spec["MA_LAMBDA"])
            ff = flat_feat.float()
            mean = torch.where(present, lam * mean + (1 - lam) * (onehot.T @ ff)
                               / sums.clamp(min=1)[:, None], mean)
            sq_mean = torch.where(present, lam * sq_mean + (1 - lam) * (onehot.T @ (ff * ff))
                                  / sums.clamp(min=1)[:, None], sq_mean)
        live = {n: (v.detach().requires_grad_(True) if mult[n] else v) for n, v in params.items()}
        src_rows = src_order[k]
        _, (_, out_s) = net(live, source["image"][src_rows], True, seed_gen)
        buff_ce = cross_entropy(out_s, source["label_res"][src_rows])
        _, (_, out_t) = net(live, trg, True, seed_gen)
        ce = cross_entropy(out_t, pseudo)
        rce = reverse_ce(out_t, pseudo, classes)
        reg = mrkld(out_t)
        target_loss = (float(spec["RCE_ALPHA"]) * ce + float(spec["RCE_BETA"]) * rce
                       + float(spec["REGULARIZER_WEIGHT"]) * reg)
        total = target_loss + float(spec["BUFF_CE"]) * buff_ce
        grads = dict(zip(trainable, torch.autograd.grad(total, [live[n] for n in trainable])))
        del live
        out["losses"].append({"Total target loss": float(target_loss.detach()),
                              "buff_loss": float(spec["BUFF_CE"]) * float(buff_ce.detach())})
        if k == 0:
            out["grad"] = leaf_norms(grads)
            out["grad_tensors"] = host_copy(grads)
        sgd(params, momentum, grads, mult, lrs[k] * r0, lrs[k] * r1, float(spec["MOMENTUM"]),
            float(spec["WEIGHT_DECAY"]), model.HEADS)
        del grads
        e = float(spec["EMA_UPDATE"])
        with torch.no_grad():
            ema = {n: e * ema[n] + (1 - e) * params[n] for n in ema}
    out["change"] = change_norms({k: params[k] for k in trainable}, p0)
    return out
