"""PROTO_ADVENT: prototype pseudo-labels and adversarial entropy in one step
(`onda_tpu/methods/proto_advent.py`).

The reference composes an hswitch prototype model and an ADVENT instance
that share one network (reference methods/prototype_advent.py:14-152). One
step over (AdaptState, discriminator state):

    the prototype adapter's teachers, hswitch prior and K1 pseudo-labels (hard
    at the old τ, soft at the drifted τ) and the prototype EMA → the source
    slice on `alt_batch_stats`, whose update is kept (the reference's
    double-BN exchange, whatever BN_POLICY says) → the target slice on the
    main set → `seg`: CE of the upsampled source logits against the
    full-resolution label → the target losses (CE, RCE, regularizer, JS) at
    feature resolution against the pseudo-labels → `adv` on the upsampled
    target logits → one backward into the student → the discriminators' BCE
    on the detached maps with their pre-step weights → SGD, Adam and the
    model EMA.

It feeds no "model" monitor sample and has no AUTO_DYNAMIC, no buffer
insertions and no PREDICTION_SAVE. `save_model` is the prototype adapter's:
the discriminators are not in `adapt_state.pt`, so a resumed run restarts
them from their seeded init, and the snapshot is written once, at the end.

Under OTHERS.DATA_PARALLEL across ranks the step is the global batch's, as
in both methods it joins: the teachers, the prototype EMA and the monitor
are the PROTO_ONLINE step's (global confidences and moments); the source
CEs divide by the global valid count, the target losses by the global
pseudo-label count or pixel count, the BCEs by the global number of
discriminator outputs; the student's and the discriminators' gradients are
summed in a bucket each, and the logs that are shares or counts in a third.
Every rank ends the step with the same bits.

Under OTHERS.TENSOR_PARALLEL the student is the PROTO_ONLINE step's, in
channel shards on a (data × model) grid, and the batch splits over the data
axis only. The discriminators and their Adam states stay whole on every
rank, as JAX replicates them (`replicate_tree` beside the sharded
`AdaptState`): their gradients, alike on the model ranks of a data index,
are summed over every rank and divided by tp (`optim.sum_on_grid`).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.func import functional_call

from ..config import value_or
from ..models.discriminator import FCDiscriminator
from ..ops import losses as L
from ..ops.interp import upsample_bilinear_ac
from ..parallel import distributed as dist
from . import optim
from .advent import (_logits, discriminator_loss, entropy_map, fool_loss, init_discriminators,
                     run_adversarial, sum_grads)
from .proto_online import MONITOR_KEYS, LazyLogs, ProtoOnlineAdapter, global_counts
from .state import AdaptState


class ProtoAdventAdapter(ProtoOnlineAdapter):
    def __init__(self, model, variables, cfg, cfg_spec, num_classes: int, logger=None,
                 device="cuda"):
        super().__init__(model, variables, cfg, cfg_spec, num_classes, logger, device=device)
        self.disc = FCDiscriminator(num_classes).to(self.device)
        d_aux, d_main = init_discriminators(num_classes, self.device)
        self.d_state = {"aux": d_aux, "aux_opt": optim.adam_init(d_aux),
                        "main": d_main, "main_opt": optim.adam_init(d_main)}

    def _build_pa_step(self):
        spec = self.cfg_spec
        model, disc, hw = self.model, self.disc, self.resolution_hw
        multi = bool(self.cfg.MODEL.MULTI_LEVEL)
        soft_labels = bool(value_or(spec.SOFT_LABELS, False))
        rce_alpha, rce_beta = float(spec.RCE_ALPHA), float(spec.RCE_BETA)
        reg_weight, regularizer = float(spec.REGULARIZER_WEIGHT), spec.REGULARIZER
        js_d = float(spec.JS_D)
        l_seg_main, l_seg_aux = float(spec.LAMBDA_SEG_MAIN), float(spec.LAMBDA_SEG_AUX)
        l_adv_main, l_adv_aux = float(spec.LAMBDA_ADV_MAIN), float(spec.LAMBDA_ADV_AUX)
        momentum, weight_decay = float(spec.MOMENTUM), float(spec.WEIGHT_DECAY)
        ema_update = float(spec.EMA_UPDATE)
        labels = self.param_labels
        trainable = [k for k, lab in labels.items() if lab != optim.FROZEN]
        r0, r1 = self.lr_ratios
        monitor = self.monitor
        teachers = self._build_teachers()
        world = dist.data_world()
        sharded = set(self.plan)
        spans = self.spans

        def step(state: AdaptState, d_state: dict, src_images, src_labels, trg_images,
                 lr_base: float, lr_d: float):
            zero = torch.zeros((), device=trg_images.device)
            mon, switch, _, pseudolabels, soft_nchw, proto = teachers(state, trg_images)
            trg_count, (src_count,), all_pixels = global_counts(pseudolabels, src_labels)

            live = dict(state.params)
            for k in trainable:
                live[k] = state.params[k].detach().requires_grad_(True)

            def forward(stats, images):
                aux, main = functional_call(model, (live, stats), (images,), {
                    "train": True, "update_stats": True, "with_aux": multi,
                    "generator": state.generator})
                return (_logits(aux).float() if multi else None), main["out"].float()

            def up(x):
                return upsample_bilinear_ac(x, hw)

            src_aux, src_main = forward(state.alt_batch_stats, src_images)
            trg_aux, out_t = forward(state.batch_stats, trg_images)
            src_main_up = up(src_main)
            seg = l_seg_main * L.cross_entropy_2d(src_main_up, src_labels, count=src_count)
            if multi:
                src_aux_up = up(src_aux)
                seg = seg + l_seg_aux * L.cross_entropy_2d(src_aux_up, src_labels, count=src_count)
            trg_target = soft_nchw if soft_labels else pseudolabels
            n_trg = all_pixels if soft_labels else trg_count
            ce = (L.cross_entropy_2d(out_t, trg_target, soft=soft_labels, count=n_trg)
                  if rce_alpha > 0 else zero)
            rce_l = (L.rce(out_t, trg_target, soft=soft_labels, count=n_trg)
                     if rce_beta > 0 else zero)
            sym = rce_alpha * ce + rce_beta * rce_l
            reg = L.regular_loss(regularizer, out_t, count=all_pixels) if reg_weight > 0 else zero
            js = L.js_divergence(out_t, pseudolabels, count=trg_count) if js_d > 0 else zero
            total_t = sym + reg_weight * reg + js_d * js
            ent_main = entropy_map(up(out_t))
            adv = l_adv_main * fool_loss(disc, d_state["main"], ent_main, world)
            if multi:
                ent_aux = entropy_map(up(trg_aux))
                adv = adv + l_adv_aux * fool_loss(disc, d_state["aux"], ent_aux, world)
            grads = (optim.grid_grads(seg + total_t + adv, live, trainable, (), sharded)
                     if sharded else optim.grads(seg + total_t + adv, live, trainable))
            del live

            d_loss, d_main_g = discriminator_loss(
                disc, d_state["main"], entropy_map(src_main_up.detach()), ent_main, world)
            if multi:
                loss_aux, d_aux_g = discriminator_loss(
                    disc, d_state["aux"], entropy_map(src_aux_up.detach()), ent_aux, world)
                d_loss = d_loss + loss_aux
                d_main_g, d_aux_g = sum_grads(d_main_g, d_aux_g)
            else:
                (d_main_g,) = sum_grads(d_main_g)
            with torch.no_grad():
                optim.update(state.params, grads, state.opt_momentum, labels, lr_base * r0,
                             lr_base * r1, momentum, weight_decay)
                del grads
                optim.adam_update(d_state["main"], d_main_g, d_state["main_opt"], lr_d)
                if multi:
                    optim.adam_update(d_state["aux"], d_aux_g, d_state["aux_opt"], lr_d)
                for k, e in state.ema_params.items():
                    e.mul_(ema_update).add_(state.params[k], alpha=1.0 - ema_update)
                # the losses' shares and the pseudo-label count, summed over the ranks
                shares = {
                    "Segmentation loss": seg, "Adversarial loss": adv, "ce_loss": ce,
                    "rce_loss": rce_l, "sym_loss": sym, "regularization_loss": reg,
                    "JS Divergance loss": js, "Total target loss": total_t,
                    "Discriminator loss": d_loss,
                    "pseudolabel_pixel_num": L.valid_count(pseudolabels),
                }
                logs = dict(zip(shares, dist.all_sum(*shares.values())))
                logs["mean_prototype_intensity_values"] = (proto.mean**2).mean()
                for key in MONITOR_KEYS:
                    logs[f"{key} confidence ma"] = monitor.avg(mon, key)
                logs["dev avg prior static"] = monitor.dev_avg(mon, "prior static")
            new_state = dataclasses.replace(state, proto=proto, monitor=mon, switch=switch,
                                            step=state.step + 1)
            return new_state, d_state, LazyLogs(logs, spans)

        return step

    def pa_step_fn(self):
        if "adversarial" not in self._step_cache:
            self._step_cache["adversarial"] = self._build_pa_step()
        return self._step_cache["adversarial"]

    def train(self, trainloader, targetloader, validation_loaders) -> None:
        """Reference adv_proDA.train (prototype_advent.py:154-198): the dynamic
        teacher copied at each domain's start, the bootstrap and an evaluation
        unless SKIP_CALC, the loop, one checkpoint at the end."""
        spec = self.cfg_spec
        self._copy_dynamic()
        if not spec.SKIP_CALC:
            if not self.skip_proto:
                print("Computing Prototypes")
                self.calculate_prototypes(
                    trainloader if spec.STARTING_PROTO == "source" else targetloader)
                self.skip_proto = True
            self._log(self.evaluate_all(validation_loaders))
        step = self.pa_step_fn()

        def one(src, trg, lr, lr_d):
            self.state, self.d_state, logs = step(self.state, self.d_state, src["image"],
                                                  src["label"].long(), trg["image"], lr, lr_d)
            return logs

        run_adversarial(self, one, trainloader, targetloader, validation_loaders,
                        save_per_epoch=False)
        self.save_model()
