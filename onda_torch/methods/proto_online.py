"""Online prototype-based adaptation (`onda_tpu/methods/proto_online.py`).

One adaptation step over an `AdaptState`:

    EMA-teacher forward (train-mode BN on the student's buffers, no stat
    update) → static-teacher forward → switch policy, gating the dynamic
    teacher → K1 pseudo-labels (hard at the old τ, soft at the drifted τ) →
    prototype EMA → one student gradient pass over the source-replay and
    target slices → CE, RCE and regularizer → SGD with the LR_RATIO split →
    model EMA → monitor updates.

Forwards run through `torch.func.functional_call` on one module tree with
the state's parameter and buffer dicts; every train-mode BatchNorm takes its
statistics from K2. The step updates the student's parameters, momentum,
BN buffers and EMA teacher in place. Inside the step the host waits on the
device only once, for the dynamic teacher's gate (see `prior_policy`); the
scalar logs leave the device as one packed tensor, read when the caller first
looks at them.

BN_POLICY decides what the source-replay slices do to the BatchNorm running
statistics: `freeze` drops their updates, `double` runs them on the second
set (`alt_batch_stats`) and keeps its update, `keep` runs them on the main set
before the target slice, which then starts from their update.

Around the step, `train` feeds batches through `DeviceFeeder`s (the next
batch's copy overlaps the step), inserts pseudo-labeled target frames into a
replay buffer, refreshes the dynamic teacher under AUTO_DYNAMIC, dumps the
raw target logits under PREDICTION_SAVE, evaluates, renders samples and
checkpoints once per epoch. Under OTHERS.ASYNC_SAVE the checkpoint's disk
write runs in the background (`utils.checkpoint`). Under OTHERS.SCHEDULE,
or while OTHERS.PROFILE traces, the loop records its phases and the step
its `teachers`, `student` and `update` stages (`utils.spans.SpanRecorder`);
a model that records spans of its own (SegFormer: `encoder`, `decoder`,
`attention`) records them into the same recorder.

OTHERS.DATA_PARALLEL across ranks (`parallel`; one process per rank under
torchrun, each with the local slice of the global batch) computes the step
of the global batch, as GSPMD does for the JAX step on a `data` mesh: every
train-mode BatchNorm normalises with the global statistics, the confidences
the monitor records are global means, the prototype moments are summed over
the ranks before the EMA, each loss divides by the global count, and the
gradients are summed in one bucket. Every rank ends the step with the same
bits: parameters, prototypes, monitor and switch. Only rank 0 writes files;
each rank inserts its own frames into its own replay buffer. At world size
1 none of this makes a collective call.

OTHERS.TENSOR_PARALLEL = tp arranges the ranks as a (data × model) grid
(`parallel.mesh.resolve`): every tree of the state that holds the model's
tensors (student, momentum, BN buffers, teachers) keeps, on each rank, its
model index's channel shard of the leaves JAX's rule shards
(`parallel.tensor`), and the model gathers whole activations where a layer
needs every channel. The batch is split over the data axis only: the model
ranks of one data index take the same rows, and every reduction above runs
over the data group. The gradients of the sharded leaves are summed over
the data group; those of the whole (replicated) leaves, alike on every model
rank up to the card's nondeterministic backward kernels, over every rank and
divided by tp, so that the whole leaves keep the same bits on every rank.
Checkpoints hold the whole tensors, gathered by every rank and written by
rank 0, so a file moves freely between one process and a grid; a load keeps
this rank's shard.

On a (data × spatial) grid (`parallel.mesh.spatial_grid`, JAX's
`make_mesh(axes=("data", "spatial"))`) the bootstrap and the fused step run
on each rank's block of the image rows of its data index's samples
(`parallel.spatial`), and the loss-grid labels come split as the feature
grid. Every reduction over pixels above runs over data × spatial (the
"pixels" group): the blocks may be uneven (65 feature rows as 33/32), so
the confidences are sums over the global pixel count, not means of means;
the valid counts, the prototype moments, the logs and the gradients are
sums. K1 labels a rank's own pixels. The bootstrap's source labels come at
full resolution, split as the images; each rank fetches the label rows its
feature rows read. The state stays whole and equal on every rank, as JAX
replicates it. Evaluation, samples, prediction dumps and the train loop do
not run on that grid (JAX has none of them there): they raise.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from ..config import unset, value_or
from ..data.loader import DeviceFeeder, cycle, to_device
from ..ops import kernels as K
from ..ops import losses as L
from ..ops import metrics as M
from ..ops import prototypes as P
from ..ops.interp import resize_nearest, upsample_bilinear_ac
from ..ops.monitor import Monitor
from ..parallel import distributed as dist
from ..parallel import spatial as S
from ..parallel import tensor as T
from ..parallel.mesh import resolve
from ..utils import checkpoint as ckpt
from ..utils.spans import NULL, SpanRecorder, attach
from . import optim
from .prior_policy import POLICY_BY_METHOD, compute_prior
from .state import AdaptState, clone_tree, make_adapt_state
from .timing import samples_due

MONITOR_KEYS = (
    "model",
    "prior EMA",
    "prior static",
    "prior dynamic",
    "prior",
    "prototypes",
    "tau",
    "pseudolabel confidence",
    "percentage_static",
)

def dump_logits_batch(base: str, index: int, logits_nchw: torch.Tensor) -> None:
    """Write one prediction batch as the reference's consumers read it: an
    NCHW f32 tensor at `<base>/batch-{index}.pt` (reference
    adaptation_model.py:218-232)."""
    torch.save(logits_nchw.detach().float().to("cpu", copy=True).contiguous(),
               os.path.join(base, f"batch-{index}.pt"))


def global_counts(pseudolabels, *src_labels):
    """The losses' denominators under data parallelism and on a spatial
    axis, in one all-reduce: the global batch's valid pseudo-labels, each
    source batch's valid pixels, and the target's pixel count. With one
    rank of pixels all None: each loss counts its own batch, as on one
    device."""
    if dist.pixel_world() == 1:
        return None, [None] * len(src_labels), None
    trg, *src = dist.all_sum(L.valid_count(pseudolabels), *map(L.valid_count, src_labels),
                             group="pixels")
    return trg, src, S.global_pixels(*pseudolabels.shape)


def pixel_share(x):
    """m ↦ this rank's share of a global mean whose local value over x's
    (N, h, W) pixels is m: m over the data axis where every rank holds as
    many pixels, m weighted by x's part of the global pixels on a spatial
    axis."""
    if not S.active():
        world = dist.data_world()
        return lambda m: m / world
    part = x.numel() / S.global_pixels(*x.shape)
    return lambda m: m * part


def refuse_spatial(what: str) -> None:
    """Raise for host work that JAX does not run on a spatial axis."""
    if S.active():
        raise ValueError(f"{what} does not run on a spatial axis: it takes the PROTO_ONLINE "
                         "bootstrap and fused step only, as JAX's make_mesh does")


def _softmax(x):
    """Class probabilities of NCHW logits, in f32."""
    return F.softmax(x.float(), dim=1)


def _conf(p, dim=1):
    """Mean max-probability confidence (reference prototypes.py:215)."""
    return p.max(dim=dim).values.mean()


def pixel_means(means, x, sums=()):
    """`distributed.pixel_means` of this rank's means over the pixels of x
    (N, C, h, W): (global means, global sums)."""
    n, _, h, w = x.shape
    return dist.pixel_means(means, n * h * w, S.global_pixels(n, h, w), sums)


def _flat(x):
    """(N, C, H, W) → (N·H·W, C), pixels in (n, h, w) order."""
    return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])


def _union_ms(intervals) -> float:
    """Total length, in ms, of the union of (start, end) intervals in µs."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total / 1e3


def _stack(arrays):
    """Stack a leading axis; one array becomes a view (pinned memory stays pinned)."""
    if len(arrays) == 1:
        return arrays[0][None]
    return torch.stack(arrays) if isinstance(arrays[0], torch.Tensor) else np.stack(arrays)


class LazyLogs(dict):
    """Step logs: scalars packed into one f32 device tensor, read on the host
    (one device-to-host copy, a `sync` span of `spans` where given) the
    first time any of them is looked at; array entries (e.g.
    soft_predictions) are there from the start."""

    def __init__(self, logs: dict, spans=None):
        keys = sorted(k for k, v in logs.items() if not isinstance(v, torch.Tensor) or v.dim() == 0)
        super().__init__({k: v for k, v in logs.items() if k not in keys})
        self._scalar_keys = keys
        self._spans = spans
        self._packed = torch.stack([torch.as_tensor(logs[k]).detach().float().reshape(())
                                    .to(self._device(logs)) for k in keys]) if keys else None

    @staticmethod
    def _device(logs):
        for v in logs.values():
            if isinstance(v, torch.Tensor):
                return v.device
        return torch.device("cpu")

    def _materialize(self):
        if self._packed is not None:
            with NULL if self._spans is None else self._spans.sync("logs"):
                values = self._packed.tolist()
            super().update(zip(self._scalar_keys, values))
            self._packed = None

    def __getitem__(self, key):
        self._materialize()
        return super().__getitem__(key)

    def __contains__(self, key):
        return key in self._scalar_keys or super().__contains__(key)

    def get(self, key, default=None):
        self._materialize()
        return super().get(key, default)

    def pop(self, key, *default):
        if key in self._scalar_keys:
            self._materialize()
        return super().pop(key, *default)

    def keys(self):
        self._materialize()
        return super().keys()

    def items(self):
        self._materialize()
        return super().items()

    def values(self):
        self._materialize()
        return super().values()

    def __iter__(self):
        self._materialize()
        return super().__iter__()

    def __len__(self):
        self._materialize()
        return super().__len__()


class ProtoOnlineAdapter(T.ShardedModel):
    """Host-side engine: owns the AdaptState, the step and evaluation, and the
    reference's train loop (per-step logging, per-epoch cross-domain
    evaluation and checkpoint, reference prototypes.py:466-520)."""

    def __init__(self, model, variables, cfg, cfg_spec, num_classes: int, logger=None,
                 device="cuda"):
        _, tp = resolve(cfg, spatial=True)
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.cfg_spec = cfg_spec
        self.num_classes = num_classes
        self.logger = logger
        self.spans = SpanRecorder(self.device, enabled=bool(value_or(cfg.OTHERS.SCHEDULE, False)))
        attach(self.model, self.spans)
        self.policy = POLICY_BY_METHOD.get(cfg.METHOD.ADAPTATION.NAME, "base")

        mon_args = {}
        if not unset(cfg_spec.EXP_MONITOR_CONST):
            mon_args["exp_const"] = float(cfg_spec.EXP_MONITOR_CONST)
        if not unset(cfg_spec.DEV_MONITOR_FUNC):
            mon_args["dev_func"] = cfg_spec.DEV_MONITOR_FUNC
        self.monitor = Monitor(MONITOR_KEYS, limit=int(cfg_spec.AVG_MONITOR_SIZE),
                               device=self.device, **mon_args)

        proto = P.init_state(num_classes, model.feature_width,
                             tau=float(cfg_spec.TAU), device=self.device)
        self.skip_proto = False
        if isinstance(cfg_spec.LOAD_PROTO, str):
            proto, loaded = P.load(proto, cfg_spec.LOAD_PROTO)
            self.skip_proto = loaded
            if loaded:
                print("Prototypes loaded!")
        self.plan_shards(variables, tp)
        variables = {name: self._shard(tree) for name, tree in variables.items()}
        self.state = make_adapt_state(variables, proto, self.monitor.init(),
                                      seed=int(cfg.TRAINING.RANDOM_SEED), device=self.device)
        self.param_labels = optim.label_params(self.state.params, aux_grad=bool(model.multi_level))
        self.lr_ratios = self._lr_ratios()
        self.dynamic_update_counter = 0
        self.prediction_counter = {}
        self._step_cache = {}
        self._applied_spec = self._step_relevant_spec(cfg_spec)
        self.conf_reg_thresh = (
            1.0 if unset(cfg_spec.CONFIDENCE_REGULARIZATION_THRESHOLD)
            else float(cfg_spec.CONFIDENCE_REGULARIZATION_THRESHOLD))
        self.ece_record = not (isinstance(cfg.OTHERS.ECE_SKIP, bool) and cfg.OTHERS.ECE_SKIP)
        if not unset(cfg_spec.LOAD_MODEL) and cfg_spec.LOAD_MODEL:
            self.load_model(cfg_spec.LOAD_MODEL)

    # ------------------------------------------------------------------
    # configuration plumbing
    # ------------------------------------------------------------------
    def _lr_ratios(self):
        ratio = self.cfg.MODEL.LR_RATIO
        if ratio is None or unset(ratio):
            ratio = "1:10"
        r0, r1 = (int(v) for v in ratio.split(":"))
        return float(r0), float(r1)

    # spec keys the step never reads: set_ and SKIP_CALC change every domain,
    # EPOCHS only sizes the host loop
    _HOST_ONLY_SPEC_KEYS = ("set_", "SKIP_CALC", "EPOCHS")

    @classmethod
    def _step_relevant_spec(cls, spec):
        return copy.deepcopy({k: v for k, v in dict(spec).items()
                              if k not in cls._HOST_ONLY_SPEC_KEYS})

    def update_cfg_spec(self, new_spec):
        """Per-domain cfg overrides (reference train_ouda.py:248-260). A built
        step holds the spec's values, so a change of any key but the host-only
        ones drops the built steps. The CLI mutates the same spec object for
        every domain, so the comparison is against a copy of what was last
        applied."""
        snap = self._step_relevant_spec(new_spec)
        changed = snap != self._applied_spec
        self.cfg_spec = new_spec
        self._applied_spec = snap
        self.lr_ratios = self._lr_ratios()
        if changed:
            self._step_cache.clear()

    @property
    def resolution_hw(self):
        w, h = self.cfg.SCHEME.RESOLUTION
        return int(h), int(w)

    def _forward(self, params, stats, images, train, update_stats=False):
        """Model forward with the given parameter and buffer dicts; returns
        `main`. The multi-level aux head is not run: nothing here reads it."""
        _, main = functional_call(
            self.model, (params, stats), (images,),
            {"train": train, "update_stats": update_stats, "with_aux": False,
             "generator": self.state.generator if train else None})
        return main

    def _to_device(self, x, dtype=None):
        """x on the adapter's device (`loader.to_device`), converted there to dtype."""
        x = to_device(x, self.device)
        return x if dtype is None else x.to(dtype)

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def _build_teachers(self):
        """The step's no-grad part as a function of (state, target images):
        EMA-teacher forward (train-mode BN on the student's buffers, no stat
        update) → static-teacher forward → switch policy, gating the dynamic
        teacher → K1 pseudo-labels (hard at the old τ, soft at the drifted τ)
        → prototype EMA. Returns (monitor, switch, dynamic fired, hard labels
        (N, h, w), soft labels NCHW, prototypes). The `teachers` span holds
        it, with the EMA forward, the static forward, the gate and K1 with
        the prototypes as host-only children."""
        spec = self.cfg_spec
        monitor, policy, C = self.monitor, self.policy, self.num_classes
        metric = spec.DISTANCE_MEASURE
        ma_lambda = float(spec.MA_LAMBDA)
        pseudo_thresh = float(spec.PSEUDO_THRESH)
        static_on = float(spec.STATIC_LAMBDA) > 0
        conf_reg_thresh = self.conf_reg_thresh
        fwd = self._forward
        spans = self.spans

        @torch.no_grad()
        def teachers(state: AdaptState, trg_images):
            with spans.span("teachers", device=True):
                return stages(state, trg_images)

        def stages(state: AdaptState, trg_images):
            mon = state.monitor
            with spans.span("ema_forward"):
                ema_main = fwd(state.ema_params, state.batch_stats, trg_images, train=True)
                prior_ema = _softmax(ema_main["out"])
            prior_static = None
            with spans.span("static_forward"):
                if static_on:
                    static_main = fwd(state.static_params, state.static_batch_stats, trg_images,
                                      train=False)
                    prior_static = _softmax(static_main["out"])
                    (conf_ema, conf_static), _ = pixel_means(
                        [_conf(prior_ema), _conf(prior_static)], prior_ema)
                    mon = monitor.add(mon, "prior EMA", conf_ema)
                    mon = monitor.add(mon, "prior static", conf_static)
                else:
                    (conf_ema,), _ = pixel_means([_conf(prior_ema)], prior_ema)
                    mon = monitor.add(mon, "prior EMA", conf_ema)

            def dyn_forward():
                main = fwd(state.dynamic_params, state.dynamic_batch_stats, trg_images,
                           train=False)
                return _softmax(main["out"])

            with spans.span("gate"):
                prior, dyn_p, calc_dyn, switch, plogs = compute_prior(
                    policy, spec, monitor, mon, state.switch, prior_ema, prior_static,
                    dyn_forward, frozen=False, spans=spans)
            if "percentage_static" in plogs:
                mon = monitor.add(mon, "percentage_static", plogs["percentage_static"])
            # ---- K1 pseudo-labels: hard at the old τ, soft at the new τ
            with spans.span("k1_prototypes"):
                b, _, hh, ww = prior_ema.shape
                feat = _flat(ema_main["feat"]).float().contiguous()
                prior_flat = _flat(prior).contiguous()
                scale = P.inv_std(state.proto, metric)
                _, hard, prop_max = K.pseudo_labels(
                    feat, state.proto.mean, prior_flat, state.proto.tau, pseudo_thresh, scale)
                (conf_dyn, conf_prior, conf_proto), _ = pixel_means(
                    [_conf(dyn_p), _conf(prior), prop_max.mean()], prior_ema)
                mon = monitor.add(mon, "prior dynamic", conf_dyn, enable=calc_dyn)
                mon = monitor.add(mon, "prior", conf_prior)
                mon = monitor.add(mon, "prototypes", conf_proto)
                tau_bump = monitor.avg(mon, "prototypes") > conf_reg_thresh
                new_tau = state.proto.tau + 0.001 * tau_bump.float()
                mon = monitor.add(mon, "tau", new_tau, enable=tau_bump)
                soft, _, _ = K.pseudo_labels(
                    feat, state.proto.mean, prior_flat, new_tau, pseudo_thresh, scale)

                # ---- prototype EMA: the class moments of the global batch -----
                onehot = P.onehot_assign(_flat(ema_main["out"]).float())
                (conf_soft,), (vect, sq, sums) = pixel_means(
                    [_conf(soft, dim=-1)], prior_ema, P.class_moments(feat, onehot))
                mon = monitor.add(mon, "pseudolabel confidence", conf_soft)
                proto = P.ma(state.proto.replace(tau=new_tau), vect, sq, sums, ma_lambda)
                return (mon, switch, calc_dyn, hard.view(b, hh, ww),
                        soft.view(b, hh, ww, C).permute(0, 3, 1, 2), proto)

        return teachers

    def _build_step(self, have_src: bool, source_repeat: int, want_soft: bool,
                    want_pred: bool = False):
        spec = self.cfg_spec
        monitor = self.monitor
        soft_labels = bool(value_or(spec.SOFT_LABELS, False))
        rce_alpha, rce_beta = float(spec.RCE_ALPHA), float(spec.RCE_BETA)
        reg_weight, regularizer = float(spec.REGULARIZER_WEIGHT), spec.REGULARIZER
        js_d = float(spec.JS_D)
        model_reg = float(value_or(spec.MODEL_REGULARIZATION, 0.0))
        buff_ce_w, buff_rce_w = float(spec.BUFF_CE), float(spec.BUFF_RCE)
        bn_policy = spec.BN_POLICY if spec.BN_POLICY in ("freeze", "double", "keep") else "freeze"
        momentum, weight_decay = float(spec.MOMENTUM), float(spec.WEIGHT_DECAY)
        ema_update = float(spec.EMA_UPDATE)
        labels = self.param_labels
        trainable = [k for k, lab in labels.items() if lab != optim.FROZEN]
        # the multi-level aux head beside `layer6`: its forward is skipped (under
        # the ProDA layout `layer5` is the main head)
        aux_head = ({k for k in trainable if k.startswith("layer5.")}
                    if hasattr(self.model, "layer6") else set())
        r0, r1 = self.lr_ratios
        fwd = self._forward
        teachers = self._build_teachers()
        sharded = set(self.plan)
        spans = self.spans

        def step(state: AdaptState, trg_images, src_images, src_labels, lr_base: float):
            dev = trg_images.device
            zero = torch.zeros((), device=dev)
            mon, switch, calc_dyn, pseudolabels, soft_nchw, proto = teachers(state, trg_images)
            with spans.span("student", device=True):
                trg_count, src_counts, all_pixels = global_counts(
                    pseudolabels, *(src_labels[s] for s in range(source_repeat) if have_src))
                # this rank's share of a mean over the global batch's pixels
                share = pixel_share(pseudolabels)

                # ---- student: source slices (BN stats frozen) + target slice --
                live = dict(state.params)
                for k in trainable:
                    live[k] = state.params[k].detach().requires_grad_(True)
                trg_target = soft_nchw if soft_labels else pseudolabels
                buff_ce = buff_ce_last = buff_rce = buff_rce_last = zero
                if have_src:
                    # freeze: the source slices' stat updates are discarded, which
                    # is running them with update_stats=False; double: they start
                    # from the alt set and their updates become it; keep: they
                    # update the main set, which the target slice then starts from
                    src_stats = (state.alt_batch_stats if bn_policy == "double"
                                 else state.batch_stats)
                    for s in range(source_repeat):
                        out_s = fwd(live, src_stats, src_images[s], train=True,
                                    update_stats=bn_policy != "freeze")["out"].float()
                        if buff_ce_w > 0:
                            buff_ce_last = L.cross_entropy_2d(out_s, src_labels[s],
                                                              count=src_counts[s])
                            buff_ce = buff_ce + buff_ce_last
                        if buff_rce_w > 0:
                            buff_rce_last = L.rce(out_s, src_labels[s], count=src_counts[s])
                            buff_rce = buff_rce + buff_rce_last
                out_t = fwd(live, state.batch_stats, trg_images, train=True,
                            update_stats=True)["out"].float()
                n_trg = all_pixels if soft_labels else trg_count
                ce = (L.cross_entropy_2d(out_t, trg_target, soft=soft_labels, count=n_trg)
                      if rce_alpha > 0 else zero)
                rce_l = (L.rce(out_t, trg_target, soft=soft_labels, count=n_trg)
                         if rce_beta > 0 else zero)
                sym = rce_alpha * ce + rce_beta * rce_l
                reg = (L.regular_loss(regularizer, out_t, count=all_pixels) if reg_weight > 0
                       else zero)
                js = L.js_divergence(out_t, pseudolabels, count=trg_count) if js_d > 0 else zero
                # a term of the parameters alone enters once: on the ranks of data
                # (and spatial) index 0, each with its shards and the whole leaves
                mreg = mreg_log = zero
                if model_reg > 0 and dist.pixel_rank() == 0:
                    mreg = mreg_log = L.ewc_loss(model_reg, state.static_params, live)
                    if sharded:  # its value: the shards' terms summed over the model group
                        part = L.ewc_loss(model_reg, state.static_params,
                                          {k: v for k, v in live.items() if k in sharded}).detach()
                        mreg_log = mreg.detach() - part + dist.all_sum(part, group="model")[0]
                total_t = sym + reg_weight * reg + js_d * js + mreg
                total = total_t + buff_ce_w * buff_ce + buff_rce_w * buff_rce
                grads = (optim.grid_grads(total, live, trainable, aux_head, sharded) if sharded
                         else optim.grads(total, live, trainable, unused=aux_head))
                del live

            # ---- SGD + EMA ----------------------------------------------
            with torch.no_grad(), spans.span("update", device=True):
                out_t = out_t.detach()
                # the losses' shares and the batch means, summed over the ranks
                shares = {
                    "ce_loss": ce, "rce_loss": rce_l, "sym_loss": sym,
                    "regularization_loss": reg, "JS Divergance loss": js,
                    "Total target loss": total_t if mreg_log is mreg else total_t - mreg + mreg_log,
                    "model regularization": mreg_log,
                    "buff_ce_loss": buff_ce_last, "buff_rce_loss": buff_rce_last,
                    "buff_loss": buff_ce_w * buff_ce_last + buff_rce_w * buff_rce_last,
                    "pseudolabel_pixel_num": L.valid_count(pseudolabels),
                    "output & prototype agreement":
                        share((pseudolabels == out_t.argmax(dim=1)).float().mean()),
                    "model": share(_conf(_softmax(out_t))),
                }
                logs = dict(zip(shares, dist.all_sum(*(v.float() for v in shares.values()),
                                                     group="pixels")))
                mon = monitor.add(mon, "model", logs.pop("model"))
                optim.update(state.params, grads, state.opt_momentum, labels,
                             lr_base * r0, lr_base * r1, momentum, weight_decay)
                del grads
                for k, e in state.ema_params.items():
                    e.mul_(ema_update).add_(state.params[k], alpha=1.0 - ema_update)

                logs.update({
                    "mean_prototype_intensity_values": (proto.mean**2).mean(),
                    "encoder_lr": torch.full((), lr_base * r0, device=dev),
                    "dynamic forward fired": calc_dyn.float(),
                })
                for key in MONITOR_KEYS:
                    logs[f"{key} confidence ma"] = monitor.avg(mon, key)
                    logs[f"{key} exp confidence ma"] = monitor.exp_avg(mon, key)
                logs["dev avg prior static"] = monitor.dev_avg(mon, "prior static")
                if want_soft:
                    logs["soft_predictions"] = soft_nchw
                if want_pred:  # PREDICTION_SAVE: the raw target logits
                    logs["target_logits"] = out_t
                logs = LazyLogs(logs, spans)
            new_state = dataclasses.replace(state, proto=proto, monitor=mon, switch=switch,
                                            step=state.step + 1)
            return new_state, logs

        return step

    def step_fn(self, have_src: bool, source_repeat: int, want_soft: bool,
                want_pred: bool = False):
        key = (have_src, source_repeat, want_soft, want_pred)
        if key not in self._step_cache:
            self._step_cache[key] = self._build_step(*key)
        return self._step_cache[key]

    # ------------------------------------------------------------------
    # prototype bootstrap (reference calculate_prototypes, prototypes.py:128-155)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _bootstrap(self, images, labels, from_source: bool):
        # train-mode BN with frozen stats and live dropout (reference prototypes.py:473-478)
        state, C = self.state, self.num_classes
        main = self._forward(state.params, state.batch_stats, images, train=True)
        feat = _flat(main["feat"]).float()
        hh, ww = main["out"].shape[2:]
        if from_source:
            if S.active():  # label rows of this rank's feature rows, wherever they lie
                lbl = S.resize_nearest_labels(labels, (S.global_height(hh), ww))
            else:
                lbl = resize_nearest(labels, (hh, ww))
            lbl = lbl.reshape(-1).long()
            onehot = (lbl[:, None] == torch.arange(C, device=lbl.device)).float()  # 255 → zero row
        else:
            onehot = P.onehot_assign(_flat(main["out"]).float())
        vect, sq, sums = dist.all_sum(*P.class_moments(feat, onehot), group="pixels")
        state.proto = P.append(state.proto, vect, sq, sums)

    def calculate_prototypes(self, loader) -> None:
        from_source = self.cfg_spec.STARTING_PROTO == "source"
        it = loader.sequential() if hasattr(loader, "sequential") else loader
        for batch in it:
            images = self._to_device(batch["image"], torch.float32)
            labels = self._to_device(batch["label"], torch.long) if from_source else None
            self._bootstrap(images, labels, from_source)
        if dist.is_primary():
            P.save(self.state.proto, self._proto_path("current"))

    def _proto_path(self, tag):
        root = str(self.cfg.OTHERS.SNAPSHOT_DIR)
        os.makedirs(root, exist_ok=True)
        return os.path.join(root, f"proto_{tag}.pickle")

    # ------------------------------------------------------------------
    # evaluation (reference adaptation_model.py:127-179, prototypes.py:374-394)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _eval_batch(self, images, labels, valid_mask, hists, eces, with_proto: bool):
        state, spec, C, fwd = self.state, self.cfg_spec, self.num_classes, self._forward
        main = fwd(state.params, state.batch_stats, images, train=False)
        preds = {"model": main["out"]}
        if with_proto:
            # all teachers in eval mode; monitor and switch frozen
            ema_main = fwd(state.ema_params, state.batch_stats, images, train=False)
            prior_ema = _softmax(ema_main["out"])
            prior_static = None
            if float(spec.STATIC_LAMBDA) > 0:
                prior_static = _softmax(
                    fwd(state.static_params, state.static_batch_stats, images, train=False)["out"])

            def dyn_forward():
                return _softmax(
                    fwd(state.dynamic_params, state.dynamic_batch_stats, images, train=False)["out"])

            prior, _, _, _, _ = compute_prior(
                self.policy, spec, self.monitor, state.monitor, state.switch, prior_ema,
                prior_static, dyn_forward, frozen=True)
            b, _, hh, ww = prior_ema.shape
            soft, _, _ = K.pseudo_labels(
                _flat(ema_main["feat"]).float().contiguous(), state.proto.mean,
                _flat(prior).contiguous(), state.proto.tau, float(spec.PSEUDO_THRESH),
                P.inv_std(state.proto, spec.DISTANCE_MEASURE))
            preds["proto"] = soft.view(b, hh, ww, C).permute(0, 3, 1, 2)
        for key, logit_map in preds.items():
            probs = _softmax(upsample_bilinear_ac(logit_map.float(), self.resolution_hw))
            hists[key] += M.fast_hist(labels, probs.argmax(dim=1), C)
            if self.ece_record:
                eces[key] = M.ece_record(eces[key], probs, labels, valid_mask[:, None, None])

    def _proto_eval(self) -> bool:
        """Whether evaluation also scores the prototype predictions."""
        return not bool(value_or(self.cfg_spec.SKIP_PROTO_EVAL, False))

    def evaluate(self, loader) -> dict:
        refuse_spatial("evaluation")
        with_proto = self._proto_eval()
        keys = ["model"] + (["proto"] if with_proto else [])
        C = self.num_classes
        bins = 1000 if unset(self.cfg.OTHERS.BINS) else int(self.cfg.OTHERS.BINS)
        hists = {k: torch.zeros((C, C), dtype=torch.long, device=self.device) for k in keys}
        eces = {k: M.ece_init(bins, self.device) for k in keys}
        for batch in loader:
            labels = self._to_device(batch["label"], torch.long)
            valid = batch.get("valid", len(labels))
            if valid < len(labels):  # padded final batch: mask out the padding
                labels = labels.clone()
                labels[valid:] = 255
            valid_mask = (torch.arange(len(labels), device=self.device) < valid).float()
            self._eval_batch(self._to_device(batch["image"], torch.float32), labels, valid_mask,
                             hists, eces, with_proto)
        # every rank evaluated its shard of each set: sum the counts
        hists = dict(zip(hists, dist.all_sum(*hists.values())))
        if self.ece_record:
            eces = dict(zip(eces, dist.all_sum(*eces.values())))
        result = {k: M.per_class_iu(h) for k, h in hists.items()}
        self._last_ece = (
            {f"ece {k}": float(M.ece_value(a)) for k, a in eces.items()} if self.ece_record else {})
        return result

    def evaluate_all(self, validation_loaders: dict) -> dict:
        import numpy as np

        log = {}
        for val_set, loader in validation_loaders.items():
            for key, per_class in self.evaluate(loader).items():
                log[f"Val mIoU {key} of {val_set}"] = float(np.nanmean(per_class))
                log[f"Val std IoU {key} of {val_set}"] = float(np.nanstd(per_class))
            for name, value in getattr(self, "_last_ece", {}).items():
                log[f"{name} {val_set}"] = value
        return log

    @torch.no_grad()
    def _predict(self, images):
        """The student's class map at the input size: eval forward, bilinear
        align_corners upsample, argmax."""
        out = self._forward(self.state.params, self.state.batch_stats, images, train=False)["out"]
        return upsample_bilinear_ac(out.float(), self.resolution_hw).argmax(dim=1)

    def test_on_samples(self, validation_loaders: dict, n: int = 10) -> dict:
        """Up to n rendered samples per validation set (reference
        da_model.test_on_samples, adaptation_model.py:181-200), as `MaskSample`s
        whose PNG lies under SNAPSHOT_DIR/samples. The prediction of a batch
        comes to the host in one copy. Under data parallelism every rank
        predicts its rows, and rank 0 renders the global batch's (the ranks'
        rows in rank order), so that the samples are those of one device."""
        refuse_spatial("sample rendering")
        from ..data.metadata import load_dataset_info
        from ..utils.viz import MaskSample, denormalize_rgb, save_sample

        info = load_dataset_info()
        palette = info["palette"]
        class_labels = (self.cfg.classnum_to_label if not unset(self.cfg.classnum_to_label)
                        else info["classnum_to_label"])
        mean = self.cfg.SCHEME.MEAN if not unset(self.cfg.SCHEME.MEAN) else [0, 0, 0]
        std = self.cfg.SCHEME.STD if not unset(self.cfg.SCHEME.STD) else [255, 255, 255]
        out_dir = os.path.join(str(self.cfg.OTHERS.SNAPSHOT_DIR), "samples")
        log = {}
        for val_set, loader in validation_loaders.items():
            count = 0
            for batch in loader:
                images = self._to_device(batch["image"], torch.float32)
                preds = self._predict(images).int()
                label = batch.get("label")
                if dist.data_world() > 1:  # the global batch's rows
                    preds, images = dist.gather_rows(preds), dist.gather_rows(images)
                    if label is not None:
                        label = dist.gather_rows(self._to_device(label, torch.int32)).cpu()
                    batch = {"image": images.cpu()}
                preds = preds.cpu().numpy()
                for b in range(len(preds)):
                    if count >= n:
                        break
                    if dist.is_primary():
                        label_b = np.asarray(label[b]) if label is not None else None
                        rgb_b = denormalize_rgb(np.asarray(batch["image"][b]), mean, std)
                        name = f"{val_set}_{count}_step{int(self.state.step)}.png"
                        path = save_sample(rgb_b, preds[b], label_b, palette,
                                           os.path.join(out_dir, name))
                        log[f"Condition {val_set} sample {count}"] = MaskSample(
                            rgb_b, preds[b], label_b, class_labels, f"Sample from {val_set}", path)
                    count += 1
                if count >= n:
                    break
        return log

    def _copy_dynamic(self):
        self.state.dynamic_params = clone_tree(self.state.params)
        self.state.dynamic_batch_stats = clone_tree(self.state.batch_stats)

    def _maybe_update_dynamic(self, dev_fn) -> bool:
        """AUTO_DYNAMIC: refresh the dynamic teacher from the student when the
        static confidence's derivative moves, at most once per patience
        (reference evaluate_update_dynamic, prototypes.py:396-405). The counter
        counts every step, the derivative is read only strictly past the
        patience, |dev| must strictly exceed DEV_THRESH, and only a refresh
        resets the counter. `dev_fn` defers the read of the packed logs (one
        device-to-host copy) to the steps past the patience."""
        spec = self.cfg_spec
        patience = int(value_or(spec.AUTO_DYNAMIC_PATIENCE, 500))
        self.dynamic_update_counter += 1
        if self.dynamic_update_counter > patience and abs(float(dev_fn())) > float(spec.DEV_THRESH):
            self._copy_dynamic()
            self.dynamic_update_counter = 0
            return True
        return False

    def _save_prediction(self, logits_nchw) -> None:
        """Dump one step's raw target logits under PREDICTION_SAVE/<set>, one
        counter per domain (reference adaptation_model.py:218-232); under data
        parallelism rank 0 writes the global batch, the ranks' rows in rank
        order."""
        refuse_spatial("PREDICTION_SAVE")
        set_ = self.cfg_spec.set_
        base = os.path.join(str(self.cfg_spec.PREDICTION_SAVE), "_".join(str(set_)))
        counter = self.prediction_counter.setdefault(set_, 0)
        logits_nchw = dist.gather_rows(logits_nchw)
        if dist.is_primary():
            os.makedirs(base, exist_ok=True)
            dump_logits_batch(base, counter, logits_nchw)
        self.prediction_counter[set_] = counter + 1

    # ------------------------------------------------------------------
    # train loop (reference prototypes.py:466-520)
    # ------------------------------------------------------------------
    def train(self, trainloader, targetloader, validation_loaders) -> None:
        refuse_spatial("the train loop")
        spec = self.cfg_spec
        auto_dynamic = bool(value_or(spec.AUTO_DYNAMIC, False))
        if not auto_dynamic:  # AUTO_DYNAMIC refreshes the dynamic teacher itself
            self._copy_dynamic()
        if not spec.SKIP_CALC:
            if not self.skip_proto:
                print("Computing Prototypes")
                src = trainloader if spec.STARTING_PROTO == "source" else targetloader
                self.calculate_prototypes(src)
                self.skip_proto = True
            print("Model evaluation")
            self._log(self.evaluate_all(validation_loaders))

        steps = int(spec.EPOCHS) * len(targetloader)
        source_repeat = int(spec.SOURCE_REPEAT)
        have_src = float(self.cfg.TRAINING.REPLAY_BUFFER) > 0 and trainloader is not None
        perc_fill = float(value_or(self.cfg.TRAINING.PERC_FILL_PER_DOMAIN, 0.0))
        update_prob = 0.0
        if steps:
            update_prob = (perc_fill * float(self.cfg.TRAINING.REPLAY_BUFFER)
                           / float(self.cfg.TRAINING.BATCH_SIZE) / steps)
        # per-step raw prediction dumps (reference prototypes.py:286-287)
        want_pred = not unset(spec.PREDICTION_SAVE)
        step = self.step_fn(have_src, source_repeat, update_prob > 0, want_pred)
        # (OTHERS.AOT_CACHE, a cache of the JAX package's compiled step, has no
        # counterpart: the port compiles no step)

        # the next target batch's copy overlaps the current step; so does the
        # source replay's, unless it is drawn from a buffer that the steps'
        # insertions mutate: prefetching would draw each batch before the
        # previous step's insertions land, so such a buffer is drawn when the
        # step needs it (OTHERS.PREFETCH_SOURCE: true opts into the overlap)
        trg_feed = DeviceFeeder(cycle(targetloader), self.device, keys=("image",))
        if have_src:
            mutating = hasattr(trainloader, "add_from_batch")
            src_iter = iter(trainloader) if mutating else cycle(trainloader)
            src_feed = DeviceFeeder(
                self._stacked_source(src_iter, source_repeat), self.device,
                keys=("image", "label"),
                ahead=bool(value_or(self.cfg.OTHERS.PREFETCH_SOURCE, not mutating)))
        rng = np.random.default_rng(int(self.cfg.TRAINING.RANDOM_SEED))
        power = float(spec.POWER)
        base_lr = float(spec.LEARNING_RATE)
        # step-interval checkpoints, beyond the reference's per-epoch ones
        save_every = int(value_or(self.cfg.OTHERS.SAVE_EVERY, 0))
        # OTHERS.PROFILE: N traces N steps after the first 5 with
        # torch.profiler, written under SNAPSHOT_DIR/profile
        profile_steps = int(value_or(self.cfg.OTHERS.PROFILE, 0)) if dist.is_primary() else 0
        profile_at = 5
        if profile_steps and steps <= profile_at + profile_steps:
            print(f"OTHERS.PROFILE: need > {profile_at + profile_steps} steps, have {steps}; "
                  "skipping trace")
            profile_steps = 0
        profiler = None
        # OTHERS.SCHEDULE: the loop's spans (`utils.spans.SpanRecorder`) and their
        # log keys. Batch Fetch: waiting for the fed batches; Step Dispatch:
        # queueing the step; Host Work: insertions, evaluation, samples,
        # checkpoints; Log Sync: reading the step's packed logs; the stages'
        # device times on a card; the step's host reads
        schedule = bool(value_or(self.cfg.OTHERS.SCHEDULE, False))
        spans = self.spans
        frames_done = 0
        wall_t0 = time.perf_counter()
        for i_iter in range(steps):
            spans.enabled = schedule or 0 <= i_iter - profile_at < profile_steps
            with spans.step(i_iter):
                spans.phase("fetch")
                lr = base_lr * (1.0 - i_iter / steps) ** power if power else base_lr
                if have_src:
                    src_batch = next(src_feed)
                    src_images, src_labels = src_batch["image"], src_batch["label"].long()
                else:
                    src_images = src_labels = None
                if profile_steps and i_iter == profile_at:
                    profiler, profile_t0 = self._start_profile()
                trg_batch = next(trg_feed)
                spans.phase("dispatch")
                self.state, logs = step(self.state, trg_batch["image"], src_images, src_labels,
                                        lr)
                spans.phase("host_work")
                if want_pred:
                    self._save_prediction(logs.pop("target_logits"))
                if auto_dynamic:
                    self._maybe_update_dynamic(lambda: logs["dev avg prior static"])
                host_logs = {"Total buffer updates": self._buffer_update(
                    trg_batch, logs.pop("soft_predictions", None), update_prob, trainloader, rng)}
                if profiler is not None and i_iter + 1 == profile_at + profile_steps:
                    logs["Total target loss"]  # the profiled steps end at their packed-log read
                    self._stop_profile(profiler, profile_t0, profile_steps)
                    profiler = None
                if save_every and (i_iter + 1) % save_every == 0:
                    self.save_model()
                if i_iter == 0:
                    host_logs["Step compile+run seconds"] = time.perf_counter() - wall_t0
                    frames_done = 0
                    wall_t0 = time.perf_counter()
                else:
                    frames_done += int(trg_batch["image"].shape[0])
                if (i_iter + 1) % len(targetloader) == 0:
                    # streaming throughput of the epoch, host feed included;
                    # evaluation and checkpoints between epochs are not counted
                    elapsed = time.perf_counter() - wall_t0
                    if elapsed > 0 and frames_done:
                        host_logs["Adaptation frames per second"] = frames_done / elapsed
                    print("Model evaluation")
                    host_logs.update(self.evaluate_all(validation_loaders))
                    samples_every = int(value_or(self.cfg.OTHERS.GENERATE_SAMPLES_EVERY, 10))
                    if samples_due(samples_every, i_iter, len(targetloader)):
                        host_logs.update(self.test_on_samples(validation_loaders))
                    self.save_model()
                    frames_done = 0
                    wall_t0 = time.perf_counter()
                spans.phase("log_sync")
                logs.update(host_logs)
                if schedule:
                    logs["Total target loss"]  # force the packed device-to-host read
                spans.phase("log")
                if schedule:
                    logs.update(spans.loop_logs())
                self._log(logs)
        spans.enabled = schedule
        self.save_model()

    def _stacked_source(self, src_iter, source_repeat: int):
        """Source-replay batches with a leading SOURCE_REPEAT axis."""
        while True:
            batches = [next(src_iter) for _ in range(source_repeat)]
            yield {"image": _stack([b["image"] for b in batches]),
                   "label": _stack([self._src_label(b) for b in batches])}

    def _src_label(self, batch):
        if "stored_predictions" in batch:
            return batch["stored_predictions"]
        return batch["label_res"]

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        profiler = profile(activities=activities)
        profiler.start()
        return profiler, time.perf_counter()

    def _stop_profile(self, profiler, t0: float, n_steps: int) -> None:
        """Stop the trace and write it under SNAPSHOT_DIR/profile: the Chrome
        trace, the table by operator, and summary.json with the window's wall
        time and the time the device was busy in it (the union of the kernels'
        intervals on the trace's timeline; copies and memsets apart)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall_ms = 1e3 * (time.perf_counter() - t0)
        profiler.stop()
        out = os.path.join(str(self.cfg.OTHERS.SNAPSHOT_DIR), "profile")
        os.makedirs(out, exist_ok=True)
        trace = os.path.join(out, "trace.json")
        profiler.export_chrome_trace(trace)
        with open(os.path.join(out, "profile.txt"), "w") as f:
            f.write(profiler.key_averages().table(sort_by="self_cpu_time_total", row_limit=60))
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        busy = {kind: _union_ms([(e["ts"], e["ts"] + e["dur"]) for e in events
                                 if e.get("cat") in cats and "dur" in e])
                for kind, cats in (("kernel", ("kernel",)), ("copy", ("gpu_memcpy", "gpu_memset")))}
        summary = {"steps": n_steps, "wall_ms": wall_ms, "kernel_ms": busy["kernel"],
                   "copy_ms": busy["copy"],
                   "kernel_share": busy["kernel"] / wall_ms if wall_ms > 0 else float("nan"),
                   "device": str(self.device)}
        with open(os.path.join(out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)

    @torch.no_grad()
    def _buffer_update(self, trg_batch, soft_nchw, probability, trainloader, rng) -> int:
        """Insert pseudo-labeled target frames into the replay buffer (reference
        buffer_update, prototypes.py:453-464): each frame with `probability`,
        one `rng.random(batch)` draw per step. The soft predictions are
        upsampled (bilinear, align_corners) and argmaxed on the device; that
        map is the frame's `label`, and its nearest resize to the 1/8+1 grid
        its `label_res` and `stored_predictions`. Only the inserted rows come
        to the host, in three reads (`sync` spans)."""
        if probability <= 0 or soft_nchw is None or not hasattr(trainloader, "add_from_batch"):
            return 0
        hits = np.where(rng.random(len(trg_batch["image"])) < probability)[0]
        if not len(hits):
            return 0

        def host(x):
            with self.spans.sync("buffer"):
                return x.cpu().numpy()

        rows = torch.as_tensor(hits, device=soft_nchw.device)
        soft = soft_nchw.index_select(0, rows).float()
        up = upsample_bilinear_ac(soft, self.resolution_hw).argmax(dim=1).int()
        stored = host(resize_nearest(up, tuple(soft.shape[2:])))
        insert = {key: [value[i] for i in hits] for key, value in trg_batch.items()
                  if isinstance(value, list)}
        insert.update(image=host(trg_batch["image"].index_select(0, rows)),
                      label=host(up), label_res=stored, stored_predictions=stored)
        for j in range(len(hits)):
            trainloader.add_from_batch(insert, j)
        return len(hits)

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def save_model(self) -> None:
        """The full state as one `torch.save` (`adapt_state.pt`, replaced only
        once the new file is whole; written in the background under
        OTHERS.ASYNC_SAVE) plus the prototype pickle, always written at once
        (reference adaptation_model.py:202-216). Rank 0 writes both. Under
        tensor parallelism the file holds the whole tensors, in one
        process's layout: every rank joins their gather."""
        root = str(self.cfg.OTHERS.SNAPSHOT_DIR)
        s = self.state
        payload = {f.name: getattr(s, f.name) for f in dataclasses.fields(s)
                   if f.name not in ("proto", "monitor", "switch", "generator")}
        payload.update({k: self._whole(v) for k, v in payload.items() if isinstance(v, dict)})
        payload["proto"] = vars(s.proto)
        payload["monitor"] = vars(s.monitor)
        payload["switch"] = vars(s.switch)
        payload["generator"] = s.generator.get_state()
        ckpt.save_atomic(payload, os.path.join(root, "adapt_state.pt"),
                         wait=not value_or(self.cfg.OTHERS.ASYNC_SAVE, False))
        if dist.is_primary():
            P.save(s.proto, self._proto_path(self.cfg_spec.set_ or "current"))

    def load_newest(self, candidates, skip: str):
        """Load the newest of `candidates` (paths, oldest first) that loads,
        printing `<skip> skip: <name> (...)` for each newer one that does not
        (a crash while writing can leave one behind); returns its path, or
        None when none loads. Under data parallelism the candidates are rank
        0's list, and every rank loads the same file (`load_agreed`)."""
        for cand in reversed(dist.from_primary([str(c) for c in candidates])):
            if self.load_agreed(Path(cand), skip):
                return Path(cand)
        return None

    def load_agreed(self, path: Path, skip: str) -> bool:
        """Load `path` on every rank or on none, printing `<skip> skip: ...`
        when it does not load; returns whether it loaded. The ranks agree
        twice: after reading the file (a rank that cannot read it, say one
        that sees a file still being written, makes every rank skip it,
        before any state changed) and after applying it, which checks the
        contents before it changes the state, so that a file unfit on one
        rank is unfit on all. At world size 1: one try of `load_model`."""
        payload = error = None
        try:
            payload = self.read_checkpoint(str(path))
        except Exception as exc:  # noqa: BLE001 - an unreadable file: the caller tries the next
            error = exc
        if not dist.any_true(error is not None):
            try:
                self.load_model(str(path), payload)
            except Exception as exc:  # noqa: BLE001 - contents this adapter cannot take
                error = exc
            if not dist.any_true(error is not None):
                return True
            if error is None:
                raise RuntimeError(f"{path} loaded on this rank but not on another: the ranks' "
                                   "states now differ")
        why = f"{type(error).__name__}: {error}" if error is not None else "on another rank"
        print(f"{skip} skip: {path.name} (unloadable: {why})")
        return False

    def read_checkpoint(self, path: str):
        """A checkpoint's contents, its tensors on this adapter's device."""
        return ckpt.load(path, map_location=self.device, weights_only=False)

    def load_model(self, path: str, payload=None) -> None:
        """`adapt_state.pt` restores the full state (exact resume); an ADVENT
        run's `advent_state.pt` lends the student (params and BN buffers, as
        the JAX runner lifts them); any other file is a model state_dict and
        restores the student only. `payload`: the file's contents, if already
        read. A file this adapter cannot take raises before the state changes.
        Files hold whole tensors; under tensor parallelism each rank keeps its
        shards."""
        payload = self.read_checkpoint(path) if payload is None else payload
        s = self.state
        if "params" in payload and "proto" in payload:
            gen_state = payload.pop("generator")
            proto, mon, switch = (payload.pop(k) for k in ("proto", "monitor", "switch"))
            payload = {k: self._shard(v) if isinstance(v, dict) else v for k, v in payload.items()}
            self.state = dataclasses.replace(
                s, **payload, proto=P.ProtoState(**proto), monitor=type(s.monitor)(**mon),
                switch=type(s.switch)(**switch))
            self.state.generator.set_state(gen_state.cpu() if hasattr(gen_state, "cpu") else gen_state)
            return
        if "params" in payload and "d_main" in payload:
            payload = {**payload["params"], **payload["batch_stats"]}
        missing = (set(s.params) | set(s.batch_stats)) - set(payload)
        if missing:
            raise KeyError(f"state_dict is missing {sorted(missing)[:8]}")
        shapes = [k for tree in (s.params, s.batch_stats) for k in tree
                  if tuple(payload[k].shape) != self.full_shapes[k]]
        if shapes:
            raise ValueError(f"state_dict shapes differ from the model's at {shapes[:8]}")
        payload = self._shard({k: payload[k] for tree in (s.params, s.batch_stats) for k in tree})
        for tree in (s.params, s.batch_stats):
            for k, v in tree.items():
                v.copy_(payload[k])

    def _log(self, metrics: dict) -> None:
        if self.logger is not None:
            self.logger.log(metrics)
