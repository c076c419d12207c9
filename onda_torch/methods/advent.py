"""ADVENT, adversarial entropy minimisation (`onda_tpu/methods/advent.py`).

One step over an `AdventState` (reference methods/advent_da.py:40-214):

    source and target student forwards in train-mode BN (K2 gives every
    BatchNorm its batch statistics; the source slice's running-stat update is
    dropped, whatever BN_POLICY says) → main logits, and the aux head's under
    MULTI_LEVEL, upsampled to the input size (bilinear, align_corners) →
    `seg`: CE of the source logits against the full-resolution label, plus
    λ_seg_aux × the aux CE → `adv`: BCE of the discriminators on the target
    entropy maps toward SOURCE → one backward of seg + adv into the student
    → the discriminators' BCE on the detached maps of the same pass, with
    their weights from before the step → SGD on the student (LR_RATIO split,
    poly LR) and Adam on `d_main`, and on `d_aux` only under MULTI_LEVEL.

The discriminators are cuDNN convolutions (`models/discriminator.py`); the
JAX package wrote no kernel for them. The step updates the student's
parameters, momentum and BN buffers and both discriminators and their Adam
states in place; its three scalar logs leave the device as one packed
tensor. No host sync is inside the step.

Around the step, `train` feeds the source replay and the target stream
through `DeviceFeeder`s, evaluates the student, renders samples and writes
`advent_state.pt` once per epoch and at the end (`run_adversarial`, which
PROTO_ADVENT shares). Under OTHERS.SCHEDULE the loop records its phases and
the step its `student` and `update` stages (`utils.spans.SpanRecorder`).

Under OTHERS.DATA_PARALLEL across ranks (`parallel`; each rank holds the
local slice of the global batch) the step is the global batch's, as GSPMD
makes the JAX step on a `data` mesh: every train-mode BatchNorm takes the
global statistics, the source CEs divide by the global valid count and the
BCEs by the global number of discriminator outputs, so the ranks' losses sum
to the global ones; the student's gradients go in one bucket and both
discriminators' in another before Adam, and the three logs are summed in a
third. Every rank ends the step with the same bits, the discriminators and
their Adam states included. The loop makes the same calls in the same order
on every rank (the loaders give each as many batches); evaluation, samples
and `save_model` run on every rank and only rank 0 writes. At world size 1
none of this makes a collective call.

Under OTHERS.TENSOR_PARALLEL the ranks form a (data × model) grid
(`parallel.mesh.resolve`), and each holds its model index's channel shard of
the leaves JAX's rule shards (`parallel.tensor`), as JAX shards the whole
`AdventState`: the student, its BN buffers and momentum, and in both
discriminators `conv1`-`conv3` with their Adam moments (`count` stays
whole). The batch splits over the data axis only, so the counts and BCE
denominators above are the data axis's. The gradients of the sharded leaves
are summed over the data group, those of the whole leaves over every rank
and divided by tp (`optim.sum_on_grid`), so that the whole leaves keep the
same bits on every rank. `advent_state.pt` holds the whole tensors, gathered
by every rank and written by rank 0, in one process's layout; a load keeps
this rank's shards.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.nn.functional as F
from torch.func import functional_call

from ..config import value_or
from ..data.loader import DeviceFeeder, cycle
from ..models.discriminator import FCDiscriminator, seeded_fc_discriminator
from ..ops import losses as L
from ..ops.interp import upsample_bilinear_ac
from ..parallel import distributed as dist
from ..parallel import tensor as T
from ..parallel.mesh import resolve
from ..utils import checkpoint as ckpt
from ..utils.spans import SpanRecorder, attach
from . import optim
from .proto_online import LazyLogs, ProtoOnlineAdapter
from .timing import samples_due

SOURCE_LABEL, TARGET_LABEL = 0.0, 1.0  # advent.py:35
# the JAX package draws d_aux from key 1 and d_main from key 2; the port seeds
# PyTorch's default init the same way
D_AUX_SEED, D_MAIN_SEED = 1, 2


@dataclasses.dataclass
class AdventState:
    params: dict
    batch_stats: dict
    opt_momentum: dict
    d_aux: dict                   # the aux head's discriminator
    d_aux_opt: dict               # its Adam state {"mu", "nu", "count"}
    d_main: dict
    d_main_opt: dict
    generator: torch.Generator    # dropout randomness
    step: int = 0


def _logits(out):
    return out["out"] if isinstance(out, dict) else out


def entropy_map(logits):
    """The discriminators' input: the entropy map of NCHW logits."""
    return L.prob_2_entropy(F.softmax(logits.float(), dim=1))


def init_discriminators(num_classes: int, device) -> tuple[dict, dict]:
    """(d_aux, d_main) parameters, seeded."""
    return tuple({k: v.to(device) for k, v in seeded_fc_discriminator(num_classes, seed).items()}
                 for seed in (D_AUX_SEED, D_MAIN_SEED))


def _bce(logits, label: float, world: int):
    """The BCE's mean over the outputs of the global batch of `world` equal
    slices: this rank's share of it."""
    return L.bce_with_logits(logits, label, count=None if world == 1 else world * logits.numel())


def discriminator_loss(disc, d_params: dict, src_ent, trg_ent, world: int = 1):
    """One discriminator's BCE with its current weights, source maps toward
    SOURCE and target maps toward TARGET, each term /2; returns (loss, grads),
    this rank's shares under a data axis of `world` ranks (the gradients are
    summed by `sum_grads`). The maps are detached: no gradient reaches the student."""
    live = {k: v.detach().requires_grad_(True) for k, v in d_params.items()}
    loss = (_bce(functional_call(disc, live, (src_ent.detach(),)), SOURCE_LABEL, world) / 2
            + _bce(functional_call(disc, live, (trg_ent.detach(),)), TARGET_LABEL, world) / 2)
    grads = torch.autograd.grad(loss, list(live.values()))
    return loss.detach(), dict(zip(live, grads))


def fool_loss(disc, d_params: dict, trg_ent, world: int = 1):
    """The student's adversarial BCE: target maps toward SOURCE through the
    discriminator's current weights, which take no gradient."""
    return _bce(functional_call(disc, d_params, (trg_ent,)), SOURCE_LABEL, world)


def sum_grads(*grads: dict, sharded=()) -> tuple:
    """The discriminators' gradient dicts summed over the ranks
    (`torch.autograd.grad` bypasses `optim.grads`' bucket) by
    `optim.sum_on_grid`: the names in `sharded` are channel shards, summed
    over the data group; the whole leaves are summed over every rank and
    divided by the model axis's size, in one all-reduce without a grid. The
    dicts themselves at world size 1."""
    flat = {(i, k): g for i, d in enumerate(grads) for k, g in d.items()}
    flat = optim.sum_on_grid(flat, {key for key in flat if key[1] in sharded})
    return tuple({k: flat[(i, k)] for k in d} for i, d in enumerate(grads))


def run_adversarial(adapter, step, trainloader, targetloader, validation_loaders,
                    save_per_epoch: bool) -> None:
    """The adversarial methods' loop (reference advent_da.py:130-214,
    prototype_advent.py:154-198): EPOCHS × len(targetloader) steps, the
    student's LR poly over them and the discriminators' constant; the source
    from the replay buffer's iterator or a cycled loader, both feeds a batch
    ahead on the device. Per epoch: evaluation, samples when due and, with
    `save_per_epoch`, a checkpoint. `step(src, trg, lr, lr_d)` runs one step
    on the fed batches and returns its logs."""
    if trainloader is None:
        raise ValueError("the adversarial methods train on a source replay: "
                         "TRAINING.REPLAY_BUFFER must be > 0")
    spec = adapter.cfg_spec
    steps = int(spec.EPOCHS) * len(targetloader)
    if not steps:
        return
    src_iter = iter(trainloader) if hasattr(trainloader, "add_from_batch") else cycle(trainloader)
    src_feed = DeviceFeeder(src_iter, adapter.device, keys=("image", "label"))
    trg_feed = DeviceFeeder(cycle(targetloader), adapter.device, keys=("image",))
    base_lr, lr_d = float(spec.LEARNING_RATE), float(spec.LEARNING_RATE_D)
    power = float(spec.POWER)
    samples_every = int(value_or(adapter.cfg.OTHERS.GENERATE_SAMPLES_EVERY, 10))
    # OTHERS.SCHEDULE: the loop's spans and their log keys, as the prototype loop's
    schedule = bool(value_or(adapter.cfg.OTHERS.SCHEDULE, False))
    spans = adapter.spans
    for i_iter in range(steps):
        with spans.step(i_iter):
            spans.phase("fetch")
            lr = base_lr * (1.0 - i_iter / steps) ** power if power else base_lr
            src, trg = next(src_feed), next(trg_feed)
            spans.phase("dispatch")
            logs = step(src, trg, lr, lr_d)
            spans.phase("host_work")
            if (i_iter + 1) % len(targetloader) == 0:
                logs.update(adapter.evaluate_all(validation_loaders))
                # reference advent_da.py:208-211 (its `% samples_every` of an
                # already-0 remainder is always 0: samples every epoch)
                if samples_due(samples_every, i_iter, len(targetloader)):
                    logs.update(adapter.test_on_samples(validation_loaders))
                if save_per_epoch:
                    adapter.save_model()
            spans.phase("log_sync")
            if schedule:
                logs.keys()  # force the packed device-to-host read
            spans.phase("log")
            if schedule:
                logs.update(spans.loop_logs())
            adapter._log(logs)


class AdventAdapter(T.ShardedModel):
    """Owns the `AdventState`, the step, evaluation and the loop. The student's
    evaluation (model predictions only, the prototype adapter's key names),
    samples and the snapshot fallback are the prototype adapter's; the
    shards of the grid (`plan`, `full_shapes`, `_shard`, `_whole`) are
    `ShardedModel`'s, as they are the prototype adapter's."""

    resolution_hw = ProtoOnlineAdapter.resolution_hw
    _lr_ratios = ProtoOnlineAdapter._lr_ratios
    _forward = ProtoOnlineAdapter._forward
    _to_device = ProtoOnlineAdapter._to_device
    _eval_batch = ProtoOnlineAdapter._eval_batch
    evaluate = ProtoOnlineAdapter.evaluate
    evaluate_all = ProtoOnlineAdapter.evaluate_all
    _predict = ProtoOnlineAdapter._predict
    test_on_samples = ProtoOnlineAdapter.test_on_samples
    load_newest = ProtoOnlineAdapter.load_newest
    load_agreed = ProtoOnlineAdapter.load_agreed
    read_checkpoint = ProtoOnlineAdapter.read_checkpoint
    _log = ProtoOnlineAdapter._log

    def __init__(self, model, variables, cfg, cfg_spec, num_classes: int, logger=None,
                 device="cuda"):
        _, tp = resolve(cfg)
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.cfg_spec = cfg_spec
        self.num_classes = num_classes
        self.logger = logger
        self.spans = SpanRecorder(self.device, enabled=bool(value_or(cfg.OTHERS.SCHEDULE, False)))
        attach(self.model, self.spans)
        self.disc = FCDiscriminator(num_classes).to(self.device)
        self.plan_shards(variables, tp)
        variables = {name: self._shard(tree) for name, tree in variables.items()}
        params = {k: v.detach().to(self.device) for k, v in variables["params"].items()}
        d_aux, d_main = init_discriminators(num_classes, self.device)
        # both discriminators' plan (one shape); it shards their Adam moments too
        self.disc_plan = T.tensor_parallel_plan(d_main, tp) if tp > 1 else {}
        d_aux, d_main = self._shard(d_aux, self.disc_plan), self._shard(d_main, self.disc_plan)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(int(cfg.TRAINING.RANDOM_SEED))
        self.state = AdventState(
            params=params,
            batch_stats={k: v.detach().to(self.device)
                         for k, v in variables.get("batch_stats", {}).items()},
            opt_momentum=optim.init(params),
            d_aux=d_aux, d_aux_opt=optim.adam_init(d_aux),
            d_main=d_main, d_main_opt=optim.adam_init(d_main),
            generator=generator)
        self.param_labels = optim.label_params(params, aux_grad=bool(model.multi_level))
        self.ece_record = not (isinstance(cfg.OTHERS.ECE_SKIP, bool) and cfg.OTHERS.ECE_SKIP)

    def update_cfg_spec(self, new_spec):
        """Per-domain cfg overrides: `train` builds its step from the spec."""
        self.cfg_spec = new_spec

    def _proto_eval(self) -> bool:
        return False

    def build_step(self):
        """The step as a function of (state, source images, full-resolution
        source labels, target images, lr, lr_d) → (state, logs)."""
        spec = self.cfg_spec
        model, disc, hw = self.model, self.disc, self.resolution_hw
        multi = bool(self.cfg.MODEL.MULTI_LEVEL)
        l_seg_main, l_seg_aux = float(spec.LAMBDA_SEG_MAIN), float(spec.LAMBDA_SEG_AUX)
        l_adv_main, l_adv_aux = float(spec.LAMBDA_ADV_MAIN), float(spec.LAMBDA_ADV_AUX)
        momentum, weight_decay = float(spec.MOMENTUM), float(spec.WEIGHT_DECAY)
        labels = self.param_labels
        trainable = [k for k, lab in labels.items() if lab != optim.FROZEN]
        r0, r1 = self._lr_ratios()
        world = dist.data_world()
        sharded, d_sharded = set(self.plan), set(self.disc_plan)
        spans = self.spans

        def step(state: AdventState, src_images, src_labels, trg_images, lr_base: float,
                 lr_d: float):
            with spans.span("student", device=True):
                # the source CEs' denominator: the global batch's valid pixels
                # (None: the CE counts its own batch, as on one device)
                src_count = dist.all_sum(L.valid_count(src_labels))[0] if world > 1 else None
                live = dict(state.params)
                for k in trainable:
                    live[k] = state.params[k].detach().requires_grad_(True)

                def forward(images, update_stats):
                    aux, main = functional_call(model, (live, state.batch_stats), (images,), {
                        "train": True, "update_stats": update_stats, "with_aux": multi,
                        "generator": state.generator})
                    up = (lambda o: upsample_bilinear_ac(_logits(o).float(), hw))
                    return (up(aux) if multi else None), up(main)

                # the running statistics come from the target slice alone
                src_aux, src_main = forward(src_images, False)
                trg_aux, trg_main = forward(trg_images, True)
                seg = l_seg_main * L.cross_entropy_2d(src_main, src_labels, count=src_count)
                ent_main = entropy_map(trg_main)
                adv = l_adv_main * fool_loss(disc, state.d_main, ent_main, world)
                if multi:
                    seg = seg + l_seg_aux * L.cross_entropy_2d(src_aux, src_labels,
                                                               count=src_count)
                    ent_aux = entropy_map(trg_aux)
                    adv = adv + l_adv_aux * fool_loss(disc, state.d_aux, ent_aux, world)
                grads = (optim.grid_grads(seg + adv, live, trainable, (), sharded) if sharded
                         else optim.grads(seg + adv, live, trainable))
                del live

            with spans.span("update", device=True):
                d_loss, d_main_g = discriminator_loss(
                    disc, state.d_main, entropy_map(src_main.detach()), ent_main, world)
                if multi:
                    loss_aux, d_aux_g = discriminator_loss(
                        disc, state.d_aux, entropy_map(src_aux.detach()), ent_aux, world)
                    d_loss = d_loss + loss_aux
                    d_main_g, d_aux_g = sum_grads(d_main_g, d_aux_g, sharded=d_sharded)
                else:
                    (d_main_g,) = sum_grads(d_main_g, sharded=d_sharded)
                optim.update(state.params, grads, state.opt_momentum, labels, lr_base * r0,
                             lr_base * r1, momentum, weight_decay)
                optim.adam_update(state.d_main, d_main_g, state.d_main_opt, lr_d)
                if multi:  # without MULTI_LEVEL d_aux and its Adam state stay as they are
                    optim.adam_update(state.d_aux, d_aux_g, state.d_aux_opt, lr_d)
                # the ranks' shares summed: the global batch's losses
                logs = LazyLogs(dict(zip(
                    ("Discriminator loss", "Segmentation loss", "Adversarial loss"),
                    dist.all_sum(d_loss, seg.detach(), adv.detach()))), spans)
            return dataclasses.replace(state, step=state.step + 1), logs

        return step

    def train(self, trainloader, targetloader, validation_loaders) -> None:
        if not self.cfg_spec.SKIP_CALC:
            self._log(self.evaluate_all(validation_loaders))
        step = self.build_step()

        def one(src, trg, lr, lr_d):
            self.state, logs = step(self.state, src["image"], src["label"].long(), trg["image"],
                                    lr, lr_d)
            return logs

        run_adversarial(self, one, trainloader, targetloader, validation_loaders,
                        save_per_epoch=True)
        self.save_model()

    # ------------------------------------------------------------------
    # persistence (reference advent_da.py:62-70)
    # ------------------------------------------------------------------
    def _trees(self, state: dict, cut) -> dict:
        """`state`'s trees of tensors through cut(tree, plan): the student's
        with the student's plan, the discriminators' and their Adam moments
        with theirs."""
        out = dict(state)
        for name in ("params", "batch_stats", "opt_momentum"):
            out[name] = cut(state[name], self.plan)
        for name in ("d_aux", "d_main"):
            out[name] = cut(state[name], self.disc_plan)
            opt = state[f"{name}_opt"]
            out[f"{name}_opt"] = {**opt, "mu": cut(opt["mu"], self.disc_plan),
                                  "nu": cut(opt["nu"], self.disc_plan)}
        return out

    def save_model(self) -> None:
        """`advent_state.pt`: the student, its BN buffers and momentum, both
        discriminators, both Adam states, the dropout generator and the step,
        replaced only once the new file is whole (written in the background under
        OTHERS.ASYNC_SAVE). On a grid every rank joins the gathers of its
        shards, and rank 0 writes the whole tensors."""
        s = self.state
        payload = self._trees({f.name: getattr(s, f.name) for f in dataclasses.fields(s)
                               if f.name != "generator"}, self._whole)
        payload["generator"] = s.generator.get_state()
        ckpt.save_atomic(payload, os.path.join(str(self.cfg.OTHERS.SNAPSHOT_DIR), "advent_state.pt"),
                         wait=not value_or(self.cfg.OTHERS.ASYNC_SAVE, False))

    def load_model(self, path: str, payload=None) -> None:
        """Restore a whole `advent_state.pt` (an exact resume); `payload`: its
        contents, if already read. A file that is not one raises before the
        state changes. On a grid each rank keeps its shards of the file's
        whole tensors."""
        payload = self.read_checkpoint(path) if payload is None else payload
        missing = {f.name for f in dataclasses.fields(self.state)} - set(payload)
        if missing:
            raise KeyError(f"{path} is not an ADVENT snapshot: it lacks {sorted(missing)}")
        gen_state = payload.pop("generator")
        self.state = dataclasses.replace(self.state, **self._trees(payload, self._shard))
        self.state.generator.set_state(gen_state.cpu())
