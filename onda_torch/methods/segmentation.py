"""Supervised source pretraining, SEGMENT mode (`onda_tpu/methods/segmentation.py`).

Per batch (reference framework/domain_adaptation/methods/segmentation.py:18-151):
one train-mode forward that updates the BatchNorm running statistics (K2
gives every BatchNorm its batch statistics) → the logits upsampled bilinearly
with align_corners to the input size → CE of the main head plus 0.1 × CE of
the aux head under multi_level → SGD with the poly LR, the head at 10 × the
backbone's rate and the BatchNorm affine frozen. Per epoch: mIoU and mean
entropy of every validation set (and the full-image mIoU through `label_raw`
under SCHEME.ORIGINAL_RES), then the student as `model_train_{SOURCE}.pth`.

The step's loss stays on the device; the host reads the window of losses once
per log, every 10 steps.

Under OTHERS.DATA_PARALLEL across ranks (each rank trains on its shard of the
source at the local batch size) the step is the global batch's, as on the
JAX package's `data` mesh: global BatchNorm statistics, both CEs divided by
the global valid count, the gradients summed in one bucket, so every rank
ends the step with the same bits. The logged loss is the global window mean
(one all-reduce per log); the evaluation sums the ranks' confusion matrices
and takes the entropy as the mean over the ranks of their batch means, which
is the global batch's where the shards are whole (a padded final batch
counts each rank's padding rows, as a multi-process JAX run's does). Only
rank 0 writes `model_train_{SOURCE}.pth`.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch.func import functional_call

from ..config import unset, value_or
from ..data.loader import DeviceFeeder, to_device
from ..ops import losses as L
from ..ops import metrics as M
from ..ops.interp import upsample_bilinear_ac
from ..parallel import distributed as dist
from ..utils import checkpoint as ckpt
from . import optim
from .timing import SpeedMeter

HEAD_LR_SCALE = 10.0  # hard-coded in the reference (segmentation.py:59-87), not LR_RATIO
AUX_WEIGHT = 0.1


def _logits(out):
    return out["out"] if isinstance(out, dict) else out


class SegmentTrainer:
    def __init__(self, model, variables, cfg, cfg_spec, num_classes: int, logger=None,
                 device="cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.spec = cfg_spec
        self.num_classes = num_classes
        self.logger = logger
        self.params = {k: v.detach().to(self.device) for k, v in variables["params"].items()}
        self.batch_stats = {k: v.detach().to(self.device)
                            for k, v in variables.get("batch_stats", {}).items()}
        self.momentum_buf = optim.init(self.params)
        self.param_labels = optim.label_params(self.params, aux_grad=bool(model.multi_level))
        self.trainable = [k for k, lab in self.param_labels.items() if lab != optim.FROZEN]
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(cfg.TRAINING.RANDOM_SEED))

    @property
    def resolution_hw(self):
        w, h = self.cfg.SCHEME.RESOLUTION
        return int(h), int(w)

    def step(self, images, labels, lr: float) -> torch.Tensor:
        """One training step in place; returns the loss (this rank's share of
        the global batch's under data parallelism), on the device."""
        live = dict(self.params)
        for k in self.trainable:
            live[k] = self.params[k].detach().requires_grad_(True)
        aux, main = functional_call(self.model, (live, self.batch_stats), (images,),
                                    {"train": True, "update_stats": True,
                                     "generator": self.generator})
        hw = self.resolution_hw
        # under data parallelism both CEs divide by the global valid count,
        # so the ranks' losses sum to the global batch's
        count = dist.all_sum(L.valid_count(labels))[0] if dist.world() > 1 else None
        loss = L.cross_entropy_2d(upsample_bilinear_ac(_logits(main).float(), hw), labels,
                                  count=count)
        if aux is not None:
            loss = loss + AUX_WEIGHT * L.cross_entropy_2d(
                upsample_bilinear_ac(_logits(aux).float(), hw), labels, count=count)
        grads = optim.grads(loss, live, self.trainable)
        del live
        optim.update(self.params, grads, self.momentum_buf, self.param_labels, lr,
                     lr * HEAD_LR_SCALE, float(self.spec.MOMENTUM), float(self.spec.WEIGHT_DECAY))
        return loss.detach()

    @torch.no_grad()
    def evaluate(self, loader, original_res: bool = False):
        """(per-class IoU, mean entropy) at the input size; with `original_res`
        and batches that carry `label_raw`, also the per-class IoU at
        SCHEME.ORIGINAL_RES (reference eval_UDA.evaluate_model, eval_UDA.py:21-74).
        The entropy is the mean over batches of each batch's mean, padded rows
        included."""
        C = self.num_classes
        org_hw = None
        if original_res and not unset(self.cfg.SCHEME.ORIGINAL_RES):
            w, h = self.cfg.SCHEME.ORIGINAL_RES
            org_hw = (int(h), int(w))
        hist = torch.zeros((C, C), dtype=torch.long, device=self.device)
        hist_org = torch.zeros_like(hist)
        ent = torch.zeros((), device=self.device)
        n, saw_raw = 0, False
        for batch in loader:
            valid = batch.get("valid", len(batch["label"]))
            images = to_device(batch["image"], self.device).float()
            _, main = functional_call(self.model, (self.params, self.batch_stats), (images,),
                                      {"train": False, "with_aux": False})
            out = _logits(main).float()
            probs = torch.softmax(upsample_bilinear_ac(out, self.resolution_hw), dim=1)
            hist += M.fast_hist(self._labels(batch["label"], valid), probs.argmax(dim=1), C)
            ent += M.mean_entropy(probs)
            if org_hw is not None and "label_raw" in batch:
                saw_raw = True
                pred = torch.softmax(upsample_bilinear_ac(out, org_hw), dim=1).argmax(dim=1)
                hist_org += M.fast_hist(self._labels(batch["label_raw"], valid), pred, C)
            n += 1
        # every rank evaluated its shard: sum the counts, average the entropy
        hist, hist_org = dist.all_sum(hist, hist_org)
        iou, mean_ent = M.per_class_iu(hist), float(dist.all_mean(ent)[0]) / max(n, 1)
        if org_hw is not None and saw_raw:
            # reported only when the batches carried label_raw: an empty
            # histogram would log a meaningless 0.0
            return iou, mean_ent, M.per_class_iu(hist_org)
        return iou, mean_ent

    def _labels(self, labels, valid: int):
        labels = to_device(labels, self.device).long()
        if valid < len(labels):  # padded final batch: the padding is ignored
            labels = labels.clone()
            labels[valid:] = 255
        return labels

    def train(self, train_loaders: dict, validation_loaders: dict) -> None:
        loader = next(iter(train_loaders.values()))
        epochs = int(self.spec.EPOCHS)
        base_lr = float(self.spec.LEARNING_RATE)
        power = float(self.spec.POWER)
        total = max(len(loader) * epochs, 1)
        # OTHERS.SCHEDULE: host stage timing. Batch Fetch: waiting for the fed
        # batch; Fused Step: queueing the step (the device runs behind it)
        meter = SpeedMeter(enabled=bool(value_or(self.cfg.OTHERS.SCHEDULE, False)))
        step_i = 0
        window = []  # the losses since the last log (reference `avrg`)
        for epoch in range(epochs):
            for batch in DeviceFeeder(loader, self.device, keys=("image", "label")):
                meter.mark("Batch Fetch")
                # the reference adjusts the poly LR after optimizer.step()
                # (segmentation.py:83-88): step i trains at lr(i-1), step 0 at
                # the base rate, while the logged rate is lr(i)
                lr = optim.lr_poly(base_lr, max(step_i - 1, 0), total, power)
                window.append(self.step(batch["image"].float(), batch["label"].long(), lr))
                meter.mark("Fused Step (fwd+loss+bwd+update)")
                if step_i % 10 == 0:
                    # the ranks' shares summed: the global batch's mean loss
                    loss = dist.all_sum(torch.stack(window).mean())[0]
                    self._log({"Segmentation loss": float(loss),
                               "learning_rate": optim.lr_poly(base_lr, step_i, total, power),
                               **meter.averages()})
                    window = []
                step_i += 1
            log = {"epoch": epoch}
            original = not unset(self.cfg.SCHEME.ORIGINAL_RES)
            for set_, val_loader in validation_loaders.items():
                result = self.evaluate(val_loader, original_res=original)
                iu, ent = result[0], result[1]
                log[f"Val mIoU of {set_}"] = float(np.nanmean(iu))
                log[f"Val std IoU of {set_}"] = float(np.nanstd(iu))
                log[f"val entropy of {set_}"] = ent
                if len(result) == 3:
                    log[f"Val mIoU full image of {set_}"] = float(np.nanmean(result[2]))
            self._log(log)
            self.save_model()

    def _student(self) -> dict:
        """The student in the reference's state_dict key layout, where it lives."""
        tensors = {**self.params, **self.batch_stats}
        return {k: tensors[k].detach() for k in self.model.state_dict()}

    def state_dict(self) -> dict:
        """The student in the reference's state_dict key layout, on the host."""
        return {k: v.cpu() for k, v in self._student().items()}

    def save_model(self) -> None:
        """`model_train_{SOURCE}.pth` in SNAPSHOT_DIR (reference
        segmentation.py:141-151); under OTHERS.ASYNC_SAVE the save copies the
        student to pinned host memory and writes it in the background."""
        path = os.path.join(str(self.cfg.OTHERS.SNAPSHOT_DIR),
                            f"model_train_{self.cfg.SCHEME.SOURCE}.pth")
        wait = not value_or(self.cfg.OTHERS.ASYNC_SAVE, False)
        ckpt.save_atomic(self.state_dict() if wait else self._student(), path, wait=wait)

    def _log(self, metrics):
        if self.logger is not None:
            self.logger.log(metrics)
