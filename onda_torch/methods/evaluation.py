"""EVALUATION mode: inference only, from the newest snapshot (`onda_tpu/methods/evaluation.py`).

The runner is a `ProtoOnlineAdapter` that, when it is made, loads the newest
checkpoint of SNAPSHOT_DIR it can load, falling back past unloadable ones
(reference adaptation_model.py:252-265). It then evaluates every validation
set, sweeps every checkpoint of the directory (OTHERS.EVAL_SWEEP), or, with
PREDICTION_SAVE, dumps the raw logits of every target batch while it logs
their mean confidence and the progress (reference :234-249,
train_ouda.py:159-182).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..utils.checkpoint import checkpoints_by_mtime
from .proto_online import ProtoOnlineAdapter, dump_logits_batch


class EvaluationRunner(ProtoOnlineAdapter):
    def __init__(self, model, variables, cfg, cfg_spec, num_classes: int, logger=None,
                 device="cuda"):
        super().__init__(model, variables, cfg, cfg_spec, num_classes, logger, device=device)
        dirpath = str(cfg.OTHERS.SNAPSHOT_DIR)
        if dirpath != "NONE" and os.path.isdir(dirpath):
            cand = self.load_newest(checkpoints_by_mtime(dirpath), "load")
            if cand is not None:
                print(f"Model {cand} is being loaded")

    def sweep_checkpoints(self, validation_loaders: dict, wait_seconds: float = 0.0) -> dict:
        """Evaluate every checkpoint of SNAPSHOT_DIR, oldest first, and report
        the best by the mean of the `Val mIoU model` keys (the reference's
        eval_single/eval_best, eval_UDA.py:77-198). With `wait_seconds > 0` it
        polls for new checkpoints every 5 s until none has come for that long
        (reference eval_UDA.py:148-151)."""
        seen: set[str] = set()
        best = {"checkpoint": None, "miou": float("-inf")}
        dirpath = str(self.cfg.OTHERS.SNAPSHOT_DIR)
        deadline = time.monotonic() + wait_seconds
        while True:
            candidates = ([p for p in checkpoints_by_mtime(dirpath) if str(p) not in seen]
                          if os.path.isdir(dirpath) else [])
            for ckpt in candidates:
                seen.add(str(ckpt))
                try:
                    self.load_model(str(ckpt))
                except Exception as exc:  # noqa: BLE001 - a file a writer has not finished
                    print(f"sweep skip: {ckpt.name} (unloadable: {type(exc).__name__}: {exc})")
                    continue
                result = self.evaluate_all(validation_loaders)
                mious = [v for k, v in result.items() if k.startswith("Val mIoU model")]
                miou = float(np.mean(mious)) if mious else float("nan")
                self._log({**result, "Swept checkpoint": ckpt.name, "Swept mIoU": miou})
                print(f"sweep: {ckpt.name} mIoU {miou:.4f}")
                if miou == miou and miou > best["miou"]:
                    best = {"checkpoint": ckpt.name, "miou": miou}
                deadline = time.monotonic() + wait_seconds
            if wait_seconds and (candidates or time.monotonic() < deadline):
                time.sleep(min(5.0, wait_seconds))
                continue
            break
        if best["checkpoint"] is not None:
            self._log({"Best checkpoint": best["checkpoint"], "Best mIoU": best["miou"]})
            print(f"best: {best['checkpoint']} mIoU {best['miou']:.4f}")
        return best

    @torch.no_grad()
    def run_predictions(self, trg_loader) -> None:
        """Dump the raw logits of every batch of `trg_loader` as NCHW
        `batch-{i}.pt` under PREDICTION_SAVE/<set> and log each batch's mean
        max-probability. A padded final batch is dumped whole, padding
        included, as the JAX package does."""
        base = os.path.join(str(self.cfg_spec.PREDICTION_SAVE), "_".join(str(self.cfg_spec.set_)))
        os.makedirs(base, exist_ok=True)
        n = len(trg_loader) if hasattr(trg_loader, "__len__") else 0
        for i, batch in enumerate(trg_loader):
            main = self._forward(self.state.params, self.state.batch_stats,
                                 self._to_device(batch["image"], torch.float32), train=False)
            out = main["out"] if isinstance(main, dict) else main
            conf = torch.softmax(out.float(), dim=1).max(dim=1).values.mean()
            dump_logits_batch(base, i, out)
            self._log({"Prediction confidence": float(conf),
                       "Progress": (i * 100.0 / n) if n else float(i)})
