"""EVALUATION mode: inference only, from the newest snapshot (`onda_tpu/methods/evaluation.py`).

The runner is a `ProtoOnlineAdapter` that, when it is made, loads the newest
checkpoint of SNAPSHOT_DIR it can load, falling back past unloadable ones
(reference adaptation_model.py:252-265). It then evaluates every validation
set, sweeps every checkpoint of the directory (OTHERS.EVAL_SWEEP), or, with
PREDICTION_SAVE, dumps the raw logits of every target batch while it logs
their mean confidence and the progress (reference :234-249,
train_ouda.py:159-182).

Under OTHERS.DATA_PARALLEL across ranks every rank evaluates its shard of
each set and the confusion matrices are summed (`evaluate`), so every
`Val mIoU*` is one process's. Which checkpoints there are is rank 0's view:
the newest snapshot, the sweep's list and its "keep polling" are rank 0's
decisions, taken on every rank, and a checkpoint that any rank fails to load
is skipped on every rank (`parallel.distributed.from_primary`, `any_true`),
so that a file another run is still writing cannot set the ranks' collectives
apart. A prediction batch is the global batch, each rank's rows in rank
order (the order of a multi-process JAX run), written by rank 0, and its
confidence the global mean. Only rank 0 writes.

Under OTHERS.TENSOR_PARALLEL the runner holds the prototype adapter's channel
shards on a (data × model) grid: every file it loads (`adapt_state.pt`, a
`model_train_*.pth`, the student of `advent_state.pt`) holds whole tensors
and each rank keeps its shards of them (`load_model`). The evaluation splits
the sets over the data axis; the logits it dumps (one channel a class) are
whole on every model rank.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import numpy as np
import torch

from ..parallel import distributed as dist
from ..utils.checkpoint import checkpoints_by_mtime
from .proto_online import ProtoOnlineAdapter, dump_logits_batch


class EvaluationRunner(ProtoOnlineAdapter):
    def __init__(self, model, variables, cfg, cfg_spec, num_classes: int, logger=None,
                 device="cuda"):
        super().__init__(model, variables, cfg, cfg_spec, num_classes, logger, device=device)
        dirpath = str(cfg.OTHERS.SNAPSHOT_DIR)
        listed = (checkpoints_by_mtime(dirpath)
                  if dirpath != "NONE" and os.path.isdir(dirpath) else [])
        cand = self.load_newest(listed, "load")  # rank 0's list, on every rank
        if cand is not None:
            print(f"Model {cand} is being loaded")

    def sweep_checkpoints(self, validation_loaders: dict, wait_seconds: float = 0.0) -> dict:
        """Evaluate every checkpoint of SNAPSHOT_DIR, oldest first, and report
        the best by the mean of the `Val mIoU model` keys (the reference's
        eval_single/eval_best, eval_UDA.py:77-198). With `wait_seconds > 0` it
        polls for new checkpoints every 5 s until none has come for that long
        (reference eval_UDA.py:148-151). Under data parallelism the list and
        the decision to poll again are rank 0's."""
        seen: set[str] = set()
        best = {"checkpoint": None, "miou": float("-inf")}
        dirpath = str(self.cfg.OTHERS.SNAPSHOT_DIR)
        deadline = time.monotonic() + wait_seconds
        while True:
            candidates = ([str(p) for p in checkpoints_by_mtime(dirpath) if str(p) not in seen]
                          if os.path.isdir(dirpath) else [])
            for ckpt in map(Path, dist.from_primary(candidates)):
                seen.add(str(ckpt))
                if not self.load_agreed(ckpt, "sweep"):  # a file a writer has not finished
                    continue
                result = self.evaluate_all(validation_loaders)
                mious = [v for k, v in result.items() if k.startswith("Val mIoU model")]
                miou = float(np.mean(mious)) if mious else float("nan")
                self._log({**result, "Swept checkpoint": ckpt.name, "Swept mIoU": miou})
                print(f"sweep: {ckpt.name} mIoU {miou:.4f}")
                if miou == miou and miou > best["miou"]:
                    best = {"checkpoint": ckpt.name, "miou": miou}
                deadline = time.monotonic() + wait_seconds
            if dist.from_primary(bool(wait_seconds and (candidates or
                                                        time.monotonic() < deadline))):
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
        included, as the JAX package does. Under data parallelism a batch is
        the global batch (`gather_rows`), written by rank 0, and its
        confidence the global mean."""
        base = os.path.join(str(self.cfg_spec.PREDICTION_SAVE), "_".join(str(self.cfg_spec.set_)))
        if dist.is_primary():
            os.makedirs(base, exist_ok=True)
        n = len(trg_loader) if hasattr(trg_loader, "__len__") else 0
        for i, batch in enumerate(trg_loader):
            main = self._forward(self.state.params, self.state.batch_stats,
                                 self._to_device(batch["image"], torch.float32), train=False)
            out = main["out"] if isinstance(main, dict) else main
            conf = dist.all_mean(torch.softmax(out.float(), dim=1).max(dim=1).values.mean())[0]
            out = dist.gather_rows(out)
            if dist.is_primary():
                dump_logits_batch(base, i, out)
            self._log({"Prediction confidence": float(conf),
                       "Progress": (i * 100.0 / n) if n else float(i)})
