"""Experiment logger (`onda_tpu/utils/logging_.py`).

The reference logs every step to wandb under fixed key names (reference
train_ouda.py:75-78, methods/prototypes.py:519). Here the same keys always go
to `metrics.jsonl` in the log directory, one JSON record per call with
`_step` and `_t` (seconds since the logger started); wandb is used only when
asked for, and then it must be importable.
"""

from __future__ import annotations

import json
import os
import time


class Logger:
    def __init__(self, project: str = "OUDA", config: dict | None = None, log_dir: str = ".",
                 use_wandb: bool = False):
        self.step = 0
        self._wandb = None
        if use_wandb:
            import wandb

            self._wandb = wandb
            wandb.init(project=project, config=config or {})
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a", buffering=1)
        self._t0 = time.time()

    def log(self, metrics: dict) -> None:
        scalars = {}
        for key, val in metrics.items():
            if hasattr(val, "to_wandb") and getattr(val, "path", None):
                scalars[key] = val.path  # MaskSample: the JSONL keeps the PNG's path
                continue
            try:
                scalars[key] = float(val)
            except (TypeError, ValueError):
                continue  # images etc. go to wandb only
        record = {"_step": self.step, "_t": round(time.time() - self._t0, 3), **scalars}
        self._jsonl.write(json.dumps(record) + "\n")
        if self._wandb is not None:
            # sample masks become wandb mask overlays under the reference's key
            # names (reference utils/logging.py:5-17); PNG paths upload as images
            payload = {
                key: (val.to_wandb(self._wandb) if hasattr(val, "to_wandb")
                      else self._wandb.Image(val)
                      if isinstance(val, str) and val.endswith(".png") and os.path.exists(val)
                      else val)
                for key, val in metrics.items()
            }
            self._wandb.log(payload, step=self.step)
        self.step += 1

    def close(self):
        self._jsonl.close()
