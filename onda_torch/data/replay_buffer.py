"""In-RAM source replay buffer (`onda_tpu/data/replay_buffer.py`).

The reference keeps the whole buffer as a deque of samples and mutates it
online with pseudo-labeled target frames (reference
framework/dataset/buffer_db.py:32-104). The same here, as host memory:

* an endless batch iterator that reshuffles every cycle;
* `sequential()`, one-sample batches in storage order (prototype bootstrap);
* "queue" (FIFO) and "random" eviction;
* `add_from_batch` for online insertions, copying the keys the buffer had
  when it was filled, so that its samples always collate. An inserted frame
  carries its pseudo-label at both resolutions (`label` and the 1/8-grid
  `label_res` / `stored_predictions`; the reference stores only the first, a
  documented deviation of the JAX package that the port keeps).
"""

from __future__ import annotations

from collections import deque

import numpy as np

from .loader import collate, load_batch


class ReplayBuffer:
    def __init__(self, dataset, batch_size: int, seed: int = 123, domain: str = "source"):
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.buffer: deque = deque()
        # filled a batch at a time through the dataset's batch prep
        for start in range(0, len(dataset), batch_size):
            rows = range(start, min(start + batch_size, len(dataset)))
            batch = load_batch(dataset, rows)
            for b in range(len(rows)):
                sample = {k: v[b] for k, v in batch.items()}
                sample["domain"] = domain
                # every sample carries stored_predictions from the start, so
                # that samples collate after target insertions (the 1/8-grid
                # label the loss trains on)
                if "stored_predictions" not in sample and "label_res" in sample:
                    sample["stored_predictions"] = np.asarray(sample["label_res"])
                self.buffer.append(sample)
        self.keys = tuple(self.buffer[0].keys()) if self.buffer else ()
        self.pos = 0
        self.permutation = self.rng.permutation(len(self.buffer))

    def __len__(self):
        return len(self.buffer)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        items = []
        for _ in range(self.batch_size):
            items.append(self.buffer[self.permutation[self.pos]])
            self.pos += 1
            if self.pos >= len(self.buffer):
                self.pos = 0
                self.permutation = self.rng.permutation(len(self.buffer))
        return collate(items)

    def sequential(self):
        """One-sample batches in storage order (prototype bootstrap)."""
        for sample in list(self.buffer):
            yield collate([sample])

    def add(self, item: dict, policy: str = "queue") -> None:
        if policy == "queue":
            self.buffer.popleft()
            self.buffer.append(item)
        elif policy == "random":
            self.buffer[int(self.rng.integers(len(self.buffer)))] = item
        else:
            raise NotImplementedError(f"eviction policy {policy!r}")

    def add_from_batch(self, batch: dict, index: int, domain: str = "target") -> None:
        sample = {}
        for key in self.keys:
            if key == "domain":
                continue
            entry = batch[key][index]
            sample[key] = np.asarray(entry) if not isinstance(entry, str) else entry
        sample["domain"] = domain
        self.add(sample)

    def nbytes(self) -> int:
        return sum(v.nbytes for s in self.buffer for v in s.values() if isinstance(v, np.ndarray))
