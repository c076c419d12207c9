"""Segmentation dataset (`onda_tpu/data/segmentation.py`): PNG decode → resize
→ remap → normalize, on the C++ batch executor (`onda_torch/native`).

Pixel semantics are the reference's Segmentation_db (reference
framework/dataset/segmentation_db.py:16-99), byte-exact with PIL:

* image: **bicubic** resize to (W, H), RGB→BGR flip, then x/255 and
  Normalize(mean/255, std/255) with the mean and std in the order given (the
  reference normalizes the BGR image with RGB-ordered ImageNet statistics,
  and its checkpoints bake that in);
* label: nearest resize to the input size, LUT-remapped 34 → 19 + 255;
* label_res: nearest resize to the model's 1/8+1 output grid;
* label_raw (with `original_label`): the label map at the file's own size
  through the LUT, for SEGMENT training's full-image evaluation.

Batches come out as planar CHW float32 images, (N, 3, H, W), the layout the
model takes, and int32 label maps. Every batch is made by the executor; a
file it cannot read stops the batch with an error naming the file.
"""

from __future__ import annotations

import os

import numpy as np

from .. import native


class LabelMapper:
    """The LUT of a label-id class remap (reference func.py:88-115), which the
    C++ prep applies. RGB-coded label maps are not read by the port."""

    def __init__(self, mapping: dict):
        if isinstance(next(iter(mapping.keys())), (tuple, list)):
            raise NotImplementedError("RGB-coded label maps: the port's prep remaps 8-bit label ids")
        # a len(mapping)-entry table where negative keys (the -1 → 255 ignore
        # row) land at the end by numpy wraparound (reference func.py:107-109),
        # grown so that a negative slot never collides with a positive key
        keys = [int(k) for k in mapping.keys()]
        pos_max = max((k for k in keys if k >= 0), default=-1)
        neg_min = min((k for k in keys if k < 0), default=0)
        size = max(len(mapping), pos_max + 1 - neg_min)
        self.lut = np.zeros(size, np.int32)
        for src, dst in mapping.items():
            self.lut[int(src)] = dst


class SegmentationDataset:
    """Map-style dataset over a metadata `Table` (reference Segmentation_db).

    `executor` is the `native.BatchExecutor` that prepares the batches; one
    with a worker per core but one is made when none is given."""

    def __init__(self, root: str, metadata, class_map, image_size_wh, mean, std,
                 labels_size_wh=None, original_label: bool = False, executor=None):
        self.metadata = metadata
        self.root = root
        self.image_size = list(image_size_wh)
        self.labels_size = list(labels_size_wh or image_size_wh)
        self.map = class_map if isinstance(class_map, LabelMapper) else LabelMapper(class_map)
        self.original_label = original_label
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.executor = executor or native.BatchExecutor(max(1, (os.cpu_count() or 2) - 1))

    def __len__(self):
        return len(self.metadata)

    @property
    def res_size(self):
        """The 1/8+1 output grid, (W, H) (reference segmentation_db.py:89-94)."""
        return [int(x / 8 + 1) for x in self.labels_size]

    def prepare_batch(self, indices, alloc=np.empty) -> dict:
        """The collated batch of rows `indices`: image (N, 3, H, W) f32 and,
        when the rows have labels, label (N, H, W) and label_res (N, h8, w8)
        int32, plus the file paths; with `original_label` also label_raw
        (N, H0, W0) int32 at the files' own size, which all rows of a batch
        must share. `alloc(shape, dtype)` gives the arrays the executor
        writes into (pinned host memory on the way to a card)."""
        rows = [self.metadata[int(i)] for i in indices]
        image_paths = [os.path.join(self.root, r["image_path"]) for r in rows]
        labeled = [isinstance(r.get("label_path"), str) for r in rows]
        if any(labeled) and not all(labeled):
            raise ValueError("a batch mixes labeled and label-less rows: "
                             f"{[p for p, lab in zip(image_paths, labeled) if not lab]}")
        n, (w, h) = len(rows), self.image_size
        batch = {"image_path": image_paths}
        images = alloc((n, 3, h, w), np.float32)
        jobs = [(self.executor.submit_images(image_paths, (h, w), self.mean, self.std, images),
                 image_paths)]
        if all(labeled):
            label_paths = [os.path.join(self.root, r["label_path"]) for r in rows]
            (lw, lh), (rw, rh) = self.labels_size, self.res_size
            full, res = alloc((n, lh, lw), np.int32), alloc((n, rh, rw), np.int32)
            jobs.append((self.executor.submit_labels(label_paths, (lh, lw), (rh, rw), self.map.lut,
                                                     full, res), label_paths))
            batch.update(label_path=label_paths, label=full, label_res=res)
            if self.original_label:
                batch["label_raw"] = self._raw_labels(label_paths, alloc)
        errors = []
        for job, paths in jobs:  # wait for every job before the buffers can go
            try:
                self.executor.wait(job, paths)
            except RuntimeError as exc:
                errors.append(exc)
        if errors:
            raise errors[0]
        batch["image"] = images
        return batch

    def _raw_labels(self, paths, alloc) -> np.ndarray:
        """The label maps at their own size, decoded by the C++ prep and
        remapped through the LUT (reference segmentation_db.py:80-87)."""
        sizes = [native.png_size(p) for p in paths]
        if len(set(sizes)) > 1:
            raise ValueError(f"label_raw: the label maps of a batch differ in size: "
                             f"{dict(zip(paths, sizes))}")
        out = alloc((len(paths), *sizes[0]), np.int32)
        lut = self.map.lut
        for i, path in enumerate(paths):
            ids = native.decode_png(path, rgb=False)
            if ids.max(initial=0) >= len(lut):
                raise RuntimeError(f"{path}: {native.ERRORS[-4]}")
            out[i] = lut[ids]
        return out

    def __getitem__(self, index: int) -> dict:
        """One sample: the batch of one row, without the batch axis."""
        batch = self.prepare_batch([index])
        return {k: v[0] for k, v in batch.items()}
