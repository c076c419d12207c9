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

RGB-coded label maps (a class map keyed by (r, g, b)) go through a 2²⁴-entry
LUT of r·65536 + g·256 + b, as the JAX package's PIL path reads them: the
PNG decoded to RGB by the C++ prep, resized with PIL's nearest rule
(`pil_nearest`, which picks other source pixels than the id path's rule at
non-integral scales) and remapped, in numpy on the calling thread while the
executor prepares the images. With `predictions_dir` each row also carries
`soft_path` (`<predictions_dir>/<image_path>` with `.png` → `_soft.npy`) and,
where those files exist, their arrays as `soft_predictions`.

Batches come out as planar CHW float32 images, (N, 3, H, W), the layout the
model takes, and int32 label maps. Every image batch is made by the
executor; a file that cannot be read stops the batch with an error naming
the file.
"""

from __future__ import annotations

import os

import numpy as np

from .. import native


class LabelMapper:
    """The LUT of a class remap of label ids or RGB codes (reference
    func.py:88-115); the C++ prep applies an id LUT itself."""

    def __init__(self, mapping: dict):
        self.rgb = isinstance(next(iter(mapping.keys())), (tuple, list))
        if self.rgb:
            self.lut = np.zeros(256 * 256 * 256, np.int32)
            for (r, g, b), idx in mapping.items():
                self.lut[r * 65536 + g * 256 + b] = idx
            return
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

    def __call__(self, label: np.ndarray) -> np.ndarray:
        """The class map of label ids (H, W) or RGB codes (H, W, 3)."""
        label = np.asarray(label, np.int32)
        if self.rgb:
            label = label @ np.array([65536, 256, 1], np.int32)
        return self.lut[label]


def _pil_nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """PIL's NEAREST source index along one axis: its affine map's position
    starts at half a step and adds the step, in doubles, truncated."""
    step, pos, out = n_in / n_out, 0.0, np.empty(n_out, np.intp)
    pos += step * 0.5
    for i in range(n_out):
        out[i] = min(int(pos), n_in - 1)
        pos += step
    return out


def pil_nearest(image: np.ndarray, out_hw) -> np.ndarray:
    """An (H, W, ...) array resized to out_hw = (h, w) as PIL's
    `resize(..., NEAREST)` resizes it (`Image.resize` keeps an equal size)."""
    h, w = out_hw
    if image.shape[:2] == (h, w):
        return image
    return image[_pil_nearest_index(image.shape[0], h)][:, _pil_nearest_index(image.shape[1], w)]


class SegmentationDataset:
    """Map-style dataset over a metadata `Table` (reference Segmentation_db).

    `executor` is the `native.BatchExecutor` that prepares the batches; one
    with a worker per core but one is made when none is given."""

    def __init__(self, root: str, metadata, class_map, image_size_wh, mean, std,
                 labels_size_wh=None, original_label: bool = False, executor=None,
                 predictions_dir: str | None = None):
        self.metadata = metadata
        self.root = root
        self.image_size = list(image_size_wh)
        self.labels_size = list(labels_size_wh or image_size_wh)
        self.map = class_map if isinstance(class_map, LabelMapper) else LabelMapper(class_map)
        self.original_label = original_label
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.predictions_dir = predictions_dir
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
        must share; with `predictions_dir` also soft_path, and soft_predictions
        where every row's file exists (some but not all raise, as the JAX
        loader's collate does). `alloc(shape, dtype)` gives the arrays the
        executor writes into (pinned host memory on the way to a card)."""
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
        errors = []
        if all(labeled):
            label_paths = [os.path.join(self.root, r["label_path"]) for r in rows]
            (lw, lh), (rw, rh) = self.labels_size, self.res_size
            full, res = alloc((n, lh, lw), np.int32), alloc((n, rh, rw), np.int32)
            batch.update(label_path=label_paths, label=full, label_res=res)
            try:
                if self.map.rgb:
                    self._rgb_labels(label_paths, full, res)
                else:
                    jobs.append((self.executor.submit_labels(
                        label_paths, (lh, lw), (rh, rw), self.map.lut, full, res), label_paths))
                if self.original_label:
                    batch["label_raw"] = self._raw_labels(label_paths, alloc)
            except (RuntimeError, ValueError) as exc:
                errors.append(exc)
        if self.predictions_dir:
            try:
                batch.update(self._soft_predictions(rows))
            except ValueError as exc:
                errors.append(exc)
        for job, paths in jobs:  # wait for every job before the buffers can go
            try:
                self.executor.wait(job, paths)
            except RuntimeError as exc:
                errors.append(exc)
        if errors:
            raise errors[0]
        batch["image"] = images
        return batch

    def _rgb_labels(self, paths, full, res) -> None:
        """RGB-coded label maps into full and res: decoded by the C++ prep,
        resized by PIL's nearest rule, remapped (the JAX package's PIL
        path, segmentation.py:198-209)."""
        for i, path in enumerate(paths):
            rgb = native.decode_png(path, rgb=True)
            full[i] = self.map(pil_nearest(rgb, full.shape[1:]))
            res[i] = self.map(pil_nearest(rgb, res.shape[1:]))

    def _soft_predictions(self, rows) -> dict:
        """soft_path of every row and, where every row's file exists, the
        stacked soft_predictions (JAX's segmentation.py:211-216)."""
        paths = [os.path.join(self.predictions_dir, r["image_path"].replace(".png", "_soft.npy"))
                 for r in rows]
        found = [os.path.exists(p) for p in paths]
        out = {"soft_path": paths}
        if any(found) and not all(found):
            raise ValueError(f"inconsistent batch: soft predictions exist for some rows only: "
                             f"{[p for p, f in zip(paths, found) if not f]} are missing")
        if all(found):
            out["soft_predictions"] = np.stack([np.load(p) for p in paths])
        return out

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
            if self.map.rgb:
                out[i] = self.map(native.decode_png(path, rgb=True))
                continue
            ids = native.decode_png(path, rgb=False)
            if ids.max(initial=0) >= len(lut):
                raise RuntimeError(f"{path}: {native.ERRORS[-4]}")
            out[i] = lut[ids]
        return out

    def __getitem__(self, index: int) -> dict:
        """One sample: the batch of one row, without the batch axis."""
        batch = self.prepare_batch([index])
        return {k: v[0] for k, v in batch.items()}
