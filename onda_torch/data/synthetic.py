"""A learnable synthetic weather task for the quality run: the port's own copy
of the repository's `tests/synthetic.py::make_shift_dataset`.

Each frame is a blocky map of four classes (16×16 blocks; label ids 7, 8,
11, 12, which the Cityscapes table maps to road, sidewalk, building, wall),
each class drawn in its own colour plus N(0, 5) noise; `shift` rotates the
colours toward a target domain, the synthetic analog of rain intensity, and
names it `clear` (0) or `rain/<int(shift*100)>mm`. The files follow the
weather-Cityscapes layout:

    leftImg8bit/{train,val}/<domain>/city/shift_<mm>_<set>_<i>_leftImg8bit.png
    gtFine/{train,val}/city/shift_<mm>_<set>_<i>_gtFine_labelIds.png

The PNGs are encoded as Pillow's encoder writes them (`pil_png`), so a seed
gives the same bytes as the tests' helper that writes with Pillow.
"""

from __future__ import annotations

import os
import zlib

import numpy as np

from ..utils.viz import png_file
from .metadata import Table

# labelIds whose label2train mapping is 0,1,2,3 (road, sidewalk, building, wall)
_CLASS_IDS = (7, 8, 11, 12)
_BASE_COLORS = np.array(
    [[200, 60, 60], [60, 200, 60], [60, 60, 200], [200, 200, 60]], np.float32
)
COLUMNS = ("image_path", "label_path", "set", "intensity")


def pil_png(array: np.ndarray) -> bytes:
    """The bytes Pillow's PNG encoder writes for an (H, W) uint8 gray or
    (H, W, 3) uint8 RGB array: per row the filter of None, Up, Sub and Paeth
    (tried in that order, the first of the least cost kept; Average only
    under Pillow's `optimize`) whose bytes, read as signed, sum to the least
    magnitude; deflated at zlib's default level with the Z_FILTERED strategy
    and memory level 9; the stream in IDAT chunks of max(64 KiB, 4·W)
    bytes."""
    h, w = array.shape[:2]
    bpp = 3 if array.ndim == 3 else 1
    rows = np.ascontiguousarray(array, np.uint8).reshape(h, -1).astype(np.int16)
    up = np.zeros_like(rows)
    up[1:] = rows[:-1]
    left = np.zeros_like(rows)
    left[:, bpp:] = rows[:, :-bpp]
    up_left = np.zeros_like(rows)
    up_left[:, bpp:] = up[:, :-bpp]
    pa, pb = np.abs(up - up_left), np.abs(left - up_left)
    pc = np.abs(left + up - 2 * up_left)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
    candidates = np.stack([rows, rows - up, rows - left, rows - paeth]) & 0xFF
    cost = np.where(candidates < 128, candidates, 256 - candidates).sum(axis=-1)
    best = cost.argmin(axis=0)  # the first of equal costs, as Pillow keeps it
    filtered = np.empty((h, rows.shape[1] + 1), np.uint8)
    filtered[:, 0] = np.array([0, 2, 1, 4], np.uint8)[best]  # None, Up, Sub, Paeth
    filtered[:, 1:] = candidates[best, np.arange(h)]
    deflate = zlib.compressobj(zlib.Z_DEFAULT_COMPRESSION, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    stream = deflate.compress(filtered.tobytes()) + deflate.flush()
    size = max(65536, 4 * w)
    return png_file(h, w, 2 if bpp == 3 else 0,
                    [stream[i:i + size] for i in range(0, len(stream), size)])


def _write(path: str, array: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(pil_png(array))


def make_shift_dataset(root, n_train=16, n_val=8, size_wh=(64, 32), shift=0.0, seed=0) -> Table:
    """Structured learnable task: class = f(color); `shift` rotates the colors
    toward a target domain. Writes n_train train and n_val val frames of
    size_wh = (W, H) under `root` and returns their metadata rows."""
    rng = np.random.default_rng(seed)
    w, h = size_wh
    rows = []
    intensity = int(shift * 100)
    domain = "clear" if intensity == 0 else f"rain/{intensity}mm"
    for set_, count in (("train", n_train), ("val", n_val)):
        for i in range(count):
            # blocky label map over the 4 classes
            lbl_small = rng.integers(0, 4, size=(max(h // 16, 1), max(w // 16, 1)))
            lbl = np.kron(lbl_small, np.ones((16, 16), dtype=np.int64))[:h, :w]
            colors = _BASE_COLORS.copy()
            if shift:
                colors = colors[:, [1, 2, 0]] * shift + colors * (1 - shift)  # hue-ish mix
                colors = np.clip(colors + 40 * shift, 0, 255)
            img = colors[lbl] + rng.normal(0, 5, size=(h, w, 3))
            img = np.clip(img, 0, 255).astype(np.uint8)
            lbl_ids = np.asarray(_CLASS_IDS, np.uint8)[lbl]
            frame = f"shift_{intensity}_{set_}_{i:03d}"
            img_rel = f"leftImg8bit/{set_}/{domain}/city/{frame}_leftImg8bit.png"
            lbl_rel = f"gtFine/{set_}/city/{frame}_gtFine_labelIds.png"
            _write(os.path.join(root, img_rel), img)
            _write(os.path.join(root, lbl_rel), lbl_ids)
            rows.append({"image_path": img_rel, "label_path": lbl_rel, "set": set_,
                         "intensity": intensity})
    return Table(rows, COLUMNS)
