"""Segmentation-mask rendering (`onda_tpu/utils/viz.py`; reference
framework/utils/viz_segmask.py, utils/logging.py:5-17): colorize a class
mask with the Cityscapes palette and save input | prediction | label panels
as a PNG, written here with the standard library's zlib."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def png_file(h: int, w: int, color: int, idat_chunks) -> bytes:
    """A PNG of 8-bit (H, W) gray (`color` 0) or RGB (2) rows whose filtered,
    deflated stream is split over `idat_chunks`."""
    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + b"".join(chunk(b"IDAT", part) for part in idat_chunks) + chunk(b"IEND", b""))


def write_png(path: str, array: np.ndarray) -> str:
    """Write an (H, W) uint8 gray or (H, W, 3) uint8 RGB array as a PNG, every
    row with the Up filter (each byte minus the byte above it)."""
    array = np.ascontiguousarray(array)
    if array.dtype != np.uint8 or array.ndim not in (2, 3) or (array.ndim == 3 and array.shape[2] != 3):
        raise ValueError(f"write_png takes (H, W) or (H, W, 3) uint8, got {array.dtype} {array.shape}")
    h, w = array.shape[:2]
    rows = array.reshape(h, -1)
    filtered = np.empty((h, rows.shape[1] + 1), np.uint8)
    filtered[:, 0] = 2  # Up
    filtered[0, 1:] = rows[0]
    np.subtract(rows[1:], rows[:-1], out=filtered[1:, 1:])  # uint8 arithmetic wraps mod 256
    data = png_file(h, w, 2 if array.ndim == 3 else 0, [zlib.compress(filtered.tobytes())])
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    return path


def colorize_mask(mask: np.ndarray, palette: list) -> np.ndarray:
    """(H, W) int mask → (H, W, 3) uint8 RGB; 255-ignore maps to the last entry."""
    pal = np.asarray(palette, np.uint8)
    idx = np.where((mask >= 0) & (mask < len(pal) - 1), mask, len(pal) - 1)
    return pal[idx]


def denormalize_rgb(image_norm: np.ndarray, mean, std) -> np.ndarray:
    """Undo Normalize(mean/255, std/255) and the BGR flip of a (3, H, W)
    planar image → (H, W, 3) uint8 RGB."""
    mean = np.asarray(mean, np.float32)[:, None, None] / 255.0
    std = np.asarray(std, np.float32)[:, None, None] / 255.0
    rgb = (image_norm * std + mean)[::-1].transpose(1, 2, 0) * 255.0
    return np.rint(rgb).clip(0, 255).astype(np.uint8)


def save_sample(image_rgb: np.ndarray, pred: np.ndarray, label: np.ndarray | None,
                palette: list, out_path: str) -> str:
    """Side-by-side (input | prediction | label) PNG from an (H, W, 3) uint8 RGB
    input (see `denormalize_rgb`)."""
    panels = [image_rgb, colorize_mask(pred, palette)]
    if label is not None:
        panels.append(colorize_mask(label, palette))
    h = min(p.shape[0] for p in panels)
    return write_png(out_path, np.concatenate([p[:h] for p in panels], axis=1))


class MaskSample:
    """A sample image with its segmentation masks for the logger, under the key
    `Condition {set} sample {i}` (reference adaptation_model.py:181-200): the
    wandb sink renders it as mask overlays (reference utils/logging.py:5-17),
    the JSONL sink records the PNG saved at `path`. (The image is denormalized;
    the reference uploads the normalized tensor scaled by 255.)"""

    def __init__(self, image_rgb: np.ndarray, pred: np.ndarray, label: np.ndarray | None,
                 class_labels: dict, caption: str, path: str):
        self.image_rgb = image_rgb
        self.pred = pred
        self.label = label
        self.class_labels = {int(k): str(v) for k, v in class_labels.items()}
        self.caption = caption
        self.path = path

    def to_wandb(self, wandb):
        masks = {"predictions": {"mask_data": np.asarray(self.pred),
                                 "class_labels": self.class_labels}}
        if self.label is not None:
            masks["ground_truth"] = {"mask_data": np.asarray(self.label),
                                     "class_labels": self.class_labels}
        return wandb.Image(self.image_rgb, masks=masks, caption=self.caption)
