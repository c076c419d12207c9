"""The benchmark's inputs: seeded frames and label maps, their PNG files, and
the reading of those files as the reference reads them.

Frozen copies, kept here so that the yardstick does not move with the
program:

* `frame_batch` is `chip_smoke.py::frame_image`'s pattern (a smooth
  seeded RGB field with mild noise, which compresses about as a photograph
  does), drawn on the device from a `torch.Generator` for many frames at
  once;
* `label_batch` is `chip_smoke.py::frame_label`'s blocks of class ids;
* `write_png` / `read_png` write and read 8-bit RGB or gray PNGs whose rows
  all carry the filter byte 0, so that a reader needs no unfiltering;
* `resize_bicubic` is Pillow's two-pass bicubic resample (a = -0.5, support
  widened by the scale, 22-bit fixed-point coefficients, u8 rounding after
  each pass), the rule the port's C++ prep (`native/dataprep.cpp`) follows;
* `normalize` is the reference dataset's preprocessing: RGB → BGR, x/255,
  then (x − mean/255)·(255/std) in float32.
"""

from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np
import torch

MEAN = (123.675, 116.28, 103.53)   # configs' SCHEME.MEAN
STD = (58.395, 57.12, 57.375)      # configs' SCHEME.STD
NUM_CLASSES = 19
IGNORE = 255


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator for one named use (`stream`) of a run's seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2**63 - 1))
    return g


def frame_batch(g: torch.Generator, n: int, hw, device) -> torch.Tensor:
    """n seeded RGB frames (n, H, W, 3) uint8 on `device`."""
    h, w = hw
    y = torch.linspace(0.0, 1.0, h, device=device)[:, None]
    x = torch.linspace(0.0, 1.0, w, device=device)[None, :]
    freq = 1.0 + 7.0 * torch.rand(n, 3, 2, generator=g, device=device)
    phase = 2 * math.pi * torch.rand(n, 3, 2, generator=g, device=device)
    out = torch.empty(n, h, w, 3, dtype=torch.uint8, device=device)
    for i in range(n):
        img = torch.empty(3, h, w, device=device)
        for c in range(3):
            (fx, fy), (px, py) = freq[i, c], phase[i, c]
            img[c] = (120 + 60 * torch.sin(2 * math.pi * fx * x + px)
                      * torch.cos(2 * math.pi * fy * y + py) + 40 * (x - y))
        img += 2.5 * torch.randn(3, h, w, generator=g, device=device)
        out[i] = img.clamp(0, 255).to(torch.uint8).permute(1, 2, 0)
    return out


def label_batch(g: torch.Generator, n: int, hw, device, classes: int = NUM_CLASSES,
                ignore: bool = True) -> torch.Tensor:
    """n maps (n, H, W) int32 of 8 × 16 blocks of class ids in [0, classes);
    with `ignore`, one block id in twenty is 255."""
    h, w = hw
    ids = torch.randint(0, classes + (1 if ignore else 0), (n, 8, 16), generator=g, device=device)
    if ignore:
        ids = torch.where(ids == classes, torch.full_like(ids, IGNORE), ids)
    ids = ids.repeat_interleave(-(-h // 8), 1)[:, :h].repeat_interleave(-(-w // 16), 2)[:, :, :w]
    return ids.to(torch.int32)


def pil_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """(n, H, W) maps resized as Pillow's NEAREST does: source index
    floor((i + 0.5)·in/out)."""
    (h, w), (oh, ow) = x.shape[-2:], out_hw
    rows = [min(int((i + 0.5) * (h / oh)), h - 1) for i in range(oh)]
    cols = [min(int((j + 0.5) * (w / ow)), w - 1) for j in range(ow)]
    return x[:, rows][:, :, cols]


def normalize(rgb: torch.Tensor) -> torch.Tensor:
    """(n, H, W, 3) uint8 RGB → (n, 3, H, W) float32, BGR, normalised."""
    bgr = rgb.flip(-1).permute(0, 3, 1, 2).float()
    mean = torch.tensor(MEAN, device=rgb.device).view(1, 3, 1, 1) / 255.0
    inv = 255.0 / torch.tensor(STD, device=rgb.device).view(1, 3, 1, 1)
    return ((bgr * (1.0 / 255.0) - mean) * inv).contiguous()


# ---------------------------------------------------------------------------
# PNG files
# ---------------------------------------------------------------------------


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, arr: np.ndarray) -> None:
    """An (H, W, 3) RGB or (H, W) gray uint8 array as a PNG, every row
    unfiltered, written under a temporary name and renamed into place."""
    h, w = arr.shape[:2]
    color = 2 if arr.ndim == 3 else 0
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, -1)], axis=1)
    data = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.part"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def read_png(path: str) -> np.ndarray:
    """A PNG that `write_png` wrote, as its array."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, shape = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            if depth != 8 or color not in (0, 2):
                raise ValueError(f"{path}: not an 8-bit RGB or gray PNG")
            shape = (h, w, 3) if color == 2 else (h, w)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + length
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(shape[0], -1)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered rows; this reader takes unfiltered ones only")
    return rows[:, 1:].reshape(shape)


# ---------------------------------------------------------------------------
# Pillow's bicubic resample
# ---------------------------------------------------------------------------

_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    a, x = -0.5, np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    far = (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coeffs(n_in: int, n_out: int):
    """(index (n_out, k) into the input, fixed-point weights (n_out, k))."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    k = int(math.ceil(support)) * 2 + 1
    index = np.zeros((n_out, k), np.int64)
    weight = np.zeros((n_out, k), np.int64)
    for o in range(n_out):
        center = (o + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), n_in)
        taps = np.arange(lo, hi)
        w = _bicubic((taps - center + 0.5) / filterscale)
        if w.sum() != 0.0:
            w = w / w.sum()
        index[o, :len(taps)] = taps
        weight[o, :len(taps)] = np.round(w * (1 << _PRECISION_BITS)).astype(np.int64)
    return index, weight


def _pass(x: np.ndarray, axis: int, n_out: int) -> np.ndarray:
    index, weight = _coeffs(x.shape[axis], n_out)
    moved = np.moveaxis(x.astype(np.int64), axis, 0)             # (n_in, ...)
    acc = np.full((n_out,) + moved.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    for j in range(index.shape[1]):
        acc += moved[index[:, j]] * weight[:, j].reshape((-1,) + (1,) * (moved.ndim - 1))
    return np.moveaxis(np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8), 0, axis)


def resize_bicubic(rgb: np.ndarray, out_hw) -> np.ndarray:
    """An (H, W, 3) uint8 image resized to out_hw as Pillow's
    `resize(BICUBIC)`: the horizontal pass, then the vertical one."""
    h, w = out_hw
    return _pass(_pass(rgb, 1, w), 0, h)
