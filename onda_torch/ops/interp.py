"""Resizes with the reference's torch semantics (`onda_tpu/ops/interp.py`).

Logits are upsampled with bilinear ``align_corners=True`` (reference
methods/adaptation_model.py:94-98) and labels downsampled with nearest
(reference methods/prototypes.py:144). NCHW in, NCHW out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample_bilinear_ac(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear align_corners=True resize of an (N, C, H, W) tensor."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=True)


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest resize of (N, H, W) labels or (N, C, H, W) maps; keeps the dtype."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    squeeze = x.dim() == 3
    y = x[:, None] if squeeze else x
    y = F.interpolate(y.float(), size=tuple(out_hw), mode="nearest").to(x.dtype)
    return y[:, 0] if squeeze else y
