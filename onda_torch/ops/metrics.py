"""Evaluation metrics: confusion histogram, IoU, mean entropy, streaming ECE
(`onda_tpu/ops/metrics.py`).

Histograms and ECE accumulators stay on the device until the final
per-class reduction (reference framework/utils/func.py:77-85,
framework/utils/monitoring.py:99-136).
"""

from __future__ import annotations

import numpy as np
import torch


def fast_hist(label: torch.Tensor, pred: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(C, C) int64 confusion matrix, hist[l, p]; labels outside [0, C) are dropped."""
    label = label.reshape(-1).long()
    pred = pred.reshape(-1).long()
    valid = (label >= 0) & (label < num_classes)
    idx = torch.where(valid, num_classes * label + pred, torch.full_like(label, num_classes**2))
    flat = torch.zeros(num_classes**2 + 1, dtype=torch.long, device=idx.device)
    flat.index_add_(0, idx, torch.ones_like(idx))  # no host sync, unlike bincount
    return flat[:-1].reshape(num_classes, num_classes)


def per_class_iu(hist) -> np.ndarray:
    """Per-class IoU from a confusion matrix (reference func.py:82-85)."""
    if isinstance(hist, torch.Tensor):
        hist = hist.cpu().numpy()
    hist = np.asarray(hist, dtype=np.float64)
    diag = np.diag(hist)
    return diag / (hist.sum(1) + hist.sum(0) - diag + np.finfo(float).eps)


def miou(hist) -> float:
    return float(np.nanmean(per_class_iu(hist)))


def mean_entropy(probs: torch.Tensor) -> torch.Tensor:
    """Mean of the reference's weighted self-information map of (N, C, H, W)
    probabilities: `prob_2_entropy` normalizes by log2(C) (reference
    utils/func.py:71-74) and its consumer means over all axes, channels
    included (reference eval_UDA.py:48-51), so uniform predictions give 1/C."""
    c = probs.shape[1]
    return (-(probs * torch.log2(probs + 1e-30)) / np.log2(float(c))).mean()


def ece_init(bins: int, device="cpu") -> torch.Tensor:
    """(bins, 3) accumulator: [summed confidence, #correct, #samples] per bin."""
    return torch.zeros((bins, 3), dtype=torch.float32, device=device)


def ece_record(acc, probs, label, weight=None):
    """Accumulate a batch (reference monitoring.py:106-127). probs: (N, C, H, W)
    probabilities; label (N, H, W). 255 pixels count as incorrect; `weight`
    (broadcastable to label, 0/1) excludes padded rows."""
    bins = acc.shape[0]
    conf, pred = probs.max(dim=1)
    conf, pred, lbl = conf.reshape(-1), pred.reshape(-1), label.reshape(-1)
    bin_idx = (conf * bins).long().clamp(0, bins - 1)
    stacked = torch.stack([conf, (pred == lbl).float(), torch.ones_like(conf)], dim=-1)
    if weight is not None:
        stacked = stacked * torch.broadcast_to(weight, label.shape).reshape(-1, 1).float()
    return acc.index_add(0, bin_idx, stacked)


def ece_value(acc) -> torch.Tensor:
    """|sum_conf − n_correct| summed over bins / total samples (reference monitoring.py:132-136)."""
    return (acc[:, 0] - acc[:, 1]).abs().sum() / acc[:, 2].sum()
