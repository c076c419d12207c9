"""Segmentation / adaptation losses on NCHW logits (`onda_tpu/ops/losses.py`).

Predictions are (N, C, H, W) logits; hard labels are (N, H, W) integers with
255 = ignore; soft labels are (N, C, H, W). Formulas follow the reference
framework/utils/loss.py and methods/prototypes.py:29-39, quirks included.

A loss that is a mean over pixels takes an optional `count`, the number of
pixels it divides by (the valid ones for hard labels, all of them otherwise).
Under data parallelism, and on a spatial axis (where a rank holds a block
of each image's rows), the step passes the count of the global batch, so
that each rank's value is its share of the global loss: the ranks' values,
and their gradients, sum to the loss of the global batch. By default the
count is this batch's own.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

IGNORE = 255


def _valid_mask(target: torch.Tensor) -> torch.Tensor:
    """(target >= 0) & (target != 255), float (reference loss.py:36)."""
    return ((target >= 0) & (target != IGNORE)).float()


def valid_count(target: torch.Tensor) -> torch.Tensor:
    """The number of valid pixels of hard labels, f32 (0-d)."""
    return _valid_mask(target).sum()


def _onehot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(N, C, H, W) one-hot; labels outside [0, C) give a zero row."""
    classes = torch.arange(num_classes, device=labels.device)[None, :, None, None]
    return (labels[:, None].long() == classes).float()


def cross_entropy_2d(logits, target, soft: bool = False, count=None):
    """Masked mean CE over valid pixels (reference loss.py:16-45).

    Soft mode keeps the reference's quirk: the target is truncated to integers
    (`.long()` in loss_calc, reference func.py:35-42) and the CE is taken on
    RAW logits, so the value is nan and the gradient is zero
    (see `onda_tpu/ops/losses.py::cross_entropy_2d`)."""
    if soft:
        t = torch.trunc(target)
        per_pixel = -(t * torch.log(logits + 1e-6)).sum(dim=1)
        return per_pixel.mean() if count is None else per_pixel.sum() / count
    mask = _valid_mask(target)
    logp = F.log_softmax(logits, dim=1)
    tclip = target.clamp(0, logits.shape[1] - 1).long()
    picked = logp.gather(1, tclip[:, None])[:, 0]
    total = -(picked * mask).sum()
    count = mask.sum() if count is None else count
    return torch.where(count > 0, total / count.clamp(min=1.0), torch.zeros_like(total))


def entropy_loss(probs):
    """Normalized entropy of probability maps (reference loss.py:48-56)."""
    n, c, h, w = probs.shape
    return -torch.sum(probs * torch.log2(probs + 1e-30)) / (n * h * w * math.log2(c))


def _clamped_one_hot(labels, num_classes: int):
    """One-hot with 255 → zero row, clamped to [1e-4, 1] (reference loss.py:100-106)."""
    return _onehot(labels, num_classes).clamp(1e-4, 1.0)


def rce(logits, labels, soft: bool = False, count=None):
    """Reverse cross-entropy (reference loss.py:88-112)."""
    probs = F.softmax(logits, dim=1)
    n, c, h, w = logits.shape
    if soft:
        return -(probs * torch.log(labels + 1e-6)).sum() / (n * h * w if count is None else count)
    mask = _valid_mask(labels)
    one_hot = _clamped_one_hot(labels, c)
    count = mask.sum() if count is None else count
    return -((probs * torch.log(one_hot)).sum(dim=1) * mask).sum() / (count + 1e-6)


def js_divergence(logits, labels, count=None):
    """Jensen–Shannon divergence vs hard labels (reference loss.py:62-85): masked
    predictions, a clamped but unmasked one-hot, scaled by N*H*W / mask.sum()."""
    probs = F.softmax(logits, dim=1)
    n, c, h, w = logits.shape
    mask = _valid_mask(labels)
    mpred = probs * mask[:, None]
    one_hot = _clamped_one_hot(labels, c)
    per = entropy_loss((one_hot + mpred) / 2.0) - (entropy_loss(one_hot) + entropy_loss(mpred)) / 2.0
    return per * n * h * w / (mask.sum() if count is None else count)


def regular_loss(regularizer: str, logits, count=None):
    """MRENT: (p·log p).sum()/(N·H·W); MRKLD: −log p.sum()/(N·C·H·W)
    (reference methods/prototypes.py:29-39); `count` replaces N·H·W."""
    n, c, h, w = logits.shape
    pixels = n * h * w if count is None else count
    logp = F.log_softmax(logits, dim=1)
    if regularizer == "MRENT":
        return (F.softmax(logits, dim=1) * logp).sum() / pixels
    if regularizer == "MRKLD":
        return -logp.sum() / (c * pixels)
    return logits.new_zeros(())


def prob_2_entropy(probs):
    """Weighted self-information maps −p·log2(p)/log2(C) of (N, C, H, W)
    probabilities (reference func.py:71-74)."""
    return -probs * torch.log2(probs + 1e-30) / math.log2(probs.shape[1])


def bce_with_logits(logits, label: float, count=None):
    """Mean BCE-with-logits against a constant label map (reference func.py:28-32);
    `count` replaces the number of outputs it divides by."""
    per = logits.clamp(min=0) - logits * label + torch.log1p(torch.exp(-logits.abs()))
    return per.mean() if count is None else per.sum() / count


def ewc_loss(lamda: float, anchor_params: dict, current_params: dict, fishers: dict | None = None):
    """EWC-style weight anchoring (reference ewc.py:47-54): unit Fisher, as the
    live path uses it, or the diagonal Fisher of `compute_fisher`."""
    if fishers is None:
        total = sum(((anchor_params[k] - current_params[k]) ** 2).sum() for k in current_params)
    else:
        total = sum((fishers[k] * (anchor_params[k] - current_params[k]) ** 2).sum()
                    for k in current_params)
    return lamda / 2.0 * total


def compute_fisher(logit_fn, params: dict, images, labels) -> dict:
    """Diagonal Fisher information: the squared gradient of the mean
    log-likelihood of `labels` (reference ewc.py:15-41, its "mean of
    loglikelihoods" variant). `logit_fn(params, images)` gives (N, C, ...)
    logits, `labels` the (N, ...) class ids; 255 is ignored. A parameter the
    logits do not depend on gets a zero Fisher."""
    live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    logp = F.log_softmax(logit_fn(live, images).float(), dim=1)
    labels = labels.long()
    picked = logp.gather(1, labels.clamp(0, logp.shape[1] - 1)[:, None])[:, 0]
    valid = (labels != IGNORE).float()
    mean_loglik = (picked * valid).sum() / valid.sum().clamp(min=1.0)
    grads = torch.autograd.grad(mean_loglik, list(live.values()), allow_unused=True)
    return {k: torch.zeros_like(v) if g is None else g.detach() ** 2
            for (k, v), g in zip(live.items(), grads)}
