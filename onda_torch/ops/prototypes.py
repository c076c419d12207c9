"""Class-prototype engine: running feature moments -> distances -> pseudo-labels.

PyTorch counterpart of `onda_tpu/ops/prototypes.py` (reference
prototype_handler.py:8-166). Shapes: feat (P, F); class scores (P, C);
prototypes (C, F). The distance, softmax, prior fusion and threshold functions
below are also the plain version that the hand-written kernel K1
(`ops/kernels.pseudo_labels`) is checked against: `pseudo_labels_plain`
composes them exactly as the adaptation step does.
"""

from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np
import torch


@dataclasses.dataclass
class ProtoState:
    mean: torch.Tensor     # (C, F) running class means
    sq_mean: torch.Tensor  # (C, F) running class means of feat**2
    count: torch.Tensor    # (C,)  samples seen per class
    tau: torch.Tensor      # ()    softmax temperature, a device tensor (drifts)

    def replace(self, **kw) -> "ProtoState":
        return dataclasses.replace(self, **kw)


def init_state(num_classes: int, num_features: int, tau: float = 1.0,
               device="cpu") -> ProtoState:
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)  # noqa: E731
    return ProtoState(
        mean=zeros(num_classes, num_features),
        sq_mean=zeros(num_classes, num_features),
        count=zeros(num_classes),
        tau=torch.tensor(tau, dtype=torch.float32, device=device),
    )


# ---------------------------------------------------------------------------
# Moment gathering
# ---------------------------------------------------------------------------


def onehot_assign(scores: torch.Tensor) -> torch.Tensor:
    """Hard one-hot of the argmax class (reference :83-86). scores: (P, C)."""
    c = scores.shape[-1]
    return (scores.argmax(dim=-1)[..., None] == torch.arange(c, device=scores.device)).float()


def class_moments(feat: torch.Tensor, onehot: torch.Tensor):
    """Per-class feature sums (reference get_proto_array :76-81).

    Returns (vect (C, F) = onehotᵀ @ feat, sq (C, F) = onehotᵀ @ feat², sums (C,))."""
    vect = onehot.T @ feat
    sq = onehot.T @ (feat * feat)
    return vect, sq, onehot.sum(dim=0)


def append(state: ProtoState, vect, sq, sums) -> ProtoState:
    """Exact running mean / mean-of-squares update (reference append :62-74)."""
    count = state.count + sums
    denom = torch.where(count > 0, count, torch.ones_like(count))[:, None]
    mean = state.mean + (vect - state.mean * sums[:, None]) / denom
    sq_mean = state.sq_mean + (sq - state.sq_mean * sums[:, None]) / denom
    return state.replace(mean=mean, sq_mean=sq_mean, count=count)


def ma(state: ProtoState, vect, sq, sums, ma_lambda: float) -> ProtoState:
    """EMA update touching only classes present in the batch (reference ma :88-99)."""
    present = sums > 0
    rev = torch.where(present, torch.full_like(sums, ma_lambda), torch.ones_like(sums))[:, None]
    denom = torch.where(present, sums, torch.ones_like(sums))[:, None]
    mean = state.mean * rev + (1.0 - rev) * (vect / denom)
    sq_mean = state.sq_mean * rev + (1.0 - rev) * (sq / denom)
    return state.replace(mean=mean, sq_mean=sq_mean)


# ---------------------------------------------------------------------------
# Distances and pseudo-labels
# ---------------------------------------------------------------------------


def prototype_var(state: ProtoState) -> torch.Tensor:
    """Per-class feature std (reference prototype_var :49-51)."""
    return torch.sqrt(state.sq_mean - state.mean**2)


def global_var(state: ProtoState) -> torch.Tensor:
    """Count-weighted global feature std across classes (reference global_var :53-60)."""
    w = state.count / state.count.sum()
    g_sq = (state.sq_mean * w[:, None]).sum(dim=0)
    g_mean = (state.mean * w[:, None]).sum(dim=0)
    return torch.sqrt(g_sq - g_mean**2)


def inv_std(state: ProtoState, metric: str):
    """The per-feature scale of the distance: 1/global std for "mahalanobis"
    (diagonal Mahalanobis, reference :116-118), None for "euclidean"."""
    if metric == "mahalanobis":
        return 1.0 / global_var(state)
    if metric == "euclidean":
        return None
    raise ValueError(f"unknown distance metric {metric!r}")


def scaled_distances(feat: torch.Tensor, protos: torch.Tensor, scale=None) -> torch.Tensor:
    """(P, C) L2 distances of `feat` and `protos`, both multiplied by `scale`
    (F,) when given, per-pixel minimum subtracted (reference :111-138)."""
    if scale is not None:
        feat = feat * scale[None, :]
        protos = protos * scale[None, :]
    f2 = (feat * feat).sum(dim=-1, keepdim=True)
    p2 = (protos * protos).sum(dim=-1)[None, :]
    d = torch.sqrt(torch.clamp(f2 - 2.0 * (feat @ protos.T) + p2, min=0.0))
    return d - d.min(dim=-1, keepdim=True).values


def distances(feat: torch.Tensor, state: ProtoState, metric: str = "euclidean") -> torch.Tensor:
    """(P, C) distance matrix, per-pixel min subtracted (reference :111-138)."""
    return scaled_distances(feat, state.mean, inv_std(state, metric))


def proto_probs(dis: torch.Tensor, tau) -> torch.Tensor:
    """softmax(-d/tau) over classes (reference pseudo_labels :147)."""
    e = torch.exp(-dis / tau)
    return e / e.sum(dim=-1, keepdim=True)


def fuse_prior(prop: torch.Tensor, prior: torch.Tensor) -> torch.Tensor:
    """prop * prior, renormalized (reference pseudo_labels :159-160)."""
    fused = prop * prior
    return fused / fused.sum(dim=-1, keepdim=True)


def hard_labels(fused: torch.Tensor, thresh: float) -> torch.Tensor:
    """argmax with 255 where max prob < thresh (reference pseudo_labels :163-166); int32."""
    mx, lbl = fused.max(dim=-1)
    return torch.where(mx < thresh, torch.full_like(lbl, 255), lbl).to(torch.int32)


def pseudo_labels_plain(feat, protos, prior, tau, thresh: float, scale=None):
    """Plain version of K1: (soft (P, C), hard (P,) int32, max_c prop (P,))."""
    prop = proto_probs(scaled_distances(feat, protos, scale), tau)
    soft = fuse_prior(prop, prior)
    return soft, hard_labels(soft, thresh), prop.max(dim=-1).values


# ---------------------------------------------------------------------------
# Persistence (pickle-compatible with the reference and the JAX package)
# ---------------------------------------------------------------------------


def save(state: ProtoState, loc: str) -> None:
    """3-tuple pickle (prototypes, squared_mean, counter) of numpy arrays (reference save :37-38)."""
    payload = tuple(t.detach().cpu().numpy() for t in (state.mean, state.sq_mean, state.count))
    with open(loc, "wb") as f:
        pickle.dump(payload, f)


def load(state: ProtoState, loc: str) -> tuple[ProtoState, bool]:
    """Load a prototype pickle if it exists (reference load :40-47): the live
    3-tuple format or the legacy 2-tuple (prototypes, counter)."""
    if not os.path.exists(loc):
        return state, False
    with open(loc, "rb") as f:
        payload = pickle.load(f)
    as_np = lambda v: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)  # noqa: E731
    if len(payload) == 3:
        mean, sq, count = (as_np(p) for p in payload)
    elif len(payload) == 2:  # legacy: no squared mean recorded
        mean, count = (as_np(p) for p in payload)
        sq = mean**2
    else:
        raise ValueError(f"unexpected prototype pickle arity {len(payload)}")
    dev = state.mean.device
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    return state.replace(mean=t(mean), sq_mean=t(sq), count=t(count)), True
