"""Carry weights of the JAX package across: Flax variables → this port's state_dict
(the DeepLab-v2 model's here; the discriminators' in `flax_disc_to_state_dict`,
DeepLab-v3's in `flax_v3_to_state_dict`).

The input is the JAX model's variables as a nested dict of numpy arrays
(`{"params": ..., "batch_stats": ...}`); the output is a state_dict of the
port's `DeepLabV2` in the reference OnDA key layout:

* conv kernels HWIO → OIHW, dense kernels (I, O) → (O, I);
* GroupNorm / BatchNorm `scale` → `weight`; `batch_stats` → running buffers,
  plus a `num_batches_tracked` counter (0) beside every BatchNorm; the GN
  backbone's inner `gn` scope drops (`layer1/0/bn1/gn/scale` →
  `layer1.0.bn1.weight`, no buffers), and the ProDA layout's
  `bn_pretrain` is a BatchNorm like any other;
* ProDA classifier branches → Sequential indices
  (`layer6/branch2_gn/gn/scale` → `layer6.conv2d_list.2.1.weight`), at
  `layer5` too (the aux head, or the ProDA layout's only head).
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_BN_LEAF = {"scale": "weight", "bias": "bias", "running_mean": "running_mean",
            "running_var": "running_var"}
_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight"}
# the torch axes of a converted leaf, as axes of the JAX leaf, by rank: conv
# kernels HWIO → OIHW, dense kernels (I, O) → (O, I), vectors as they are
_AXES = {4: (3, 2, 0, 1), 2: (1, 0), 1: (0,)}


def channel_axis(ndim: int) -> int:
    """The torch axis of a converted leaf of rank `ndim` that holds the JAX
    leaf's last (channel, C_out) axis: axis 0 at every rank."""
    return _AXES[ndim].index(ndim - 1)


def torch_key(path: tuple[str, ...]) -> str | None:
    """The state_dict key of one Flax variable path (collection first)."""
    collection, *parts = path
    leaf, scope = parts[-1], parts[:-1]
    if scope and scope[0] in ("layer5", "layer6"):
        head, name = scope[0], (scope[1] if len(scope) > 1 else "")
        if m := re.fullmatch(r"branch(\d+)_conv", name):
            return f"{head}.conv2d_list.{m.group(1)}.0.{_LEAF[leaf]}"
        if m := re.fullmatch(r"branch(\d+)_gn", name):
            return f"{head}.conv2d_list.{m.group(1)}.1.{_LEAF[leaf]}"
        if m := re.fullmatch(r"conv_(\d+)", name):
            return f"{head}.conv2d_list.{m.group(1)}.{_LEAF[leaf]}"
        named = {"se_fc1": "bottleneck.0.se.0", "se_fc2": "bottleneck.0.se.2",
                 "bottleneck_conv": "bottleneck.1", "bottleneck_gn": "bottleneck.2",
                 "head_conv": "head.1"}
        return f"{head}.{named[name]}.{_LEAF[leaf]}" if name in named else None
    scope = [s.replace("downsample_conv", "downsample.0").replace("downsample_bn", "downsample.1")
             for s in scope]
    if scope and scope[-1] == "gn":
        scope = scope[:-1]
    prefix = ".".join(scope)
    if collection == "batch_stats":
        return f"{prefix}.{_BN_LEAF[leaf]}"
    if leaf in ("scale", "bias") and scope and ("bn" in scope[-1] or "downsample.1" in scope[-1]):
        return f"{prefix}.{_BN_LEAF[leaf]}"
    return f"{prefix}.{_LEAF[leaf]}"


def _flatten(tree: Mapping[str, Any], prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def flax_to_state_dict(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """State_dict of the port's model from the JAX model's variables."""
    out = {}
    for path, value in _flatten(variables):
        key = torch_key(path)
        if key is None:
            raise KeyError(f"no state_dict key for flax path {path}")
        value = np.array(value, np.float32)  # a writable copy
        if path[-1] == "kernel":
            value = value.transpose(_AXES[value.ndim])
        out[key] = torch.from_numpy(np.ascontiguousarray(value))
    return _with_bn_counters(out)


def _with_bn_counters(out: dict) -> dict:
    """`out` with a `num_batches_tracked` counter (0) beside every BatchNorm."""
    for key in [k for k in out if k.endswith(".running_mean")]:
        out[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return out


def _by_scope(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The state_dict of a port model whose module names are the flax scopes
    joined with '.': `kernel` HWIO → `weight` OIHW (a depthwise kernel
    (kh, kw, 1, C) → (C, 1, kh, kw)), `scale` → `weight`, `bias` and the
    running buffers as they are, a `num_batches_tracked` counter (0) beside
    every BatchNorm; a ResNet stage's `downsample_conv`/`downsample_bn`
    become `deeplabv2.ResLayer`'s `downsample.0`/`downsample.1`."""
    out = {}
    for (_, *scope, leaf), value in _flatten(variables):
        value = np.array(value, np.float32)
        if leaf == "kernel":
            value = value.transpose(_AXES[4])
        scope = [{"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}.get(s, s)
                 for s in scope]
        key = ".".join(scope + [{**_BN_LEAF, "kernel": "weight"}[leaf]])
        out[key] = torch.from_numpy(np.ascontiguousarray(value))
    return _with_bn_counters(out)


def flax_disc_to_state_dict(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """State_dict of the port's `FCDiscriminator` / `DCGANDiscriminator` from
    the JAX discriminator's variables: `conv{i}/kernel` HWIO → `conv{i}.weight`
    OIHW, `bias` as is, and for DCGAN `bn{i}/scale` → `bn{i}.weight` with its
    running buffers and a `num_batches_tracked` counter (0)."""
    return _by_scope(variables)


def flax_v3_to_state_dict(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """State_dict of the port's `DeepLabV3` from the JAX v3 variables (which
    have no reference-layout names): `backbone/block3_1/depthwise/conv/kernel`
    → `backbone.block3_1.depthwise.conv.weight`, `aspp/pool/bn/running_var`
    → `aspp.pool.bn.running_var`, `backbone/layer1/0/downsample_bn/scale` →
    `backbone.layer1.0.downsample.1.weight`, `classifier/bias` as is."""
    return _by_scope(variables)
