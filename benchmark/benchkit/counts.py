"""The yardstick's arithmetic: the operations a step needs, the bytes K1 and
K2 must move, the chip's peaks, and the union of device intervals. What
depends on the model comes from the cell's reference model
(`harness.Model`): its forward's convolutions and dense layers, its norm
inputs, its feature grid and its width F, counted on the meta device and
cached on the model's name and shape keys.

Frozen copies, kept here so that the yardstick does not move with the
program: the byte counts of `chip_smoke.py::check_k1` and `check_k2`
(each input read once, each output written once), its H100 peaks, and the
interval union of `methods/proto_online.py::_union_ms`.
"""

from __future__ import annotations

import functools

import torch

from . import reference as R

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
FP32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
TF32_FLOPS = 495e12         # H100 SXM dense TF32 tensor cores (700 W)
K2_KERNELS = ("bn_stats_cluster_kernel", "stats_cl_kernel", "finalize_kernel")
K1_KERNELS = ("pseudo_labels_kernel",)


def meta_params(model) -> dict:
    return {k: torch.empty(s, device="meta") for k, s in model.shapes().items()}


@functools.lru_cache(maxsize=None)
def forward_flops(model, hw, aux: bool) -> float:
    """2·N·K over every convolution and dense layer of one image's forward
    (the main head, and the aux head with `aux`), counted on the meta
    device by PyTorch's FLOP counter over the reference model."""
    from torch.utils.flop_counter import FlopCounterMode

    P = meta_params(model)
    with FlopCounterMode(display=False) as counter:
        model.Net()(P, torch.empty(1, 3, *hw, device="meta"), False, aux=aux)
    return float(counter.get_total_flops())


@functools.lru_cache(maxsize=None)
def disc_flops(hw) -> float:
    """One discriminator's forward on one image's (19, H, W) entropy map."""
    from torch.utils.flop_counter import FlopCounterMode

    D = {k: torch.empty(s, device="meta") for k, s in R.disc_shapes("d").items()}
    with FlopCounterMode(display=False) as counter:
        R.Net.disc(D, "d", torch.empty(1, 19, *hw, device="meta"))
    return float(counter.get_total_flops())


def step_flops(spec: dict, model, hw, batch: int, fired: bool = True) -> float:
    """The operations one step needs, from the configuration's "step_flops":
    `model` forward-equivalents of the model an image (a backward counts as
    twice its forward, no recomputation counted), `gated` more on a step
    whose gate fired, the aux head counted when `aux_head`, and `disc`
    forward-equivalents of one discriminator an image.

    hybrid: the EMA and static teachers' forwards on the batch (2), the
    student's forward and backward on the source and target batches (6),
    the gated dynamic teacher (1); advent: the multi-level student's forward
    and backward on both batches (6), and for each of its two
    discriminators the target map's forward and input backward (the fool
    loss) and both maps' forward and weight backward (its own loss): 12."""
    f = forward_flops(model, tuple(hw), bool(spec.get("aux_head", False)))
    out = batch * f * (spec["model"] + (spec.get("gated", 0) if fired else 0))
    if spec.get("disc"):
        out += batch * spec["disc"] * disc_flops(tuple(hw))
    return out


@functools.lru_cache(maxsize=None)
def bn_input_shapes(model, hw, batch: int):
    """The input shape of every BatchNorm of one forward at (batch, 3, *hw),
    in call order, from the reference model on the meta device."""
    shapes = []
    P = meta_params(model)
    net = model.Net(observe=lambda x: shapes.append(tuple(x.shape)))
    net(P, torch.empty(batch, 3, *hw, device="meta"), False)
    return tuple(shapes)


def k2_bytes(shape) -> int:
    """K2 on one f32 (N, C, H, W) input: the input read once, the mean and
    variance written once."""
    n, c, h, w = shape
    return 4 * n * c * h * w + 2 * c * 4


def k1_bytes(n_pix: int, n_feat: int, n_cls: int = 19) -> int:
    """K1 on P pixels: features, prototypes, prior, scale and τ read once;
    soft labels, hard labels and the per-pixel maximum written once."""
    return 4 * (n_pix * n_feat + n_cls * n_feat + 2 * n_pix * n_cls + n_feat + 1 + 2 * n_pix)


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes at HBM3's
    rate and the operations at float32's (both kernels compute in f32
    outside the tensor cores)."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)


def k2_step_bound_s(forwards: int, model, hw, batch: int) -> float:
    """K2's least time a step of `forwards` train-mode forwards at `batch`:
    each of the model's BatchNorm inputs' bytes, or its 3 operations an
    element (sum, square, add), whichever bounds it, summed over the
    calls."""
    return forwards * sum(bound_s(k2_bytes(s), 3.0 * s[0] * s[1] * s[2] * s[3])
                          for s in bn_input_shapes(model, tuple(hw), batch))


def k1_step_bound_s(calls: int, model, hw, batch: int, n_cls: int = 19) -> float:
    """K1's least time a step of `calls` calls on the batch's pixels of the
    model's feature grid, P of them, at its width F: each call bound by its
    bytes or its 2·P·C·F + P·F operations."""
    h, w = model.feature_grid(hw)
    p, n_feat = batch * h * w, model.FEATURES
    return calls * bound_s(k1_bytes(p, n_feat, n_cls), 2.0 * p * n_cls * n_feat + p * n_feat)


def union_seconds(intervals) -> float:
    """Total length of the union of (start, end) intervals, in their unit."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total
