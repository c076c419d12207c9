"""Wrappers of the hand-written Hopper kernels, with their plain versions and
their launch plans.

* K1 `pseudo_labels` (csrc/pseudo_labels.cu) replaces the Pallas kernel
  `onda_tpu/ops/pallas_kernels.py::fused_pseudo_labels`.
* K2 `bn_stats` (csrc/bn_stats.cu) replaces the Pallas kernel
  `onda_tpu/ops/pallas_kernels.py::bn_batch_stats`; `bn_moments` is the same
  kernel writing the raw moments (mean, E[x²], f64) that data parallelism
  all-reduces.
* BatchNorm's passes after the statistics (csrc/bn_norm.cu), which replace
  no TPU kernel (the JAX package leaves them to XLA's fusion): `bn_apply`
  normalises (train and eval, with the running update in the same launch),
  `bn_grad_sums` reduces the backward's per-channel sums and `bn_grad_dx`
  writes the input gradient. Their launches count in `bn_launches`, apart
  from `launches`, which holds K1 and K2 alone.

A wrapper takes its plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel or raises: it checks device, dtype, shape,
contiguity and alignment, allocates the outputs with `torch.empty`, launches
on the current stream and raises when the launch returns a CUDA error.
`launches` and `bn_launches` count the kernel launches of each wrapper
(never the plain version). K2's launch geometry is computed here, in
`bn_stats_plan`, and that of the BatchNorm passes in `bn_pass_plan` and
`bn_cl_plan`, so that the CPU tests can check that they cover every element
once; K1 sizes its persistent grid itself, from the card's occupancy.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build
from . import prototypes as P

launches = {"pseudo_labels_kernel": 0, "bn_stats_kernel": 0}
bn_launches = {"bn_apply_kernel": 0, "bn_grad_sums_kernel": 0, "bn_grad_dx_kernel": 0}

K1_MAX_CLASSES = 32        # csrc/pseudo_labels.cu: kMaxC
# K2 (csrc/bn_stats.cu): 256-thread blocks; about 512 of them (4 on each of
# 132 SMs; 1024 and 3072 were slower on an H100, 256 no faster) but none
# reading less than 32 KB; clusters of at most 8
K2_THREADS, K2_TARGET_BLOCKS, K2_MIN_BLOCK_BYTES, K2_MAX_CLUSTER = 256, 512, 32 * 1024, 8
K2_SPAN_ALIGN = 8          # elements: 16 bytes of bf16
K2_CL_ROWS = 1024          # channels_last: rows per block
# The BatchNorm passes (csrc/bn_norm.cu): 256-thread blocks; about 1024 a
# pass (8 on each of 132 SMs) but none taking less than 4 KB of x, which
# still fills the card at every BatchNorm input the port feeds
BN_THREADS, BN_TARGET_BLOCKS, BN_MIN_BLOCK_BYTES = 256, 1024, 4 * 1024
BN_CL_ROWS, BN_CL_CHANNELS = 1024, 32   # channels_last reduction: rows and channels a block


def reset_launches() -> None:
    for counts in (launches, bn_launches):
        for key in counts:
            counts[key] = 0


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _on_cpu(*tensors) -> bool:
    """True for tensors all on the CPU (or all on the meta device, where the
    plain versions give the shapes), False for tensors all on one card."""
    devices = {t.device.type for t in tensors if t is not None}
    if devices in ({"cpu"}, {"meta"}):
        return True
    if devices != {"cuda"} or len({t.device for t in tensors if t is not None}) != 1:
        raise ValueError(f"tensors must all be on the CPU or all on one CUDA device, got {devices}")
    return False


def _require(t, name, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# K1 — prototype pseudo-labels
# ---------------------------------------------------------------------------


def _k1_lib():
    lib = build.load("pseudo_labels")
    fn = lib.onda_pseudo_labels
    if fn.argtypes is None:
        v, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [v, v, v, v, v, ctypes.c_float, i, i, i, v, v, v, v]
        fn.restype = i
    return fn


def pseudo_labels(feat, protos, prior, tau, thresh: float, scale=None):
    """K1. feat (P, F), protos (C, F), prior (P, C), all f32; tau a 0-d f32
    tensor read on the device; `scale` an optional (F,) f32 multiplier of
    features and prototypes (1/global std for mahalanobis).

    Returns (soft (P, C) f32, hard (P,) int32 with 255 below `thresh`,
    prop_max (P,) f32, the per-pixel max of the unfused softmax(-d/tau))."""
    if _on_cpu(feat, protos, prior, tau, scale):
        return P.pseudo_labels_plain(feat, protos, prior, tau, thresh, scale)
    n_pix, n_feat = feat.shape
    n_cls = protos.shape[0]
    _require(feat, "feat", torch.float32, (n_pix, n_feat))
    _require(protos, "protos", torch.float32, (n_cls, n_feat))
    _require(prior, "prior", torch.float32, (n_pix, n_cls))
    _require(tau, "tau", torch.float32, ())
    if scale is not None:
        _require(scale, "scale", torch.float32, (n_feat,))
    if not 1 <= n_cls <= K1_MAX_CLASSES:
        raise ValueError(f"pseudo_labels_kernel supports 1..{K1_MAX_CLASSES} classes, got {n_cls}")
    if n_feat % 4 or feat.data_ptr() % 16:
        raise ValueError("pseudo_labels_kernel: F must be a multiple of 4 and feat 16-byte "
                         "aligned (its rows move by 16-byte copies)")
    soft = torch.empty((n_pix, n_cls), dtype=torch.float32, device=feat.device)
    hard = torch.empty((n_pix,), dtype=torch.int32, device=feat.device)
    prop_max = torch.empty((n_pix,), dtype=torch.float32, device=feat.device)
    rc = _k1_lib()(_ptr(feat), _ptr(protos), _ptr(prior), _ptr(tau), _ptr(scale),
                   float(thresh), n_pix, n_feat, n_cls, _ptr(soft), _ptr(hard),
                   _ptr(prop_max), _stream())
    _check(rc, f"pseudo_labels_kernel (F={n_feat}, C={n_cls}; a block's shared memory grows "
               f"with F*C)")
    launches["pseudo_labels_kernel"] += 1
    return soft, hard, prop_max


# ---------------------------------------------------------------------------
# K2 — BatchNorm batch statistics
# ---------------------------------------------------------------------------


def bn_stats_plain(x: torch.Tensor):
    """Plain version of K2: f32 per-channel mean and biased var
    max(E[x²] − E[x]², 0) of an (N, C, H, W) tensor (`_bn_train_math`)."""
    x32 = x.float()
    mean = x32.mean(dim=(0, 2, 3))
    mean_sq = (x32 * x32).mean(dim=(0, 2, 3))
    return mean, torch.clamp(mean_sq - mean * mean, min=0.0)


def bn_moments_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K2's raw moments: (2, C) f64, the per-channel mean
    and mean of squares E[x²] of an (N, C, H, W) tensor, summed in f64 as
    the kernel folds its sums."""
    x64 = x.double()
    return torch.stack([x64.mean(dim=(0, 2, 3)), (x64 * x64).mean(dim=(0, 2, 3))])


class K2Plan(NamedTuple):
    cluster: int  # blocks per channel: grid (cluster, C), one cluster per channel
    span: int     # values of the channel's N*H*W each block sums


def bn_stats_plan(n: int, c: int, hw: int, itemsize: int) -> K2Plan:
    """Launch geometry of K2 on an NCHW tensor: block r of a channel sums the
    values [r*span, (r+1)*span) of its N planes laid end to end; every block
    gets at least one value and together they cover the channel once."""
    m = n * hw
    cluster = max(1, min(K2_MAX_CLUSTER, _cdiv(K2_TARGET_BLOCKS, c),
                         m * itemsize // K2_MIN_BLOCK_BYTES))
    span = _cdiv(_cdiv(m, cluster), K2_SPAN_ALIGN) * K2_SPAN_ALIGN
    return K2Plan(_cdiv(m, span), span)


def _k2_lib():
    lib = build.load("bn_stats")
    if lib.onda_bn_stats_nchw.argtypes is None:
        v, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.onda_bn_stats_nchw.argtypes = [v, i, i, i, ll, i, ll, v, v, v, v]
        lib.onda_bn_stats_nchw.restype = i
        lib.onda_bn_stats_cl.argtypes = [v, i, ll, i, ll, i, v, v, v, v, v]
        lib.onda_bn_stats_cl.restype = i
    return lib


def _bn_launch(x: torch.Tensor, raw: bool) -> torch.Tensor:
    """K2 on a card tensor: (2, C), each channel's mean and biased var in
    f32, or with `raw` its mean and E[x²] in f64."""
    if x.dim() != 4:
        raise ValueError(f"bn_stats_kernel: expected a 4-D tensor, got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"bn_stats_kernel: expected float32 or bfloat16, got {x.dtype}")
    n, c, h, w = x.shape
    is_bf16 = int(x.dtype == torch.bfloat16)
    out = torch.empty((2, c), dtype=torch.float64 if raw else torch.float32, device=x.device)
    # raw: the kernel writes the whole f64 buffer; else its two f32 rows
    ptrs = (None, None, out) if raw else (out[0], out[1], None)
    if x.is_contiguous():
        plan = bn_stats_plan(n, c, h * w, x.element_size())
        rc = _k2_lib().onda_bn_stats_nchw(_ptr(x), is_bf16, n, c, h * w, plan.cluster, plan.span,
                                          *map(_ptr, ptrs), _stream())
    elif x.is_contiguous(memory_format=torch.channels_last):
        nchunks = _cdiv(n * h * w, K2_CL_ROWS)
        partial = torch.empty((2, c, nchunks), dtype=torch.float32, device=x.device)
        rc = _k2_lib().onda_bn_stats_cl(_ptr(x), is_bf16, n * h * w, c, K2_CL_ROWS, nchunks,
                                        _ptr(partial), *map(_ptr, ptrs), _stream())
    else:
        raise ValueError("bn_stats_kernel: x must be NCHW-contiguous or channels_last")
    _check(rc, "bn_stats_kernel")
    launches["bn_stats_kernel"] += 1
    return out


def bn_stats(x: torch.Tensor):
    """K2. Per-channel (mean, biased var), both (C,) f32, of an (N, C, H, W)
    f32 or bf16 tensor, NCHW-contiguous (one launch) or channels_last."""
    if _on_cpu(x):
        return bn_stats_plain(x)
    mean, var = _bn_launch(x, raw=False)
    return mean, var


def bn_moments(x: torch.Tensor) -> torch.Tensor:
    """K2's raw moments: (2, C) f64, the per-channel mean and E[x²] of an
    (N, C, H, W) f32 or bf16 tensor, in one launch as `bn_stats`: one buffer,
    ready for one all-reduce. f64 keeps the variance taken from the global
    moments as exact as the one the kernel takes for one device."""
    if _on_cpu(x):
        return bn_moments_plain(x)
    return _bn_launch(x, raw=True)


# ---------------------------------------------------------------------------
# BatchNorm's normalisation and its backward (no TPU kernel)
# ---------------------------------------------------------------------------

_NCHW = (1, -1, 1, 1)


def bn_apply_plain(x, mean, var, weight, bias, eps: float, running=None, with_inv=False):
    """Plain version of `bn_apply`: the expressions of `_bn_train_math` and of
    the eval branch, y = (x − mean)·(γ·rsqrt(var + eps)) + β in f32, cast to
    x's dtype; `running` (running_mean, running_var, momentum, n) takes the
    running update in place, the unbiased variance from n pixels."""
    inv = torch.rsqrt(var + eps)
    y = ((x.float() - mean.view(_NCHW)) * (inv * weight).view(_NCHW) + bias.view(_NCHW))
    if running is not None:
        running_mean, running_var, m, n = running
        with torch.no_grad():
            running_mean.mul_(1 - m).add_(m * mean)
            running_var.mul_(1 - m).add_(m * var * (n / max(n - 1, 1)))
    y = y.to(x.dtype)
    return (y, inv) if with_inv else y


def bn_grad_sums_plain(x, dy, mean, inv):
    """Plain version of `bn_grad_sums`: each channel's Σdy and Σdy·x̂, f32,
    x̂ = (x − mean)·inv (`_bn_train_bwd`'s dβ and dγ)."""
    dy = dy.float()
    x_hat = (x.float() - mean.view(_NCHW)) * inv.view(_NCHW)
    return dy.sum(dim=(0, 2, 3)), (dy * x_hat).sum(dim=(0, 2, 3))


def bn_grad_dx_plain(x, dy, mean, inv, weight, sum_dy=None, sum_dy_xhat=None, n: int = 1):
    """Plain version of `bn_grad_dx`: the closed form
    dx = γ·inv·(dy − Σdy/n − x̂·Σdy·x̂/n) in x's dtype; without the sums (the
    statistics held constant) dx = γ·inv·dy."""
    dy = dy.float()
    scale = (weight * inv).view(_NCHW)
    if sum_dy is None:
        return (scale * dy).to(x.dtype)
    x_hat = (x.float() - mean.view(_NCHW)) * inv.view(_NCHW)
    dx = scale * (dy - (sum_dy / n).view(_NCHW) - x_hat * (sum_dy_xhat / n).view(_NCHW))
    return dx.to(x.dtype)


class BNPlan(NamedTuple):
    blocks: int  # blocks per channel: grid (blocks, C)
    span: int    # values of the channel's N*H*W each block takes


def bn_pass_plan(n: int, c: int, hw: int, itemsize: int) -> BNPlan:
    """Launch geometry of the BatchNorm passes on an NCHW tensor: block r of
    a channel takes the values [r*span, (r+1)*span) of its N planes laid end
    to end; about BN_TARGET_BLOCKS blocks in all, none taking less than
    BN_MIN_BLOCK_BYTES where the channel has more, every block at least one
    value, together covering the channel once."""
    m = n * hw
    blocks = max(1, min(_cdiv(BN_TARGET_BLOCKS, c), m * itemsize // BN_MIN_BLOCK_BYTES))
    span = _cdiv(_cdiv(m, blocks), K2_SPAN_ALIGN) * K2_SPAN_ALIGN
    return BNPlan(_cdiv(m, span), span)


def bn_cl_plan(m: int) -> BNPlan:
    """The reduction's geometry on a channels_last tensor of m = N*H*W rows:
    `blocks` chunks of `span` rows, each by BN_CL_CHANNELS channels."""
    return BNPlan(_cdiv(m, BN_CL_ROWS), BN_CL_ROWS)


def bn_flat_blocks(total: int) -> int:
    """Blocks of the channels_last elementwise passes, which walk the tensor
    flat: one value a thread, at most BN_TARGET_BLOCKS blocks (they loop)."""
    return max(1, min(BN_TARGET_BLOCKS, _cdiv(total, BN_THREADS)))


_bn = None


def _bn_lib():
    global _bn
    if _bn is None:
        lib = build.load("bn_norm")
        v, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.onda_bn_apply.argtypes = [v, v, i, i, i, i, ll, i, ll, v, v, v, v, f, v, v, v, f, f, f, v]
        lib.onda_bn_grad_sums.argtypes = [v, v, i, i, i, i, ll, i, ll, v, v, v, v, v, v, v]
        lib.onda_bn_grad_dx.argtypes = [v, v, v, i, i, i, i, ll, i, ll, v, v, v, v, v, f, v]
        for fn in (lib.onda_bn_apply, lib.onda_bn_grad_sums, lib.onda_bn_grad_dx):
            fn.restype = i
        _bn = lib
    return _bn


def _bn_geometry(x, name):
    """(is_bf16, channels_last, N, C, H*W, plan) of a BatchNorm pass on x."""
    if x.dim() != 4:
        raise ValueError(f"{name}: expected a 4-D tensor, got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: expected float32 or bfloat16, got {x.dtype}")
    n, c, h, w = x.shape
    if x.is_contiguous():
        return x.dtype == torch.bfloat16, 0, n, c, h * w, bn_pass_plan(n, c, h * w, x.element_size())
    if x.is_contiguous(memory_format=torch.channels_last):
        return x.dtype == torch.bfloat16, 1, n, c, h * w, bn_cl_plan(n * h * w)
    raise ValueError(f"{name}: x must be NCHW-contiguous or channels_last")


def _bn_vectors(name, c, **vectors):
    for key, t in vectors.items():
        if t is not None:
            _require(t, f"{name}: {key}", torch.float32, (c,))


def _same_layout(name, x, cl, other, what):
    fmt = torch.channels_last if cl else torch.contiguous_format
    if (other.dtype != x.dtype or other.shape != x.shape
            or not other.is_contiguous(memory_format=fmt)):
        raise ValueError(f"{name}: {what} must match x in dtype, shape and layout")


def bn_apply(x, mean, var, weight, bias, eps: float, running=None, with_inv=False):
    """y = (x − mean)·(γ·rsqrt(var + eps)) + β, computed in f32 and written
    in x's dtype and layout, in one launch (`bn_apply_kernel`) on an
    (N, C, H, W) f32 or bf16 tensor, NCHW-contiguous or channels_last; mean,
    var, γ, β (C,) f32. `running` (running_mean, running_var, momentum, n)
    updates the running statistics in place in the same launch (n: the
    pixels of the unbiased variance). With `with_inv` returns (y, inv),
    inv = rsqrt(var + eps)."""
    if _on_cpu(x, mean, var, weight, bias):
        return bn_apply_plain(x, mean, var, weight, bias, eps, running, with_inv)
    name = "bn_apply_kernel"
    is_bf16, cl, n, c, hw, plan = _bn_geometry(x, name)
    _bn_vectors(name, c, mean=mean, var=var, weight=weight, bias=bias)
    y = torch.empty_like(x)
    inv = torch.empty_like(mean) if with_inv else None
    rm = rv = None
    keep = mom = unbias = 0.0
    if running is not None:
        rm, rv, mom, count = running
        _bn_vectors(name, c, running_mean=rm, running_var=rv)
        keep, unbias = 1 - mom, count / max(count - 1, 1)
    blocks = bn_flat_blocks(x.numel()) if cl else plan.blocks
    rc = _bn_lib().onda_bn_apply(
        x.data_ptr(), y.data_ptr(), is_bf16, cl, n, c, hw, blocks, plan.span, mean.data_ptr(),
        var.data_ptr(), weight.data_ptr(), bias.data_ptr(), eps,
        None if inv is None else inv.data_ptr(), None if rm is None else rm.data_ptr(),
        None if rv is None else rv.data_ptr(), keep, mom, unbias, _stream())
    _check(rc, name)
    bn_launches[name] += 1
    return (y, inv) if with_inv else y


_arrivals: dict = {}


def _arrival_counts(x, stream, slots: int) -> torch.Tensor:
    """Zeroed int32 counters, one a channel (or group of channels), kept per
    device and stream: the reduction leaves them zeroed, so one buffer serves
    every call on its stream."""
    key = (x.device, stream.value)
    buf = _arrivals.get(key)
    if buf is None or buf.numel() < slots:
        buf = _arrivals[key] = torch.zeros(max(slots, 4096), dtype=torch.int32, device=x.device)
    return buf


def bn_grad_sums(x, dy, mean, inv):
    """Each channel's (Σdy, Σdy·x̂), both (C,) f32, x̂ = (x − mean)·inv: the
    BatchNorm backward's dβ and dγ, in one launch (`bn_grad_sums_kernel`)
    reading x and dy once; dy in x's dtype, shape and layout."""
    if _on_cpu(x, dy, mean, inv):
        return bn_grad_sums_plain(x, dy, mean, inv)
    name = "bn_grad_sums_kernel"
    is_bf16, cl, n, c, hw, plan = _bn_geometry(x, name)
    _same_layout(name, x, cl, dy, "dy")
    _bn_vectors(name, c, mean=mean, inv=inv)
    slots = _cdiv(c, BN_CL_CHANNELS) * BN_CL_CHANNELS if cl else c
    partial = (torch.empty(2 * slots * plan.blocks, dtype=torch.float64, device=x.device)
               if plan.blocks > 1 else None)
    stream = _stream()
    counts = _arrival_counts(x, stream, _cdiv(c, BN_CL_CHANNELS) if cl else c)
    sum_dy = torch.empty_like(mean)
    sum_dy_xhat = torch.empty_like(mean)
    rc = _bn_lib().onda_bn_grad_sums(
        x.data_ptr(), dy.data_ptr(), is_bf16, cl, n, c, hw, plan.blocks, plan.span,
        mean.data_ptr(), inv.data_ptr(), None if partial is None else partial.data_ptr(),
        counts.data_ptr(), sum_dy.data_ptr(), sum_dy_xhat.data_ptr(), stream)
    _check(rc, name)
    bn_launches[name] += 1
    return sum_dy, sum_dy_xhat


def bn_grad_dx(x, dy, mean, inv, weight, sum_dy=None, sum_dy_xhat=None, n: int = 1):
    """The BatchNorm input gradient γ·inv·(dy − Σdy/n − x̂·Σdy·x̂/n) in x's
    dtype and layout, in one launch (`bn_grad_dx_kernel`); without the sums
    (the statistics held constant, eval mode) γ·inv·dy."""
    if _on_cpu(x, dy, mean, inv, weight, sum_dy, sum_dy_xhat):
        return bn_grad_dx_plain(x, dy, mean, inv, weight, sum_dy, sum_dy_xhat, n)
    name = "bn_grad_dx_kernel"
    is_bf16, cl, nb, c, hw, plan = _bn_geometry(x, name)
    _same_layout(name, x, cl, dy, "dy")
    _bn_vectors(name, c, mean=mean, inv=inv, weight=weight, sum_dy=sum_dy,
                sum_dy_xhat=sum_dy_xhat)
    if (sum_dy is None) != (sum_dy_xhat is None):
        raise ValueError(f"{name}: give both sums or neither")
    dx = torch.empty_like(x)
    blocks = bn_flat_blocks(x.numel()) if cl else plan.blocks
    rc = _bn_lib().onda_bn_grad_dx(
        x.data_ptr(), dy.data_ptr(), dx.data_ptr(), is_bf16, cl, nb, c, hw, blocks, plan.span,
        mean.data_ptr(), inv.data_ptr(), weight.data_ptr(),
        None if sum_dy is None else sum_dy.data_ptr(),
        None if sum_dy_xhat is None else sum_dy_xhat.data_ptr(), float(n), _stream())
    _check(rc, name)
    bn_launches[name] += 1
    return dx
