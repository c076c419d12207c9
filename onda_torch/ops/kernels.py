"""Wrappers of the hand-written Hopper kernels K1 and K2, with their plain
versions and their launch plans.

* K1 `pseudo_labels` (csrc/pseudo_labels.cu) replaces the Pallas kernel
  `onda_tpu/ops/pallas_kernels.py::fused_pseudo_labels`.
* K2 `bn_stats` (csrc/bn_stats.cu) replaces the Pallas kernel
  `onda_tpu/ops/pallas_kernels.py::bn_batch_stats`.

A wrapper takes its plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel or raises: it checks device, dtype, shape,
contiguity and alignment, allocates the outputs with `torch.empty`, launches
on the current stream and raises when the launch returns a CUDA error.
`launches` counts the kernel launches of each wrapper (never the plain
version). K2's launch geometry is computed here, in `bn_stats_plan`, so that
the CPU tests can check that it covers every element once; K1 sizes its
persistent grid itself, from the card's occupancy.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build
from . import prototypes as P

launches = {"pseudo_labels_kernel": 0, "bn_stats_kernel": 0}

K1_MAX_CLASSES = 32        # csrc/pseudo_labels.cu: kMaxC
# K2 (csrc/bn_stats.cu): 256-thread blocks; about 512 of them (4 on each of
# 132 SMs; 1024 and 3072 were slower on an H100, 256 no faster) but none
# reading less than 32 KB; clusters of at most 8
K2_THREADS, K2_TARGET_BLOCKS, K2_MIN_BLOCK_BYTES, K2_MAX_CLUSTER = 256, 512, 32 * 1024, 8
K2_SPAN_ALIGN = 8          # elements: 16 bytes of bf16
K2_CL_ROWS = 1024          # channels_last: rows per block


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _on_cpu(*tensors) -> bool:
    devices = {t.device.type for t in tensors if t is not None}
    if devices == {"cpu"}:
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
        lib.onda_bn_stats_nchw.argtypes = [v, i, i, i, ll, i, ll, v, v, v]
        lib.onda_bn_stats_nchw.restype = i
        lib.onda_bn_stats_cl.argtypes = [v, i, ll, i, ll, i, v, v, v, v]
        lib.onda_bn_stats_cl.restype = i
    return lib


def bn_stats(x: torch.Tensor):
    """K2. Per-channel (mean, biased var), both (C,) f32, of an (N, C, H, W)
    f32 or bf16 tensor, NCHW-contiguous (one launch) or channels_last."""
    if _on_cpu(x):
        return bn_stats_plain(x)
    if x.dim() != 4:
        raise ValueError(f"bn_stats_kernel: expected a 4-D tensor, got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"bn_stats_kernel: expected float32 or bfloat16, got {x.dtype}")
    n, c, h, w = x.shape
    is_bf16 = int(x.dtype == torch.bfloat16)
    mean = torch.empty((c,), dtype=torch.float32, device=x.device)
    var = torch.empty((c,), dtype=torch.float32, device=x.device)
    if x.is_contiguous():
        plan = bn_stats_plan(n, c, h * w, x.element_size())
        rc = _k2_lib().onda_bn_stats_nchw(_ptr(x), is_bf16, n, c, h * w, plan.cluster, plan.span,
                                          _ptr(mean), _ptr(var), _stream())
    elif x.is_contiguous(memory_format=torch.channels_last):
        nchunks = _cdiv(n * h * w, K2_CL_ROWS)
        partial = torch.empty((2, c, nchunks), dtype=torch.float32, device=x.device)
        rc = _k2_lib().onda_bn_stats_cl(_ptr(x), is_bf16, n * h * w, c, K2_CL_ROWS, nchunks,
                                        _ptr(partial), _ptr(mean), _ptr(var), _stream())
    else:
        raise ValueError("bn_stats_kernel: x must be NCHW-contiguous or channels_last")
    _check(rc, "bn_stats_kernel")
    launches["bn_stats_kernel"] += 1
    return mean, var
