#!/usr/bin/env python3
"""Smoke test of the onda_torch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py                # every phase; needs one CUDA card
    python3 chip_smoke.py --skip-main    # kernel phases only
    python3 chip_smoke.py --profile      # also write a profiler table of one step
    python3 chip_smoke.py --compare DIR  # also time an earlier onda_torch package's
                                         # K1 and K2 (DIR/onda_torch, e.g. unpacked
                                         # from a parent commit with git archive)
                                         # against this tree's, in turns, under
                                         # three timers (TIMERS): this script's
                                         # and the first port's, on which the
                                         # earlier records were taken

Phases:
 1. card name and power limit; the TF32 settings of each phase;
 2. build the CUDA kernels of onda_torch/csrc (one nvcc per source, in parallel);
 3. K1 (pseudo_labels_kernel) against its plain version at the main path's
    shape (P = 4*65*129, F = 256, C = 19), euclidean and mahalanobis, and at
    C = 1, C = 32 and P = 700 and 1 (not multiples of its 128-pixel tile);
 4. K2 (bn_stats_kernel) against a float64 reference at every distinct
    BatchNorm input shape of DeepLabv2-R50 at batch 4, 1024x512 and at
    adversarial shapes (odd planes, one element, planes that start at an odd
    element), f32 and bf16, NCHW and channels_last, each call repeated to show
    that the result is the same bit for bit; the BatchNorm autograd.Function's
    gradients against autograd of the plain version;
 5. a small-input check: one bootstrap and one adaptation step of a tiny model
    on the card against the same on the CPU (plain versions of both kernels);
 6. the main path at full size: configs/hybrid_switch.yml (R50 ProDA head,
    batch 4, 1024x512, f32) with seeded random weights and in-memory seeded
    data: calculate_prototypes, train() for one epoch, evaluate_all; launch
    counters read around each part; one more step must sync the host exactly
    once (the dynamic teacher's gate).

Kernel times are device times: the device is held busy (`torch.cuda._sleep`)
while the host queues the timed calls, so the host's time to queue a launch
does not count, and each call finds a cold L2. Each timing line gives the
share of the bound (bound ms / ms).

Prints the card line and one JSON line of kernel results, then as the last line
{"ok": true, "device": {...}}. Any failure exits non-zero before that line.
Writes the per-shape K2 table (and the profile, and the comparison) under
--out-dir (default build/chip_smoke/).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores
MAIN_STEPS = 6              # one epoch; the median step skips the first and the last


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, flops: float = 0.0):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def cuda_ms(torch, fn, iters=10, warmup=2, queue_ahead=True, flush="read"):
    """Mean device time of fn, each call after a pass over 128 MB that evicts
    the 50 MB L2 (the main path finds its inputs cold). `flush="read"` reads
    the 128 MB, leaving the L2 clean; "write" zeroes them, and then every
    timed call also pays to write back the dirty lines it evicts. With `queue_ahead` the device sleeps while the host
    queues every call, so that the time between the events is the device's
    alone; the sleep grows until it outlasts the queueing. Without it, a
    call's time includes whatever the device waited for the host to queue it."""
    buf = torch.ones(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    evict = {"read": buf.sum, "write": buf.zero_}[flush]
    for _ in range(warmup):
        fn()
    cycles = 20_000_000
    for _ in range(5):
        torch.cuda.synchronize()
        if queue_ahead:
            torch.cuda._sleep(cycles)
        slept = torch.cuda.Event()
        slept.record()
        events = []
        for _ in range(iters):
            evict()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        caught_up = slept.query()  # the sleep ended before the last call was queued
        torch.cuda.synchronize()
        if not (queue_ahead and caught_up):
            return sum(s.elapsed_time(e) for s, e in events) / iters
        cycles *= 4
    raise SmokeFailure("the device outran the host at every sleep: does the timed call sync?")


def share(bound, ms):
    return bound / ms if ms > 0 else float("nan")


# ---------------------------------------------------------------------------
# phase 3: K1
# ---------------------------------------------------------------------------


def k1_inputs(torch, n_pix, n_feat, n_cls, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    protos = 0.3 * torch.randn(n_cls, n_feat, device="cuda", generator=g)
    cls = torch.randint(0, n_cls, (n_pix,), device="cuda", generator=g)
    feat = protos[cls] + 0.5 * torch.randn(n_pix, n_feat, device="cuda", generator=g)
    prior = torch.rand(n_pix, n_cls, device="cuda", generator=g) + 0.05
    prior = (prior / prior.sum(-1, keepdim=True)).contiguous()
    scale = 0.5 + 1.5 * torch.rand(n_feat, device="cuda", generator=g)
    return feat, protos, prior, scale


def check_k1(torch, K, P):
    main = (4 * 65 * 129, 256, 19)
    thresh, tau = 0.3, torch.tensor(1.0, device="cuda")
    # the main path's shape, then C = 1 and 32 and P off the 128-pixel tile
    cases = [main, (main[0], 256, 1), (main[0], 256, 32), (700, 256, 19), (1, 256, 19)]
    max_err = 0.0
    for n_pix, n_feat, n_cls in cases:
        feat, protos, prior, scale = k1_inputs(torch, n_pix, n_feat, n_cls, 1)
        for metric, sc in (("euclidean", None), ("mahalanobis", scale)):
            soft, hard, pmax = K.pseudo_labels(feat, protos, prior, tau, thresh, sc)
            torch.cuda.synchronize()
            w_soft, w_hard, w_pmax = P.pseudo_labels_plain(feat, protos, prior, tau, thresh, sc)
            err = (soft - w_soft).abs().max().item()
            ok = torch.allclose(soft, w_soft, rtol=1e-4, atol=1e-5)
            agree = (hard == w_hard).float().mean().item()
            pmax_ok = torch.allclose(pmax, w_pmax, rtol=1e-4, atol=1e-5)
            print(f"K1 P={n_pix} F={n_feat} C={n_cls} {metric}: soft max_abs_err {err:.3e} "
                  f"(rtol 1e-4, atol 1e-5: {ok}); hard agreement {agree:.6f}; prop_max ok "
                  f"{pmax_ok}; pseudo-labelled pixels {(hard != 255).float().mean().item():.3f}")
            tag = f"K1 P={n_pix} C={n_cls} {metric}"
            check(ok, f"{tag}: soft labels disagree with the plain version (max err {err})")
            check(agree > 0.999, f"{tag}: hard-label agreement {agree} <= 0.999")
            check(pmax_ok, f"{tag}: prop_max disagrees with the plain version")
            if (n_pix, n_feat, n_cls) == main:
                max_err = max(max_err, err)
    n_pix, n_feat, n_cls = main
    feat, protos, prior, scale = k1_inputs(torch, n_pix, n_feat, n_cls, 1)
    ms = cuda_ms(torch, lambda: K.pseudo_labels(feat, protos, prior, tau, thresh, scale))
    plain = cuda_ms(torch, lambda: P.pseudo_labels_plain(feat, protos, prior, tau, thresh, scale))
    read = cuda_ms(torch, lambda: feat.sum())  # a yardstick: one plain read of the features
    one = k1_inputs(torch, 1, n_feat, n_cls, 1)  # one pixel, one tile: the fixed cost of a call
    ms_one = cuda_ms(torch, lambda: K.pseudo_labels(one[0], one[1], one[2], tau, thresh, one[3]))
    nbytes = 4 * (n_pix * n_feat + n_cls * n_feat + 2 * n_pix * n_cls + n_feat + 1 + 2 * n_pix)
    b_ms, b_by = bound_ms(nbytes, 2.0 * n_pix * n_cls * n_feat + n_pix * n_feat)
    print(f"K1 timing (mahalanobis, cold L2): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB), "
          f"{100 * share(b_ms, ms):.1f}% of the bound; feat.sum() alone {read:.4f} ms; "
          f"K1 at P=1 {ms_one:.4f} ms")
    return {"name": "pseudo_labels_kernel", "route": "cuda",
            "source": "onda_torch/csrc/pseudo_labels.cu",
            "replaces": "onda_tpu/ops/pallas_kernels.py:59",
            "shape": f"P={n_pix} F={n_feat} C={n_cls} f32, mahalanobis",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "bound_share": share(b_ms, ms),
            "library_ms": None, "check": "pass"}


# ---------------------------------------------------------------------------
# phase 4: K2
# ---------------------------------------------------------------------------


def bn_input_shapes(torch, batch=4, hw=(512, 1024)):
    """Input shape of every BatchNorm call of one R50 forward (meta tensors)."""
    from onda_torch.models import build_deeplab_v2
    from onda_torch.models.layers import TorchBatchNorm

    with torch.device("meta"):
        model = build_deeplab_v2(19, (3, 4, 6, 3), "ProDA")
    shapes = []
    for mod in model.modules():
        if isinstance(mod, TorchBatchNorm):
            mod.register_forward_pre_hook(lambda m, args: shapes.append(tuple(args[0].shape)))
    model(torch.empty(batch, 3, *hw, device="meta"))
    return shapes


K2_ODD_SHAPES = [(1, 1, 1, 1), (2, 3, 5, 7), (3, 17, 32, 24), (1, 2048, 65, 129)]


def k2_layouts(torch, x):
    """x as K2 meets it: NCHW and channels_last, each also starting one
    element past a 16-byte boundary (a contiguous view at storage offset 1)."""
    n, c, h, w = x.shape
    out = {"nchw": x, "channels_last": x.contiguous(memory_format=torch.channels_last)}
    for name, dims, perm in (("nchw+1", (n, c, h, w), (0, 1, 2, 3)),
                             ("channels_last+1", (n, h, w, c), (0, 3, 1, 2))):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        view = buf[1:].view(dims).permute(perm)
        view.copy_(x)
        out[name] = view
    return out


def check_k2_once(torch, K, x, tag):
    """K2 on x in every layout against float64, and twice to the same bits.
    Returns (max mean error, max var error) of the NCHW call."""
    x64 = x.double()
    ref_mean = x64.mean(dim=(0, 2, 3))
    ref_var = x64.var(dim=(0, 2, 3), unbiased=False)
    amax = x64.abs().max().item()
    flat = ref_var == 0  # one value per channel: only the f32 rounding of x² is left
    result = None
    for layout, xl in k2_layouts(torch, x).items():
        mean, var = K.bn_stats(xl)
        mean2, var2 = K.bn_stats(xl)
        torch.cuda.synchronize()
        check(torch.equal(mean, mean2) and torch.equal(var, var2),
              f"K2 {tag} {layout}: two calls differ (not deterministic)")
        e_mean = (mean.double() - ref_mean).abs().max().item()
        d_var = (var.double() - ref_var).abs()
        e_var = (d_var / ref_var.abs().clamp(min=1e-30))[~flat].max().item() if (~flat).any() else 0.0
        e_flat = d_var[flat].max().item() if flat.any() else 0.0
        # mean: f32 partial sums of at most a few hundred values per thread,
        # folded in f64, so its error is a few f32 ulps of max|x|; var:
        # E[x²] − E[x]² with |E[x]| up to ~3 std leaves a relative error well
        # under 1e-4
        ok = e_mean <= 1e-6 * amax and e_var <= 1e-4 and e_flat <= 1e-6 * amax**2
        check(ok, f"K2 {tag} {layout}: mean err {e_mean:.3e} (limit {1e-6 * amax:.3e}), var rel "
                  f"err {e_var:.3e} (limit 1e-4), zero-var err {e_flat:.3e}")
        if layout == "nchw":
            result = (e_mean, e_var, (var.double() - ref_var).abs().max().item())
    return result


def check_k2(torch, K, layers, out_dir):
    shapes = bn_input_shapes(torch)
    check(len(shapes) == 53, f"expected 53 BatchNorm calls in R50, got {len(shapes)}")
    distinct = sorted(set(shapes), key=lambda s: -math.prod(s))
    g = torch.Generator(device="cuda").manual_seed(2)
    rows, max_err = [], 0.0
    per_shape = {}
    for shape in distinct + K2_ODD_SHAPES:
        c = shape[1]
        offset = torch.randn(1, c, 1, 1, device="cuda", generator=g)
        spread = 0.5 + torch.rand(1, c, 1, 1, device="cuda", generator=g)
        base = torch.randn(shape, device="cuda", generator=g) * spread + offset
        for dtype in (torch.float32, torch.bfloat16):
            x = base.to(dtype)
            e_mean, e_var, e_var_abs = check_k2_once(torch, K, x, f"{shape} {dtype}")
            rows.append({"shape": shape, "dtype": str(dtype), "mean_abs_err": e_mean,
                         "var_rel_err": e_var})
            if shape not in distinct:
                continue
            if dtype == torch.float32:
                max_err = max(max_err, e_mean, e_var_abs)
            # time the layout the main path uses (NCHW)
            ms = cuda_ms(torch, lambda: K.bn_stats(x))
            plain = cuda_ms(torch, lambda: K.bn_stats_plain(x))
            lib = cuda_ms(torch, lambda: torch.var_mean(x, dim=(0, 2, 3), unbiased=False))
            nbytes = x.numel() * x.element_size() + 2 * c * 4
            b_ms, b_by = bound_ms(nbytes, 3.0 * x.numel())
            per_shape[(shape, str(dtype))] = (ms, plain, lib, b_ms)
            print(f"K2 {shape} {str(dtype)[6:]}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                  f"torch.var_mean {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
                  f"{nbytes / 1e6:.1f} MB), {100 * share(b_ms, ms):.1f}% of the bound")
            del x
        del base
    print(f"K2 checked at {len(rows)} shape/type pairs, 4 layouts each, against float64; "
          f"every call repeated gave the same bits")
    slower = [k for k, v in per_shape.items() if v[0] > v[2]]
    print(f"K2 slower than torch.var_mean at {len(slower)} of {len(per_shape)} shape/type "
          f"pairs: {slower}")
    # one forward's 53 BN inputs (f32), summed with multiplicity
    tot = [sum(per_shape[(s, "torch.float32")][i] for s in shapes) for i in range(4)]
    print(f"K2 over the 53 BN inputs of one R50 forward (f32): kernel {tot[0]:.4f} ms, "
          f"plain {tot[1]:.4f} ms, torch.var_mean {tot[2]:.4f} ms, bound {tot[3]:.4f} ms, "
          f"{100 * share(tot[3], tot[0]):.1f}% of the bound")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "k2_shapes.json"), "w") as f:
        json.dump({"checks": rows, "timings": [
            {"shape": s, "dtype": d, "ms": v[0], "plain_ms": v[1], "library_ms": v[2],
             "bound_ms": v[3]} for (s, d), v in per_shape.items()]}, f, indent=1)

    # the BatchNorm autograd.Function against autograd of the plain version
    shape = (4, 64, 129, 257)
    x = torch.randn(shape, device="cuda", generator=g) + 0.3
    w = 1.0 + 0.1 * torch.randn(shape[1], device="cuda", generator=g)
    b = 0.1 * torch.randn(shape[1], device="cuda", generator=g)
    dy = torch.randn(shape, device="cuda", generator=g)
    xs, ws, bs = (t.clone().requires_grad_(True) for t in (x, w, b))
    y, _, _ = layers.bn_train(xs, ws, bs, 1e-5)
    (y * dy).sum().backward()
    x64, w64, b64 = (t.double().requires_grad_(True) for t in (x, w, b))
    mean = x64.mean(dim=(0, 2, 3), keepdim=True)
    var = torch.clamp((x64 * x64).mean(dim=(0, 2, 3), keepdim=True) - mean * mean, min=0)
    y64 = (x64 - mean) * torch.rsqrt(var + 1e-5) * w64.view(1, -1, 1, 1) + b64.view(1, -1, 1, 1)
    (y64 * dy.double()).sum().backward()
    for name, got, want in (("dx", xs.grad, x64.grad), ("dgamma", ws.grad, w64.grad),
                            ("dbeta", bs.grad, b64.grad)):
        err = (got.double() - want).abs().max().item() / want.abs().max().item()
        print(f"BN backward {name}: max error / max|ref| = {err:.3e}")
        # f32 sums over 132,612 values per channel: relative error ~1e-6..1e-5
        check(err < 1e-4, f"BN backward {name} disagrees with autograd (rel err {err})")
    return {"name": "bn_stats_kernel", "route": "cuda", "source": "onda_torch/csrc/bn_stats.cu",
            "replaces": "onda_tpu/ops/pallas_kernels.py:146",
            "shape": "the 53 BatchNorm inputs of one R50 forward, b4 1024x512 f32 NCHW (times summed)",
            "max_abs_err": max_err, "ms": tot[0], "plain_ms": tot[1], "bound_ms": tot[3],
            "bound_by": "bytes", "bound_share": share(tot[3], tot[0]), "library_ms": tot[2],
            "check": "pass"}


# ---------------------------------------------------------------------------
# --compare: an earlier package's kernels against this tree's, in turns
# ---------------------------------------------------------------------------


def load_earlier_kernels(path):
    """The `ops.kernels` module of the onda_torch package at path/onda_torch,
    imported as `onda_torch_earlier`; its kernels build under path/build."""
    import importlib
    import importlib.util

    pkg = os.path.join(os.path.abspath(path), "onda_torch")
    check(os.path.isfile(os.path.join(pkg, "ops", "kernels.py")), f"no onda_torch package in {path}")
    spec = importlib.util.spec_from_file_location(
        "onda_torch_earlier", os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules["onda_torch_earlier"] = module
    spec.loader.exec_module(module)
    return importlib.import_module("onda_torch_earlier.ops.kernels")


TIMERS = {"device": dict(),                                    # this script's timer
          "write_flush": dict(flush="write"),                   # device time, L2 left dirty
          "host_queued": dict(flush="write", queue_ahead=False)}  # and the host's queueing counted


def compare_earlier(torch, K, path, out_dir):
    """Time the earlier K1 and K2 against this tree's on the same inputs, in
    turns (earlier, this, this, earlier), with each of TIMERS."""
    old = load_earlier_kernels(path)
    t = time.perf_counter()
    old.build.build_all()
    print(f"earlier kernels from {path}: build {time.perf_counter() - t:.3f} s")
    rows = []

    def turns(name, shape, f_old, f_new, b_ms):
        row = {"kernel": name, "shape": shape, "bound_ms": b_ms}
        for key, opts in TIMERS.items():
            ms = [cuda_ms(torch, f, **opts) for f in (f_old, f_new, f_new, f_old)]
            row[key] = {"earlier_ms": (ms[0] + ms[3]) / 2, "ms": (ms[1] + ms[2]) / 2, "turns": ms}
        d = row["device"]
        print(f"compare {name} {shape}: earlier {d['earlier_ms']:.4f} ms, this {d['ms']:.4f} ms "
              f"(turns {', '.join(f'{v:.4f}' for v in d['turns'])}); bound {b_ms:.4f} ms, "
              f"{100 * share(b_ms, d['earlier_ms']):.1f}% -> {100 * share(b_ms, d['ms']):.1f}%; " +
              "; ".join(f"{key}: earlier {row[key]['earlier_ms']:.4f}, this {row[key]['ms']:.4f} ms"
                        for key in TIMERS if key != "device"))
        rows.append(row)
        return row

    n_pix, n_feat, n_cls = 4 * 65 * 129, 256, 19
    feat, protos, prior, scale = k1_inputs(torch, n_pix, n_feat, n_cls, 1)
    tau = torch.tensor(1.0, device="cuda")
    nbytes = 4 * (n_pix * n_feat + n_cls * n_feat + 2 * n_pix * n_cls + n_feat + 1 + 2 * n_pix)
    turns("pseudo_labels_kernel", f"P={n_pix} F={n_feat} C={n_cls} mahalanobis",
          lambda: old.pseudo_labels(feat, protos, prior, tau, 0.3, scale),
          lambda: K.pseudo_labels(feat, protos, prior, tau, 0.3, scale),
          bound_ms(nbytes, 2.0 * n_pix * n_cls * n_feat + n_pix * n_feat)[0])
    del feat, protos, prior

    shapes = bn_input_shapes(torch)
    g = torch.Generator(device="cuda").manual_seed(3)
    per = {}
    for shape in sorted(set(shapes), key=lambda s: -math.prod(s)):
        base = torch.randn(shape, device="cuda", generator=g) + 0.5
        for dtype in (torch.float32, torch.bfloat16):
            x = base.to(dtype)
            b_ms = bound_ms(x.numel() * x.element_size() + 8 * shape[1], 3.0 * x.numel())[0]
            per[(shape, dtype)] = turns("bn_stats_kernel", f"{shape} {str(dtype)[6:]}",
                                        lambda: old.bn_stats(x), lambda: K.bn_stats(x), b_ms)
            del x
        del base
    total = {key: {k: sum(per[(s, torch.float32)][key][k] for s in shapes)
                   for k in ("earlier_ms", "ms")} for key in TIMERS}
    bound = sum(per[(s, torch.float32)]["bound_ms"] for s in shapes)
    d = total["device"]
    print(f"compare bn_stats_kernel over the 53 BN inputs of one R50 forward (f32): earlier "
          f"{d['earlier_ms']:.4f} ms, this {d['ms']:.4f} ms, bound {bound:.4f} ms "
          f"({100 * share(bound, d['earlier_ms']):.1f}% -> {100 * share(bound, d['ms']):.1f}%); " +
          "; ".join(f"{key}: earlier {total[key]['earlier_ms']:.4f}, this {total[key]['ms']:.4f} ms"
                    for key in TIMERS if key != "device"))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "compare.json"), "w") as f:
        json.dump({"earlier": os.path.abspath(path), "rows": rows,
                   "bn_stats_forward_f32": dict(total, bound_ms=bound)}, f, indent=1)


# ---------------------------------------------------------------------------
# phases 5-6: adapter runs
# ---------------------------------------------------------------------------


class StepLogger:
    """Reads every log dict (the packed device-to-host copy) and stamps it."""

    def __init__(self):
        self.entries = []

    def log(self, metrics):
        values = dict(metrics.items())
        self.entries.append((time.perf_counter(), values))


def make_adapter(torch, device, hw, batch, layers=(3, 4, 6, 3), droprate=None, logger=None):
    from onda_torch import registry
    from onda_torch.config import Config, cfg_from_file
    from onda_torch.models import build_deeplab_v2

    cfg = cfg_from_file(os.path.join(HERE, "configs", "hybrid_switch.yml"))
    cfg.SCHEME.RESOLUTION = [hw[1], hw[0]]
    cfg.MODEL.LOAD = Config()
    cfg.OTHERS.GENERATE_SAMPLES_EVERY = 0
    cfg.OTHERS.SNAPSHOT_DIR = tempfile.mkdtemp(prefix="onda_smoke_")
    spec = cfg.METHOD.ADAPTATION[cfg.METHOD.ADAPTATION.NAME]
    spec.LOAD_PROTO = Config()
    spec.EPOCHS = 1
    spec.set_ = "smoke"
    if droprate is None:
        model, variables = registry.get_model(cfg, 19, device=device)
    else:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = build_deeplab_v2(19, layers, "ProDA", droprate=droprate)
        model = model.to(device)
        variables = registry.variables_of(model)
    adapter = registry.get_adapt_method(cfg)(model, variables, cfg, spec, 19, logger=logger,
                                             device=device)
    return adapter


def make_batches(torch, n, batch, hw, seed):
    g = torch.Generator().manual_seed(seed)
    h, w = hw
    out = []
    for _ in range(n):
        out.append({"image": torch.randn(batch, 3, h, w, generator=g),
                    "label": torch.randint(0, 19, (batch, h, w), generator=g),
                    "label_res": torch.randint(0, 19, (batch, h // 8 + 1, w // 8 + 1), generator=g)})
    return out


def small_input_check(torch):
    """Bootstrap + one step of a tiny model on the card vs the CPU."""
    hw, batch = (32, 64), 2
    src, trg = make_batches(torch, 1, batch, hw, 5), make_batches(torch, 1, batch, hw, 6)
    results = {}
    for device in ("cpu", "cuda"):
        ad = make_adapter(torch, device, hw, batch, layers=(1, 1, 1, 1), droprate=0.0)
        ad.calculate_prototypes(src)
        step = ad.step_fn(True, 1, False)
        dev = torch.device(device)
        state, logs = step(ad.state, trg[0]["image"].to(dev), src[0]["image"][None].to(dev),
                           src[0]["label_res"][None].to(dev), 1e-3)
        results[device] = (dict(logs.items()), state.params["layer6.head.1.weight"].cpu(),
                           state.proto.mean.cpu())
    (l_cpu, k_cpu, m_cpu), (l_gpu, k_gpu, m_gpu) = results["cpu"], results["cuda"]
    # the card's f32 convolutions and sums run in another order than the CPU's
    for key in ("ce_loss", "rce_loss", "regularization_loss", "buff_ce_loss", "Total target loss"):
        check(math.isclose(l_cpu[key], l_gpu[key], rel_tol=1e-3, abs_tol=1e-5),
              f"small input: {key} cpu {l_cpu[key]} vs cuda {l_gpu[key]}")
    check(abs(l_cpu["pseudolabel_pixel_num"] - l_gpu["pseudolabel_pixel_num"]) <= 2,
          "small input: pseudo-label counts differ")
    check(torch.allclose(k_cpu, k_gpu, rtol=1e-3, atol=1e-6), "small input: head kernels differ")
    check(torch.allclose(m_cpu, m_gpu, rtol=1e-3, atol=1e-5), "small input: prototypes differ")
    print(f"small input (R50 cut to 1 block per stage, 32x64, b2): Total target loss "
          f"cpu {l_cpu['Total target loss']:.6f} cuda {l_gpu['Total target loss']:.6f}; agree")


def main_path(torch, K, profile: bool, out_dir: str):
    hw, batch, steps = (512, 1024), 4, MAIN_STEPS
    logger = StepLogger()
    t0 = time.perf_counter()
    ad = make_adapter(torch, "cuda", hw, batch, logger=logger)
    check(int(ad.cfg.TRAINING.BATCH_SIZE) == batch, "hybrid_switch.yml no longer has batch 4")
    src = make_batches(torch, 2, batch, hw, 10)
    trg = make_batches(torch, steps, batch, hw, 11)
    val = make_batches(torch, 1, batch, hw, 12)
    torch.cuda.synchronize()
    print(f"main path set-up (model, state, data): {time.perf_counter() - t0:.3f} s")
    counts = {}

    K.reset_launches()
    ad.calculate_prototypes(src)
    torch.cuda.synchronize()
    boot = dict(K.launches)
    print(f"bootstrap ({len(src)} source batches): launches {boot}")
    check(boot == {"pseudo_labels_kernel": 0, "bn_stats_kernel": 53 * len(src)},
          f"bootstrap launches {boot}, expected 53 K2 per batch")
    ad.skip_proto = True

    K.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t_train = time.perf_counter()
    ad.train(src, trg, {"smoke": val})
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t_train
    trained = dict(K.launches)
    peak = torch.cuda.max_memory_allocated()
    print(f"train ({steps} steps, one epoch, incl. two evaluations and a checkpoint): "
          f"{t_train:.3f} s; launches {trained}")
    check(trained == {"pseudo_labels_kernel": 2 * steps, "bn_stats_kernel": 159 * steps},
          f"train launches {trained}, expected K1 2/step and K2 159/step")

    K.reset_launches()
    final = ad.evaluate_all({"smoke": val})
    torch.cuda.synchronize()
    evaluated = dict(K.launches)
    for phase in (boot, trained, evaluated):
        for k, v in phase.items():
            counts[k] = counts.get(k, 0) + v

    step_logs = [(t, l) for t, l in logger.entries if "Total target loss" in l]
    check(len(step_logs) == steps, f"{len(step_logs)} step logs for {steps} steps")
    for i, (_, logs) in enumerate(step_logs):
        for key, value in logs.items():
            if "loss" in key:
                check(math.isfinite(value), f"step {i}: {key} = {value}")
    times = [t for t, _ in logger.entries]
    first = times.index(step_logs[0][0])
    # step i ends at its log; step 0 pays warm-up and the last the epoch's
    # evaluation and checkpoint, so the median is over steps 1..n-2
    clean = [step_logs[i][0] - step_logs[i - 1][0] for i in range(1, steps - 1)]
    step_ms = 1e3 * statistics.median(clean)
    print(f"step ms (steps 1..{steps - 2}): " + ", ".join(f"{1e3 * c:.3f}" for c in clean))
    print(f"main path: median step {step_ms:.3f} ms, {batch / (step_ms / 1e3):.3f} frames/s, "
          f"step 0 {1e3 * (step_logs[0][0] - times[first - 1]):.3f} ms, "
          f"peak memory {peak / 2**30:.3f} GiB (max_memory_allocated)")
    last = step_logs[-1][1]
    print("last step logs: " + ", ".join(
        f"{k} {last[k]:.6g}" for k in ("Total target loss", "ce_loss", "rce_loss",
                                      "regularization_loss", "buff_ce_loss",
                                      "pseudolabel_pixel_num", "dynamic forward fired")))
    miou = final["Val mIoU model of smoke"]
    check(math.isfinite(miou), f"evaluate_all gave mIoU {miou}")
    print(f"evaluate_all: {final}")
    check(evaluated == {"pseudo_labels_kernel": 0, "bn_stats_kernel": 0},
          f"evaluation launched kernels {evaluated}")

    # the dynamic teacher's gate is the only host sync inside a step
    step = ad.step_fn(True, 1, False)
    img = trg[0]["image"].cuda()
    s_img, s_lbl = src[0]["image"][None].cuda(), src[0]["label_res"][None].cuda()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            ad.state, logs = step(ad.state, img, s_img, s_lbl, 1e-5)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    print(f"host syncs inside one step: {len(syncs)} {syncs}")
    check(len(syncs) == 1, f"expected one host sync (the dynamic-teacher gate), got {len(syncs)}")
    check(math.isfinite(logs["Total target loss"]), "extra step: non-finite loss")

    if profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as prof

        torch.cuda.synchronize()
        with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            t_prof = time.perf_counter()
            ad.state, logs = step(ad.state, img, s_img, s_lbl, 1e-5)
            logs["Total target loss"]
            torch.cuda.synchronize()
            t_prof = time.perf_counter() - t_prof
        events = p.key_averages()
        # device time: the kernel rows only (operator rows repeat their kernels' time)
        kernels = [e for e in events if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]

        def dev_us(e):
            return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

        busy = sum(dev_us(e) for e in kernels) / 1e3
        names = {"pseudo_labels_kernel": ("pseudo_labels_kernel",),
                 "bn_stats_kernel": ("bn_stats_cluster_kernel", "stats_cl_kernel",
                                     "finalize_kernel")}
        ours = {name: [e for e in kernels if any(k in e.key for k in keys)]
                for name, keys in names.items()}
        print(f"profiled step: wall {1e3 * t_prof:.3f} ms, device busy {busy:.3f} ms "
              f"({100 * busy / (1e3 * t_prof):.1f}%); " +
              ", ".join(f"{k} {sum(dev_us(e) for e in v) / 1e3:.3f} ms in "
                        f"{sum(e.count for e in v)} device launches" for k, v in ours.items()))
        k2_launches = sum(e.count for e in ours["bn_stats_kernel"])
        check(k2_launches == 159, f"K2 took {k2_launches} device launches in the profiled step, "
                                  f"expected one per call (159)")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "profile_step.txt"), "w") as f:
            f.write(events.table(sort_by="cuda_time_total", row_limit=80))
        print(f"profile of one step written to {out_dir}/profile_step.txt")
    return counts, {"step_ms": step_ms, "frames_per_s": batch / (step_ms / 1e3),
                    "peak_gib": peak / 2**30}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--skip-main", action="store_true", help="kernel phases only")
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--compare", metavar="DIR",
                        help="time the K1 and K2 of the onda_torch package in DIR against this tree's")
    parser.add_argument("--out-dir", default=os.path.join(HERE, "build", "chip_smoke"),
                        help="where the per-shape K2 table, the profile and the comparison go")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this script needs a CUDA card")
    check(os.path.isdir(os.path.join(HERE, "onda_torch")),
          "the onda_torch package is not beside chip_smoke.py")
    sys.path.insert(0, HERE)
    from onda_torch.models import layers
    from onda_torch.ops import build
    from onda_torch.ops import kernels as K
    from onda_torch.ops import prototypes as P

    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("kernel phases: cudnn.allow_tf32=False, cuda.matmul.allow_tf32=False")

    t = time.perf_counter()
    build.build_all(verbose=True)
    print(f"kernel build: {time.perf_counter() - t:.3f} s into {build.BUILD_DIR}")

    k1 = check_k1(torch, K, P)
    k2 = check_k2(torch, K, layers, args.out_dir)
    small_input_check(torch)
    if args.compare:
        compare_earlier(torch, K, args.compare, args.out_dir)
    counts, summary = {}, {}
    if not args.skip_main:
        torch.backends.cudnn.allow_tf32 = True
        print("main path: cudnn.allow_tf32=True (PyTorch's default: convolutions in TF32), "
              "cuda.matmul.allow_tf32=False")
        counts, summary = main_path(torch, K, args.profile, args.out_dir)
    k1["launches"] = counts.get("pseudo_labels_kernel", 0)
    k2["launches"] = counts.get("bn_stats_kernel", 0)
    print(f"main path summary: {json.dumps(summary)}")
    print(card)
    print(json.dumps({"kernels": [k1, k2]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
