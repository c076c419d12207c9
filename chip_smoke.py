#!/usr/bin/env python3
"""Smoke test of the onda_torch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py                # every phase; needs one CUDA card
    python3 chip_smoke.py --skip-main    # kernel phases only
    python3 chip_smoke.py --profile      # also write a profiler table of one step

Phases:
 1. card name and power limit; the TF32 settings of each phase;
 2. build the CUDA kernels of onda_torch/csrc (one nvcc per source, in parallel);
 3. K1 (pseudo_labels_kernel) against its plain version at the main path's
    shape (P = 4*65*129, F = 256, C = 19), euclidean and mahalanobis;
 4. K2 (bn_stats_kernel) against a float64 reference at every distinct
    BatchNorm input shape of DeepLabv2-R50 at batch 4, 1024x512, f32 and bf16,
    NCHW and channels_last; the BatchNorm autograd.Function's gradients
    against autograd of the plain version;
 5. a small-input check: one bootstrap and one adaptation step of a tiny model
    on the card against the same on the CPU (plain versions of both kernels);
 6. the main path at full size: configs/hybrid_switch.yml (R50 ProDA head,
    batch 4, 1024x512, f32) with seeded random weights and in-memory seeded
    data: calculate_prototypes, train() for one epoch, evaluate_all; launch
    counters read around each part; one more step must sync the host exactly
    once (the dynamic teacher's gate).

Prints the card line and one JSON line of kernel results, then as the last line
{"ok": true, "device": {...}}. Any failure exits non-zero before that line.
Writes the per-shape K2 table (and the profile) under --out-dir
(default build/chip_smoke/).
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


def cuda_ms(torch, fn, iters=10, warmup=2):
    """Mean device time of fn, each call after a write of 128 MB that
    evicts the 50 MB L2 (the main path finds its inputs cold)."""
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


# ---------------------------------------------------------------------------
# phase 3: K1
# ---------------------------------------------------------------------------


def check_k1(torch, K, P):
    n_pix, n_feat, n_cls, thresh = 4 * 65 * 129, 256, 19, 0.3
    g = torch.Generator(device="cuda").manual_seed(1)
    protos = 0.3 * torch.randn(n_cls, n_feat, device="cuda", generator=g)
    cls = torch.randint(0, n_cls, (n_pix,), device="cuda", generator=g)
    feat = protos[cls] + 0.5 * torch.randn(n_pix, n_feat, device="cuda", generator=g)
    prior = torch.rand(n_pix, n_cls, device="cuda", generator=g) + 0.05
    prior = (prior / prior.sum(-1, keepdim=True)).contiguous()
    scale = 0.5 + 1.5 * torch.rand(n_feat, device="cuda", generator=g)
    tau = torch.tensor(1.0, device="cuda")
    result = {}
    for metric, sc in (("euclidean", None), ("mahalanobis", scale)):
        soft, hard, pmax = K.pseudo_labels(feat, protos, prior, tau, thresh, sc)
        torch.cuda.synchronize()
        w_soft, w_hard, w_pmax = P.pseudo_labels_plain(feat, protos, prior, tau, thresh, sc)
        err = (soft - w_soft).abs().max().item()
        ok = torch.allclose(soft, w_soft, rtol=1e-4, atol=1e-5)
        agree = (hard == w_hard).float().mean().item()
        pmax_ok = torch.allclose(pmax, w_pmax, rtol=1e-4, atol=1e-5)
        print(f"K1 {metric}: soft max_abs_err {err:.3e} (rtol 1e-4, atol 1e-5: {ok}); "
              f"hard agreement {agree:.6f}; prop_max ok {pmax_ok}; "
              f"pseudo-labelled pixels {(hard != 255).float().mean().item():.3f}")
        check(ok, f"K1 {metric}: soft labels disagree with the plain version (max err {err})")
        check(agree > 0.999, f"K1 {metric}: hard-label agreement {agree} <= 0.999")
        check(pmax_ok, f"K1 {metric}: prop_max disagrees with the plain version")
        result[metric] = err
    ms = cuda_ms(torch, lambda: K.pseudo_labels(feat, protos, prior, tau, thresh, scale))
    plain = cuda_ms(torch, lambda: P.pseudo_labels_plain(feat, protos, prior, tau, thresh, scale))
    nbytes = 4 * (n_pix * n_feat + n_cls * n_feat + 2 * n_pix * n_cls + n_feat + 1 + 2 * n_pix)
    b_ms, b_by = bound_ms(nbytes, 2.0 * n_pix * n_cls * n_feat + n_pix * n_feat)
    print(f"K1 timing (mahalanobis, cold L2): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB)")
    return {"name": "pseudo_labels_kernel", "route": "cuda",
            "source": "onda_torch/csrc/pseudo_labels.cu",
            "replaces": "onda_tpu/ops/pallas_kernels.py:59",
            "shape": f"P={n_pix} F={n_feat} C={n_cls} f32, mahalanobis",
            "max_abs_err": max(result.values()), "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "check": "pass"}


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


def check_k2(torch, K, layers, out_dir):
    shapes = bn_input_shapes(torch)
    check(len(shapes) == 53, f"expected 53 BatchNorm calls in R50, got {len(shapes)}")
    distinct = sorted(set(shapes), key=lambda s: -math.prod(s))
    g = torch.Generator(device="cuda").manual_seed(2)
    rows, max_err = [], 0.0
    per_shape = {}
    for shape in distinct:
        c = shape[1]
        offset = torch.randn(1, c, 1, 1, device="cuda", generator=g)
        spread = 0.5 + torch.rand(1, c, 1, 1, device="cuda", generator=g)
        base = torch.randn(shape, device="cuda", generator=g) * spread + offset
        for dtype in (torch.float32, torch.bfloat16):
            x = base.to(dtype)
            x64 = x.double()
            ref_mean = x64.mean(dim=(0, 2, 3))
            ref_var = x64.var(dim=(0, 2, 3), unbiased=False)
            amax = x64.abs().max().item()
            for layout in ("nchw", "channels_last"):
                xl = x if layout == "nchw" else x.contiguous(memory_format=torch.channels_last)
                mean, var = K.bn_stats(xl)
                torch.cuda.synchronize()
                e_mean = (mean.double() - ref_mean).abs().max().item()
                e_var = ((var.double() - ref_var).abs() / ref_var.abs().clamp(min=1e-30)).max().item()
                # mean: f32 partial sums of <= 4096 (NCHW) or 128 (channels_last)
                # values folded in f64, so its error is a few f32 ulps of max|x|;
                # var: E[x²] − E[x]² with |E[x]| up to ~3 std, f32 partials,
                # leaves a relative error well under 1e-4
                ok = e_mean <= 1e-6 * amax and e_var <= 1e-4
                check(ok, f"K2 {shape} {dtype} {layout}: mean err {e_mean:.3e} "
                          f"(limit {1e-6 * amax:.3e}), var rel err {e_var:.3e} (limit 1e-4)")
                if dtype == torch.float32 and layout == "nchw":
                    max_err = max(max_err, e_mean, (var.double() - ref_var).abs().max().item())
                rows.append({"shape": shape, "dtype": str(dtype), "layout": layout,
                             "mean_abs_err": e_mean, "var_rel_err": e_var})
            # time the layout the main path uses (NCHW)
            ms = cuda_ms(torch, lambda: K.bn_stats(x))
            plain = cuda_ms(torch, lambda: K.bn_stats_plain(x))
            lib = cuda_ms(torch, lambda: torch.var_mean(x, dim=(0, 2, 3), unbiased=False))
            nbytes = x.numel() * x.element_size() + 2 * c * 4
            b_ms, b_by = bound_ms(nbytes, 3.0 * x.numel())
            per_shape[(shape, str(dtype))] = (ms, plain, lib, b_ms)
            print(f"K2 {shape} {str(dtype)[6:]}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                  f"torch.var_mean {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
                  f"{nbytes / 1e6:.1f} MB)")
            del x, x64
        del base
    # one forward's 53 BN inputs (f32), summed with multiplicity
    tot = [sum(per_shape[(s, "torch.float32")][i] for s in shapes) for i in range(4)]
    print(f"K2 over the 53 BN inputs of one R50 forward (f32): kernel {tot[0]:.4f} ms, "
          f"plain {tot[1]:.4f} ms, torch.var_mean {tot[2]:.4f} ms, bound {tot[3]:.4f} ms")
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
            "bound_by": "bytes", "library_ms": tot[2], "check": "pass"}


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
        ours = {name: sum(dev_us(e) for e in kernels if any(s in e.key for s in keys)) / 1e3
                for name, keys in (("pseudo_labels_kernel", ("pseudo_labels_kernel",)),
                                   ("bn_stats_kernel", ("stats_nchw_kernel", "stats_cl_kernel",
                                                        "finalize_kernel")))}
        print(f"profiled step: wall {1e3 * t_prof:.3f} ms, device busy {busy:.3f} ms "
              f"({100 * busy / (1e3 * t_prof):.1f}%); " +
              ", ".join(f"{k} {v:.3f} ms" for k, v in ours.items()))
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
    parser.add_argument("--out-dir", default=os.path.join(HERE, "build", "chip_smoke"),
                        help="where the per-shape K2 table and the profile go")
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
