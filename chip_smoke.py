#!/usr/bin/env python3
"""Smoke test of the onda_torch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py                # every phase; needs one CUDA card
    python3 chip_smoke.py --skip-main    # kernel phases only (1-5)
    python3 chip_smoke.py --profile      # also write a profiler table of one step of
                                         # phase 6, of each of phase 9.4 and of the
                                         # bf16 and f32 b4 steps of phase 10
    python3 chip_smoke.py --compare DIR  # also time an earlier onda_torch package's
                                         # K1 and K2 (DIR/onda_torch, e.g. unpacked
                                         # from a parent commit with git archive)
                                         # against this tree's, in turns
    python3 chip_smoke.py --aux-cost     # also time phase 8.2's step with the
                                         # aux head computed and thrown away
    python3 chip_smoke.py --parallel-only  # phases 1-4, phase 7's dataset,
                                         # phase 12 (the data-parallel ranks:
                                         # 12.1-12.5) and phase 13 (the
                                         # tensor-parallel grids: 13.1-13.5)
    python3 chip_smoke.py --quality-only # phases 1-4, 15 (the quality run)
                                         # and 16 (DeepLab-v3)

Phases:
 1. card name and power limit; the TF32 settings of each phase;
 2. build the CUDA kernels of onda_torch/csrc (one nvcc per source, in parallel)
    and, beside them, the C++ host prep of onda_torch/native (g++);
 3. K1 (pseudo_labels_kernel) against its plain version at the main path's
    shape (P = 4*65*129, F = 256, C = 19), euclidean and mahalanobis, at a
    rank's b2 of phase 12 and b8, at a phase-14 spatial rank's pixels (b2 and
    b1, 33 or 32 of the 65 feature rows; timed at (1 x 2)'s), and at C = 1,
    C = 32 and P = 700 and 1 (not multiples of its 128-pixel tile);
 4. K2 (bn_stats_kernel) against a float64 reference at every distinct
    BatchNorm input shape of DeepLabv2-R50 at batch 4, 1024x512 (and a
    rank's batch 2 of phase 12, and batch 8; a phase-13 rank's channel shards
    and a phase-14 rank's block of rows, timed summed over a rank's 53
    inputs) and at training_fog.yml's batch 4, 128x64 (phase 8.1's SEGMENT
    run), at every BatchNorm input of phase 16's DeepLab-v3 models (16.2's
    at b4 1024x512, timed summed over each forward: the image-pooling
    branch's (4, 256, 1, 1) among them; 16.1's at b2 64x64), and at
    adversarial shapes (odd planes, one element, planes that start at an odd
    element), f32 and bf16, NCHW and channels_last, each call repeated to show
    that the result is the same bit for bit; its raw-moments output (mean and
    E[x^2] in f64, what data parallelism all-reduces) against its plain
    version at the same shapes, and against the statistics output bit for
    bit; the BatchNorm autograd.Function's gradients against autograd of the
    plain version; then BatchNorm's passes after the statistics
    (csrc/bn_norm.cu: bn_apply_kernel with the running update and in eval,
    bn_grad_sums_kernel, bn_grad_dx_kernel) against their plain versions at
    every distinct R50 BatchNorm input and at odd shapes, f32 and bf16, in
    K2's four layouts (NCHW and channels_last, each also one element off a
    16-byte boundary), the reduction
    repeated to the same bits, and timed over one forward's 53 inputs (f32:
    forward, backward, their plain versions and their byte bounds);
 5. a small-input check: one bootstrap and one adaptation step of a tiny model
    on the card against the same on the CPU (plain versions of both kernels),
    the same in bf16 (OTHERS.PRECISION's model), and one step each of ADVENT
    (multi-level) and PROTO_ADVENT, the discriminators and their Adam states
    included;
 6. the main path at full size: configs/hybrid_switch.yml (R50 ProDA head,
    batch 4, 1024x512, f32) with seeded random weights and in-memory seeded
    data: calculate_prototypes, train() for one epoch, evaluate_all; launch
    counters read around each part; one more step must sync the host exactly
    once (the dynamic teacher's gate);
 7. the CLI on PNG files on disk: a seeded weather-Cityscapes tree of
    2048x1024 frames (clear, rain 25 and 50 mm; 32 train and 4 val frames
    each) through `onda_torch.train_ouda.main` on configs/hybrid_switch.yml
    cut only in its data path, domain order, epochs, absent checkpoint files
    and snapshot directory: launch counts, every batch from the C++ executor,
    finite losses, metrics keys, checkpoints, prototype pickles and sample
    PNGs checked; frames/s from disk, per-step stage times, the device's busy
    share over two profiled steps and the host prep's own rate printed; then
    a resumed run (AUTO_RESUME) with a replay buffer that the steps insert
    into;
 8. the workflow on phase 7's files (a fog metadata table over the same
    frames: visibilities 0, 75, 150, 375, 750), each run through
    `onda_torch.train_ouda.main` with the shipped config cut only in its
    data path, domain order, epochs, absent checkpoint files and snapshot
    directory: training_fog.yml (SEGMENT at 128x64, multi-level, 4 epochs;
    K2 53 per step, its weights the adaptation's start) → offline_fog.yml
    (adaptation from that .pth at 1024x512, multi-level; K1 2 and K2 159 per
    step, the step's host syncs, the aux head never run, the step timed) →
    validation_offline_fog.yml (EVALUATION of the adaptation's snapshot, K1
    one per validation batch, then OTHERS.EVAL_SWEEP over every checkpoint)
    → validation.yml (PREDICTION_SAVE: one (4, 19, 65, 129) dump per target
    batch, no kernel launched); then a SEGMENT step timed in memory at
    1024x512, b4 (median ms, frames/s, peak memory);
 9. the adversarial family on phase 7's rain files, each run through
    `onda_torch.train_ouda.main` with the shipped config cut only in its data
    path, domain order, epochs, absent files and snapshot directory:
    advent.yml (ADVENT, multi-level, one mixed domain [[25, 50]], from 8.1's
    `.pth`; K2 106 per step, three finite losses a step, both discriminators
    and their Adam states in `advent_state.pt`) → validation_offline_advent.yml
    on its snapshot (it must load `advent_state.pt`; K1 one per validation
    batch) → proto_advent.yml (two domains, seeded weights, bootstrapped
    prototypes; K1 2 and K2 159 per step); then one step of each method timed
    in memory at 1024x512, b4 (median of 5 after 1, peak memory, host syncs).
 10. every option of get_model, each on hybrid_switch.yml in memory at
    1024x512 with seeded weights (median of 4 steps after 1, peak memory,
    launch counts, one host sync a step): OTHERS.PRECISION bf16 (bf16 logits
    at the head, f32 parameters; K1 2, K2 159); OTHERS.REMAT at b4 and b8,
    each beside the same batch without it (K2 159 + 2 x 52: the backward
    recomputes the student's bottlenecks; running statistics after a step
    equal to 1e-6); DeepLabv2-Resnet101 (K2 312); DeepLabv2-Resnet101-ProDA
    from a `.pth` the script writes in ProDA's container with bn_pretrain
    (bn_clr detected, K2 315, layer5 and bn_pretrain trained);
    DeepLabv2-Resnet50-GN (K2 0, K1 2).
 11. the six shipped prototype configs no earlier phase runs, each through
    `onda_torch.train_ouda.main` on phase 7's files at its own width (R50
    ProDA head, b4 1024x512), cut only in its data path, domain order (its
    first domain), epochs, absent files and snapshot directory:
    static_model.yml and dynamic_model.yml (PROTO_ONLINE), confidence_switch.yml
    (HSWITCH), confidence_der_switch.yml (VSWITCH), hybrid_switch_fog.yml (the
    fog table of phase 8) and external_video.yml (a metadata_bern.json over
    the clear frames and, without labels, the 25 mm ones; no validation):
    K1 2 and K2 159 per step, the steady stage times, the logged frames/s,
    the host syncs of one more step (0 for PROTO_ONLINE, 1 otherwise), the
    steps that ran the dynamic teacher, finite losses; then OTHERS.ASYNC_SAVE
    in memory (the hybrid adapter at b4 1024x512: the step right after the
    save changes the state in place, the file must hold it as saved, bit
    for bit, and equal a synchronous save; the save's return, drain and the
    next step timed) and through the CLI (confidence_switch.yml, SAVE_EVERY
    2). Every K1 and K2 shape these runs feed must be among those phases 3-4
    checked.
 12. OTHERS.DATA_PARALLEL across two ranks, in one run of `python -m
    torch.distributed.run --nproc-per-node 2` (NCCL with a card per rank
    where there are two cards, else both ranks on the one card through
    gloo; the phase's lines name the backend and the layout): 12.1
    hybrid_switch.yml in memory at b4 1024x512, one process at b4 against
    the ranks at b2 each after a bootstrap and one step (losses,
    prototypes, every parameter's update; the ranks' whole states equal bit
    for bit), then timed steps (per-rank step ms, K1 2 and K2 159 a step,
    271 all-reduces a step and their bytes, host syncs, peak memory); 12.2
    `onda_torch.train_ouda.main` on phase 7's files (one domain), rank 0
    the one writer: exit 0, finite losses, each rank's K1/K2 counts; 12.3
    advent.yml (multi-level) and proto_advent.yml (bootstrapped) in memory
    at b4 1024x512 the same way, one process at b4 against the ranks after
    one step in both of 12.1's modes (losses, the student's head and
    backbone updates, both discriminators' updates; the ranks' whole
    states, discriminators and Adam states included, equal bit for bit),
    then timed (per rank and step: ADVENT K2 106 and 216 collectives,
    PROTO_ADVENT K1 2, K2 159 and 272 collectives), and a SEGMENT step of
    training_fog.yml's model (K2 53, 108 collectives); 12.4 advent.yml (and
    an AUTO_RESUME run that restores `advent_state.pt` on both ranks),
    proto_advent.yml and training_fog.yml (SEGMENT 1 epoch, then its
    adaptation) through the CLI on phase 7's files: launches per rank, one
    writer, every file once, no temporary left; 12.5 validation_offline_fog.yml,
    its EVAL_SWEEP and validation.yml (PREDICTION_SAVE) on 12.4's SEGMENT
    snapshots, the ranks against one process on the same files (`Val
    mIoU*`, the swept files, the dumps in rank-major order, the confidence).
    Ranks that share one card (gloo) move their card tensors through the
    card's memory (CUDA IPC, `onda_torch/parallel/shared_card.py`). The
    ranks of 12.1 and 12.3 and the CLI runs of 12.2, 12.4 and 12.5 (one
    domain each, chained in one process group) are jobs of the one run.
 13. OTHERS.TENSOR_PARALLEL 2 on a (data x model) grid of ranks, in two runs
    of `python -m torch.distributed.run` (NCCL with a card per rank,
    else all ranks on the one card through gloo and CUDA IPC; the phase's
    lines name the backend and the layout): 13.0, where ranks share the
    card (on 13.1's ranks), the sum and the gather of seeded random card
    tensors of 4 KB to 275 MB (over the channel's 256 MB buffer: two pieces)
    between two ranks through the card's memory, equal bit for bit to the
    ranks' tensors added in rank order and stacked, and both ways timed
    against gloo; 13.1 hybrid_switch.yml in memory
    at b4 1024x512 on a (1 x 2) grid, one process at b4 against the grid
    after a bootstrap and one step in both of 12.1's modes (losses,
    prototypes, every parameter's update with the shards gathered; whole
    leaves equal bit for bit on every rank, shards on the ranks of a model
    index), and batch-invariant against a witness, one process whose
    sharded layers compute in the grid's blocks (its own gap to one
    process is printed and sets the plain comparison's backbone bound),
    then 6 timed steps (per-rank step ms, K1 2 and K2 159 a step
    per rank, collectives and bytes a step by group, host syncs, peak
    memory, the bytes of params + momentum + teachers a rank holds against
    one process's); 13.2 the same on a (2 x 2) grid, 4 ranks of b2, 2 timed
    steps (its own run); 13.3 `onda_torch.train_ouda.main` on phase 7's
    files on a (1 x 2) grid (one domain): exit 0, one writer, every file
    once, then an AUTO_RESUME rerun that restores it on both ranks, and a
    one-process `load_model` of its `adapt_state.pt` equal to each rank's
    shards bit for bit; 13.4 advent.yml (multi-level, its discriminators'
    conv1-conv3 sharded), proto_advent.yml (its discriminators whole) and
    a SEGMENT step of training_fog.yml's model in memory at b4 1024x512 on
    the (1 x 2) grid, one process at b4 against the grid after one step in
    both of 12.1's modes and batch-invariant against each method's witness
    (losses, the student's head and backbone updates and gradients, the
    discriminators' gradients, each method's own bounds; whole leaves equal
    bit for bit on both ranks), then 3 timed steps (per-rank step ms, K1/K2
    a step, collectives and bytes by group, host syncs, peak, the state a
    rank holds against one process's), and ADVENT's fool-only step (source
    labels ignored: the student's gradient through the sharded
    discriminators alone) against its witness;
    13.5 the CLI on a (1 x 2) grid, one domain each: advent.yml, its
    AUTO_RESUME rerun, validation_offline_advent.yml on its snapshot,
    proto_advent.yml, training_fog.yml (SEGMENT 1 epoch),
    validation_offline_fog.yml with
    EVAL_SWEEP on its snapshots: exit 0, one writer, every file once, each
    file's one-process load cut into shards equal to the ranks' bit for bit,
    every K1/K2 shape fed among phases 3-4's. 13.1, 13.3, 13.4 and 13.5 are
    jobs of the one run of the (1 x 2) grid. Phase 4 checks and times K2 at
    the grid's shard shapes.
 14. the spatial mesh axis (no config key: `onda_torch.parallel.mesh.
    spatial_grid`, JAX's make_mesh(shape=(d, s), axes=("data", "spatial"))),
    each rank holding its block of every image's rows: 14.1 hybrid_switch.yml
    at full width (R50 3-4-6-3, ProDA head) in memory at b2 1024x512 on a
    (1 x 2) grid (the pool's 129 rows and the 65-row feature grid split
    65/64 and 33/32), one process at b2 against the grid after a bootstrap
    from full-resolution source labels and one step, batch-invariant and as
    it runs (losses, prototypes, the head's and backbone's updates, the
    prototype counts, pseudo-labels and gate, Σ|params| within 1e-4; the
    ranks' whole states equal bit for bit), then 3 timed steps (per-rank step
    ms, K1 2 on the rank's pixels and K2 159 on its rows a step, every K1/K2
    shape fed among phases 3-4's, collectives and bytes a step by group: the
    halo rows on the spatial group, host syncs, peak memory); 14.2 the same
    on JAX's (2 x 2) shape, batch-invariant, 1 timed step. 14.1's ranks are
    a job of phase 13's (1 x 2) torchrun, 14.2's of 13.2's four ranks; the
    one-process references and the checks are phase 14's own.
 15. the GPU quality run (`onda_torch.quality_run`, ROADMAP M19) cut in
    depth: its 1024x512 shift storm in bf16 at b4, 8 train and 4 val frames
    a domain, 2 Adam pretraining epochs and 1 adaptation epoch of the CLI
    over [[60], [30]]: the JSON's keys and finite values, the `.pth` loading
    strict, the step count, K2 53 a pretraining step, K2 53 a bootstrap
    batch, K1 2 and K2 159 an adaptation step (K1 1 a validation batch with
    prototypes: none, SKIP_PROTO_EVAL), every K1/K2 shape fed among phases
    3-4's; the pretraining and adaptation step ms, the peak memory, and the
    seconds from the launch of a fresh CLI process on the run's config to
    its first adapted step with the kernel build directory warm (what JAX's
    OTHERS.AOT_CACHE cuts);
 16. DeepLab-v3 (`onda_torch.models.deeplabv3`): 16.1 resnet50 v3+ OS16,
    mobilenetv2 v3 OS16 and mobilenetv2 v3+ OS8 at b2 64x64 on the card
    against the CPU (plain K2), eval and train mode (outputs, running
    statistics), TF32 off; 16.2 resnet50 v3+ OS16 and mobilenetv2 v3 OS16 at
    b4 1024x512 f32: a train-mode forward and the backward of a CE loss
    (finite; K2 once per BatchNorm: 61 and 57) and an eval forward, timed,
    with the peak memory; every K2 shape fed among phase 4's.
 Every phase prints its seconds, and the end the whole script's.

Kernel times are device times: the device is held busy (`torch.cuda._sleep`)
while the host queues the timed calls, so the host's time to queue a launch
does not count, and each call finds a cold L2. Each timing line gives the
share of the bound (bound ms / ms).

Prints the card line and one JSON line of kernel results (launch counts by
path), then as the last line
{"ok": true, "device": {...}}. Any failure exits non-zero before that line.
Writes the per-shape K2 table, the CLI runs' output and profile table (and
the step profile, and the comparison) under --out-dir (default
build/chip_smoke/).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores
MAIN_STEPS = 6              # one epoch; the median step skips the first and the last


class SmokeFailure(RuntimeError):
    pass


PHASE_SECONDS = {}  # phase → its own seconds, printed as each ends


@contextlib.contextmanager
def phase_clock(name):
    """Time the phase `name` on the host clock and print its seconds on a line
    of their own when it ends."""
    t = time.perf_counter()
    yield
    PHASE_SECONDS[name] = time.perf_counter() - t
    print(f"phase {name} seconds: {PHASE_SECONDS[name]:.3f}")


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
    """Mean device time of fn, each call after a read of 128 MB that evicts the
    50 MB L2 (the main path finds its inputs cold) and leaves it clean. The
    device sleeps while the host queues every call, so the time between the
    events is the device's alone; the sleep grows until it outlasts the
    queueing."""
    buf = torch.ones(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    cycles = 20_000_000
    for _ in range(5):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        slept = torch.cuda.Event()
        slept.record()
        events = []
        for _ in range(iters):
            buf.sum()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        caught_up = slept.query()  # the sleep ended before the last call was queued
        torch.cuda.synchronize()
        if not caught_up:
            return sum(s.elapsed_time(e) for s, e in events) / iters
        cycles *= 4
    raise SmokeFailure("the device outran the host at every sleep: does the timed call sync?")


def release(torch) -> int:
    """Free what earlier phases left behind (an adapter and its built steps
    refer to each other, so only the collector frees them); returns the bytes
    still allocated on the card, the baseline of a peak-memory reading."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


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
    # the main path's shape, a phase-12 rank's batch of 2, phase 10.2's batch
    # of 8, then C = 1 and 32 and P off the 128-pixel tile
    # phase 14's spatial ranks: each one's pixels, b2 on (1 x 2), b1 on (2 x 2),
    # its block of the 65 feature rows (33 or 32)
    spatial = [(b * rows * 129, 256, 19) for b in (2, 1) for rows in (33, 32)]
    cases = [main, (2 * 65 * 129, 256, 19), (8 * 65 * 129, 256, 19), (main[0], 256, 1),
             (main[0], 256, 32), (700, 256, 19), (1, 256, 19), *spatial]
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
    timed = {}
    for n_pix, n_feat, n_cls in spatial[:2]:  # a (1 x 2) spatial rank's pixels
        f_, p_, pr_, sc_ = k1_inputs(torch, n_pix, n_feat, n_cls, 1)
        k_ms = cuda_ms(torch, lambda: K.pseudo_labels(f_, p_, pr_, tau, thresh, sc_))
        p_ms = cuda_ms(torch, lambda: P.pseudo_labels_plain(f_, p_, pr_, tau, thresh, sc_))
        nb = 4 * (n_pix * n_feat + n_cls * n_feat + 2 * n_pix * n_cls + n_feat + 1 + 2 * n_pix)
        s_ms, s_by = bound_ms(nb, 2.0 * n_pix * n_cls * n_feat + n_pix * n_feat)
        timed[n_pix] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": s_ms, "bound_by": s_by}
        print(f"K1 at a (1 x 2) spatial rank's P={n_pix} (mahalanobis, cold L2): kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {s_ms:.4f} ms ({s_by}), "
              f"{100 * share(s_ms, k_ms):.1f}% of the bound")
    return {"name": "pseudo_labels_kernel", "route": "cuda",
            "source": "onda_torch/csrc/pseudo_labels.cu",
            "replaces": "onda_tpu/ops/pallas_kernels.py:60",
            "shape": f"P={main[0]} F={main[1]} C={main[2]} f32, mahalanobis",
            "checked_shapes": [list(c) for c in cases],
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "bound_share": share(b_ms, ms),
            "library_ms": None, "spatial_ranks": timed, "check": "pass"}


# ---------------------------------------------------------------------------
# phase 4: K2
# ---------------------------------------------------------------------------


def bn_input_shapes(torch, batch=4, hw=(512, 1024), tp=1, rows=None):
    """Input shape of every BatchNorm call of one R50 forward (meta tensors),
    as K2 meets it on a rank of a grid with a model axis of `tp`: the
    channel shard of each BatchNorm the plan shards (`parallel.tensor`); or
    with `rows` (s, r), on spatial index r of a spatial axis of s: its block
    of each input's rows (`parallel.spatial.split`)."""
    from onda_torch.models import build_deeplab_v2
    from onda_torch.parallel import spatial as S
    from onda_torch.parallel import tensor as T

    if rows is not None:
        s, r = rows
        return [(n, c, S.split(h, s)[r][1] - S.split(h, s)[r][0], w)
                for n, c, h, w in bn_input_shapes(torch, batch, hw)]

    with torch.device("meta"):
        model = build_deeplab_v2(19, (3, 4, 6, 3), "ProDA")
    plan = T.tensor_parallel_plan(dict(model.named_parameters()), tp) if tp > 1 else {}
    return forward_bn_shapes(torch, model, batch, hw,
                             cut=lambda name: tp if f"{name}.weight" in plan else 1)


def forward_bn_shapes(torch, model, batch, hw, cut=lambda name: 1):
    """The input shape of every BatchNorm call of one forward of a model on
    the meta device at (batch, 3, *hw), each BatchNorm's channels divided by
    cut(its name)."""
    from onda_torch.models.layers import TorchBatchNorm

    shapes = []
    for name, mod in model.named_modules():
        if isinstance(mod, TorchBatchNorm):
            mod.register_forward_pre_hook(lambda m, args, c=cut(name): shapes.append(
                (args[0].shape[0], args[0].shape[1] // c, *args[0].shape[2:])))
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
    """K2 on x in every layout against float64, and twice to the same bits;
    its raw moments against their plain version and against the statistics
    output, bit for bit. Returns (max mean error, max var relative error,
    max var error, max raw-moment error) of the NCHW call."""
    x64 = x.double()
    ref_mean = x64.mean(dim=(0, 2, 3))
    ref_var = x64.var(dim=(0, 2, 3), unbiased=False)
    amax = x64.abs().max().item()
    # a channel whose variance is under 1% of its E[x²] (one value, or a few
    # close values far from 0: the image-pooling branch's (N, 256, 1, 1) at
    # small N) keeps of E[x²] − E[x]² only the f32 rounding of x²: its error
    # is held to that, as a zero variance's is
    flat = ref_var <= 1e-2 * (ref_var + ref_mean * ref_mean)
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
                  f"err {e_var:.3e} (limit 1e-4), near-zero-var err {e_flat:.3e} (limit "
                  f"{1e-6 * amax**2:.3e}, {int(flat.sum())} channels)")
        raw, raw2 = K.bn_moments(xl), K.bn_moments(xl)
        torch.cuda.synchronize()
        check(torch.equal(raw, raw2), f"K2 {tag} {layout}: two raw-moment calls differ")
        plain = K.bn_moments_plain(xl)
        e_raw = (raw - plain).abs().max().item()
        e_sq = ((raw[1] - plain[1]).abs() / plain[1].abs().clamp(min=1e-30)).max().item()
        # the same f64 fold as the statistics: its mean rounds to theirs, and
        # E[x²] − E[x]² in f64 to their variance, bit for bit
        same = (torch.equal(raw[0].float(), mean) and torch.equal(
            torch.clamp(raw[1] - raw[0] * raw[0], min=0.0).float(), var))
        e_m = (raw[0] - plain[0]).abs().max().item()
        check(raw.dtype == torch.float64 and e_m <= 1e-6 * amax and e_sq <= 1e-6 and same,
              f"K2 {tag} {layout}: raw moments: mean err {e_m:.3e}, E[x²] rel err {e_sq:.3e} "
              f"(limits {1e-6 * amax:.3e}, 1e-6), the statistics' bits {same}")
        if layout == "nchw":
            result = (e_mean, e_var, (var.double() - ref_var).abs().max().item(), e_raw)
    return result


def segment_bn_shapes(torch, tp=1):
    """The BatchNorm input shapes of configs/training_fog.yml's SEGMENT step,
    at its own batch and resolution (phase 8.1), on a rank of a (1 x tp)
    grid (phase 13.5: the channel shards)."""
    from onda_torch.config import cfg_from_file

    cfg = cfg_from_file(os.path.join(HERE, "configs", "training_fog.yml"))
    w, h = cfg.SCHEME.RESOLUTION
    return bn_input_shapes(torch, batch=int(cfg.TRAINING.BATCH_SIZE), hw=(int(h), int(w)), tp=tp)


def check_k2(torch, K, layers, out_dir):
    shapes = bn_input_shapes(torch)
    check(len(shapes) == 53, f"expected 53 BatchNorm calls in R50, got {len(shapes)}")
    distinct = sorted(set(shapes), key=lambda s: -math.prod(s))
    # checked, not timed: phase 8.1's shapes and their shards on a (1 x 2)
    # grid (13.5), a phase-12 rank's batch of 2 and phase 10.2's batch of 8;
    # checked and timed in f32: phase 13's ranks, a (1 x 2) grid's at b4
    # and a (2 x 2) grid's at b2 (channel shards)
    grids = {"(1 x 2) b4": bn_input_shapes(torch, batch=4, tp=TP_SIZE),
             "(2 x 2) b2": bn_input_shapes(torch, batch=2, tp=TP_SIZE)}
    # phase 14's spatial ranks: each one's block of every input's rows, b2 on
    # (1 x 2), b1 on (2 x 2)
    for (d, sp), _, _ in SP_GRIDS.values():
        for r in range(sp):
            grids[f"({d} x {sp}) spatial b{SP_BATCH // d} rank {r}"] = bn_input_shapes(
                torch, batch=SP_BATCH // d, rows=(sp, r))
    grid_shapes = set().union(*grids.values())
    # phase 16's DeepLab-v3 models: 16.2's at b4 1024x512 (timed in f32,
    # summed over each forward) and 16.1's small inputs; phase 15's quality
    # run feeds R50's b4 shapes, the full quality run its b8 ones, in bf16
    v3_full = {v3_tag(*c): v3_bn_shapes(torch, *c, 4, MAIN_HW) for c in V3_FULL}
    v3_shapes = set().union(*v3_full.values(), *(
        v3_bn_shapes(torch, *c, V3_SMALL_INPUT[0], V3_SMALL_INPUT[1]) for c in V3_SMALL))
    timed_f32 = grid_shapes.union(*v3_full.values())
    extra = (set(segment_bn_shapes(torch)) | set(segment_bn_shapes(torch, tp=TP_SIZE))
             | set(bn_input_shapes(torch, batch=2))
             | set(bn_input_shapes(torch, batch=8)) | grid_shapes | v3_shapes)
    others = sorted(extra - set(distinct), key=lambda s: -math.prod(s))
    g = torch.Generator(device="cuda").manual_seed(2)
    rows, max_err, raw_err = [], 0.0, 0.0
    per_shape, raw_ms = {}, {}
    for shape in distinct + others + K2_ODD_SHAPES:
        c = shape[1]
        offset = torch.randn(1, c, 1, 1, device="cuda", generator=g)
        spread = 0.5 + torch.rand(1, c, 1, 1, device="cuda", generator=g)
        base = torch.randn(shape, device="cuda", generator=g) * spread + offset
        for dtype in (torch.float32, torch.bfloat16):
            x = base.to(dtype)
            e_mean, e_var, e_var_abs, e_raw = check_k2_once(torch, K, x, f"{shape} {dtype}")
            rows.append({"shape": shape, "dtype": str(dtype), "mean_abs_err": e_mean,
                         "var_rel_err": e_var, "raw_moments_abs_err": e_raw})
            if shape not in distinct and (shape not in timed_f32 or dtype != torch.float32):
                continue
            if dtype == torch.float32:
                max_err = max(max_err, e_mean, e_var_abs)
                raw_err = max(raw_err, e_raw)
                raw_ms[shape] = cuda_ms(torch, lambda: K.bn_moments(x))
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
          f"every call repeated gave the same bits; among them training_fog.yml's SEGMENT "
          f"shapes and the batch-8 shapes {others}")
    slower = [k for k, v in per_shape.items() if v[0] > v[2]]
    print(f"K2 slower than torch.var_mean at {len(slower)} of {len(per_shape)} shape/type "
          f"pairs: {slower}")
    # one forward's 53 BN inputs (f32), summed with multiplicity
    tot = [sum(per_shape[(s, "torch.float32")][i] for s in shapes) for i in range(4)]
    moments_ms = sum(raw_ms[s] for s in shapes)
    print(f"K2 over the 53 BN inputs of one R50 forward (f32): kernel {tot[0]:.4f} ms, "
          f"plain {tot[1]:.4f} ms, torch.var_mean {tot[2]:.4f} ms, bound {tot[3]:.4f} ms, "
          f"{100 * share(tot[3], tot[0]):.1f}% of the bound; the raw-moments output "
          f"{moments_ms:.4f} ms (max abs err against its plain version {raw_err:.3e})")
    tp_totals = {}
    for grid, fed in grids.items():
        t = [sum(per_shape[(s, "torch.float32")][i] for s in fed) for i in range(4)]
        tp_totals[grid] = {"ms": t[0], "plain_ms": t[1], "library_ms": t[2], "bound_ms": t[3],
                           "moments_ms": sum(raw_ms[s] for s in fed),
                           "shapes": sorted(set(fed) - set(distinct))}
        print(f"K2 over the 53 BN inputs a rank of the {grid} grid (phases 13-14) feeds one "
              f"forward "
              f"(f32, {len(set(fed) - set(distinct))} shard shapes no one-process forward has): "
              f"kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms, torch.var_mean {t[2]:.4f} ms, bound "
              f"{t[3]:.4f} ms, {100 * share(t[3], t[0]):.1f}% of the bound; raw moments "
              f"{tp_totals[grid]['moments_ms']:.4f} ms")
    v3_totals = {}
    for tag, fed in v3_full.items():
        t = [sum(per_shape[(s, "torch.float32")][i] for s in fed) for i in range(4)]
        v3_totals[tag] = {"bn_calls": len(fed), "ms": t[0], "plain_ms": t[1], "library_ms": t[2],
                          "bound_ms": t[3], "shapes": len(set(fed))}
        print(f"K2 over the {len(fed)} BN inputs of one DeepLab-{tag} forward at b4 "
              f"{MAIN_HW[1]}x{MAIN_HW[0]} (f32, phase 16.2; {len(set(fed))} shapes): kernel "
              f"{t[0]:.4f} ms, plain {t[1]:.4f} ms, torch.var_mean {t[2]:.4f} ms, bound "
              f"{t[3]:.4f} ms, {100 * share(t[3], t[0]):.1f}% of the bound")
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
            "checked_shapes": [list(s) for s in distinct + others + K2_ODD_SHAPES],
            "max_abs_err": max_err, "ms": tot[0], "plain_ms": tot[1], "bound_ms": tot[3],
            "bound_by": "bytes", "bound_share": share(tot[3], tot[0]), "library_ms": tot[2],
            "moments_ms": moments_ms, "moments_max_abs_err": raw_err,
            "tensor_parallel_ranks": tp_totals, "deeplab_v3_forwards": v3_totals,
            "check": "pass"}


# ---------------------------------------------------------------------------
# phase 4 (cont.): BatchNorm's passes after the statistics (csrc/bn_norm.cu)
# ---------------------------------------------------------------------------

BN_ODD_SHAPES = [(4, 256, 1, 1), (3, 17, 33, 25), (1, 1, 1, 1)]


def check_bn_once(torch, K, x, dy, gamma, beta, rm0, rv0, tag):
    """bn_apply (train with the running update, and eval), bn_grad_sums and
    bn_grad_dx on the card against their plain versions run on the same card
    tensors, in each of K2's layouts (`k2_layouts`: off a 16-byte boundary
    the passes meet a fresh output or dy there and run all scalar); returns
    the largest gaps of the NCHW call.

    Tolerances, and why: y, inv, the running update and dx from given sums
    repeat the plain version's operations in its order with round-to-nearest
    f32 steps, so they agree to the rounding of rsqrtf and of a division
    (PyTorch's card kernels divide by a scalar through its reciprocal): 2e-7
    relative in f32 (1e-6 for dx), one bf16 step (2^-8) in bf16, where such a
    gap can tip the final rounding; the running update takes no rsqrt or
    division and matches bit for bit. The sums are f32 sums of up to 2M
    products in another order: within 1e-5 of the channel's Σ|term|."""
    n, c, h, w = x.shape
    count = n * h * w
    f32 = x.dtype == torch.float32
    rel = 2e-7 if f32 else 2.0**-8

    def same_layout(a, b):  # strides may differ only where a dimension has size 1
        return a.dtype == b.dtype and all(
            a.is_contiguous(memory_format=f) == b.is_contiguous(memory_format=f)
            for f in (torch.contiguous_format, torch.channels_last))

    def gap(got, want):  # the largest |got − want| over max|want|
        want = want.float()
        return ((got.float() - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()

    out = None
    for layout, xl in k2_layouts(torch, x).items():
        dyl = (dy.contiguous(memory_format=torch.channels_last)
               if layout.startswith("channels_last") else dy)
        mean, var = K.bn_stats(xl)
        got_rm, got_rv, want_rm, want_rv = rm0.clone(), rv0.clone(), rm0.clone(), rv0.clone()
        y, inv = K.bn_apply(xl, mean, var, gamma, beta, 1e-5, (got_rm, got_rv, 0.1, count), True)
        want_y, want_inv = K.bn_apply_plain(xl, mean, var, gamma, beta, 1e-5,
                                            (want_rm, want_rv, 0.1, count), True)
        y_eval = K.bn_apply(xl, rm0, rv0, gamma, beta, 1e-5)
        want_eval = K.bn_apply_plain(xl, rm0, rv0, gamma, beta, 1e-5)
        gaps = {"y": gap(y, want_y), "inv": gap(inv, want_inv), "eval_y": gap(y_eval, want_eval)}
        check(same_layout(y, xl), f"BN {tag} {layout}: y's dtype or layout")
        check(torch.equal(got_rm, want_rm) and torch.equal(got_rv, want_rv),
              f"BN {tag} {layout}: the running update differs from the plain one's bits")
        sums = K.bn_grad_sums(xl, dyl, mean, inv)
        again = K.bn_grad_sums(xl, dyl, mean, inv)
        check(all(torch.equal(a, b) for a, b in zip(sums, again)),
              f"BN {tag} {layout}: two reductions differ (not deterministic)")
        want_sums = K.bn_grad_sums_plain(xl, dyl, mean, inv)
        x_hat = (xl.float() - mean.view(1, -1, 1, 1)) * inv.view(1, -1, 1, 1)
        mags = (dyl.float().abs().sum(dim=(0, 2, 3)),
                (dyl.float() * x_hat).abs().sum(dim=(0, 2, 3)))
        for key, got, want, mag in zip(("sum_dy", "sum_dy_xhat"), sums, want_sums, mags):
            gaps[key] = ((got - want).abs() / mag.clamp(min=1e-30)).max().item()
        for key, args in (("dx", (*sums, count)), ("eval_dx", ())):
            dx = K.bn_grad_dx(xl, dyl, mean, inv, gamma, *args)
            check(same_layout(dx, xl), f"BN {tag} {layout}: dx's dtype or layout")
            gaps[key] = gap(dx, K.bn_grad_dx_plain(xl, dyl, mean, inv, gamma, *args))
        torch.cuda.synchronize()
        limits = {"y": rel, "inv": 2e-7, "eval_y": rel, "sum_dy": 1e-5, "sum_dy_xhat": 1e-5,
                  "dx": max(rel, 1e-6), "eval_dx": max(rel, 1e-6)}
        bad = {k: v for k, v in gaps.items() if not v <= limits[k]}
        check(not bad, f"BN {tag} {layout}: gaps {bad} over their limits {limits}")
        if layout == "nchw":
            out = gaps
    return out


def bn_case(torch, shape, g):
    """Seeded inputs of a BatchNorm at `shape`: x with channel means of about
    twice its spread (|mean| well above the std), dy, γ, β and running
    statistics."""
    c = shape[1]
    x = (torch.randn(shape, device="cuda", generator=g)
         * (0.5 + torch.rand(1, c, 1, 1, device="cuda", generator=g))
         + 2 * torch.randn(1, c, 1, 1, device="cuda", generator=g))
    dy = torch.randn(shape, device="cuda", generator=g)
    gamma = 1 + 0.1 * torch.randn(c, device="cuda", generator=g)
    beta = 0.1 * torch.randn(c, device="cuda", generator=g)
    return x, dy, gamma, beta, torch.randn(c, device="cuda", generator=g), \
        0.5 + torch.rand(c, device="cuda", generator=g)


def check_bn_passes(torch, K, out_dir):
    """The BatchNorm passes against their plain versions at every distinct
    BatchNorm input of one R50 b4 1024x512 forward and at odd shapes, f32
    and bf16, each layout; then timed over the 53 inputs of one forward (f32,
    summed with multiplicity): the forward as training runs it (with the
    running update) and one backward (reduction and dx), each against its
    plain version and its bound (the bytes at 3.35 TB/s: forward x read and
    y written, backward x and dy read twice and dx written)."""
    shapes = bn_input_shapes(torch)
    distinct = sorted(set(shapes), key=lambda s: -math.prod(s))
    g = torch.Generator(device="cuda").manual_seed(5)
    rows, per_shape, worst = [], {}, {}
    for shape in distinct + BN_ODD_SHAPES:
        x32, dy32, gamma, beta, rm, rv = bn_case(torch, shape, g)
        for dtype in (torch.float32, torch.bfloat16):
            x, dy = x32.to(dtype), dy32.to(dtype)
            gaps = check_bn_once(torch, K, x, dy, gamma, beta, rm, rv, f"{shape} {dtype}")
            rows.append({"shape": shape, "dtype": str(dtype), **gaps})
            for k, v in gaps.items():
                worst[(k, str(dtype))] = max(worst.get((k, str(dtype)), 0.0), v)
            if shape not in distinct or dtype != torch.float32:
                continue
            n, c, h, w = shape
            count = n * h * w
            mean, var = K.bn_stats(x)
            inv = torch.rsqrt(var + 1e-5)
            run = (rm.clone(), rv.clone(), 0.1, count)

            def backward(sums, dx):
                s = sums(x, dy, mean, inv)
                return dx(x, dy, mean, inv, gamma, *s, count)

            timed = (
                cuda_ms(torch, lambda: K.bn_apply(x, mean, var, gamma, beta, 1e-5, run)),
                cuda_ms(torch, lambda: K.bn_apply_plain(x, mean, var, gamma, beta, 1e-5, run)),
                cuda_ms(torch, lambda: backward(K.bn_grad_sums, K.bn_grad_dx)),
                cuda_ms(torch, lambda: backward(K.bn_grad_sums_plain, K.bn_grad_dx_plain)))
            nbytes = x.numel() * x.element_size()
            per_shape[shape] = (*timed, bound_ms(2 * nbytes)[0], bound_ms(5 * nbytes)[0])
            print(f"BN passes {shape} f32: forward {timed[0]:.4f} ms (plain {timed[1]:.4f}, "
                  f"bound {per_shape[shape][4]:.4f}, {100 * share(per_shape[shape][4], timed[0]):.1f}%), "
                  f"backward {timed[2]:.4f} ms (plain {timed[3]:.4f}, bound "
                  f"{per_shape[shape][5]:.4f}, {100 * share(per_shape[shape][5], timed[2]):.1f}%)")
            del x, dy
        del x32, dy32
    print("BN passes checked at " + str(len(rows)) + " shape/type pairs, 4 layouts each; largest "
          "gaps " + ", ".join(f"{k} {d[6:]} {v:.3e}" for (k, d), v in sorted(worst.items())))
    tot = [sum(per_shape[s][i] for s in shapes) for i in range(6)]
    print(f"BN passes over the 53 BN inputs of one R50 forward (f32): forward kernel "
          f"{tot[0]:.4f} ms, plain {tot[1]:.4f} ms, bound {tot[4]:.4f} ms, "
          f"{100 * share(tot[4], tot[0]):.1f}% of the bound; backward kernels {tot[2]:.4f} ms, "
          f"plain {tot[3]:.4f} ms, bound {tot[5]:.4f} ms, {100 * share(tot[5], tot[2]):.1f}% "
          f"of the bound")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "bn_passes.json"), "w") as f:
        json.dump({"checks": rows, "timings": [
            {"shape": s, "forward_ms": v[0], "forward_plain_ms": v[1], "backward_ms": v[2],
             "backward_plain_ms": v[3], "forward_bound_ms": v[4], "backward_bound_ms": v[5]}
            for s, v in per_shape.items()]}, f, indent=1)
    return {"name": "bn_norm kernels", "route": "cuda", "source": "onda_torch/csrc/bn_norm.cu",
            "replaces": "no TPU kernel (plain jnp in onda_tpu/models/layers.py)",
            "shape": "the 53 BatchNorm inputs of one R50 forward, b4 1024x512 f32 NCHW (times "
                     "summed)",
            "checked_shapes": [list(s) for s in distinct + BN_ODD_SHAPES],
            "max_gaps": {f"{k} {d[6:]}": v for (k, d), v in worst.items()},
            "forward_ms": tot[0], "forward_plain_ms": tot[1], "forward_bound_ms": tot[4],
            "forward_bound_share": share(tot[4], tot[0]), "backward_ms": tot[2],
            "backward_plain_ms": tot[3], "backward_bound_ms": tot[5],
            "backward_bound_share": share(tot[5], tot[2]), "bound_by": "bytes",
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


def compare_earlier(torch, K, path, out_dir):
    """Time the earlier K1 and K2 against this tree's on the same inputs, in
    turns (earlier, this, this, earlier)."""
    old = load_earlier_kernels(path)
    t = time.perf_counter()
    old.build.build_all()
    print(f"earlier kernels from {path}: build {time.perf_counter() - t:.3f} s")
    rows = []

    def turns(name, shape, f_old, f_new, b_ms):
        ms = [cuda_ms(torch, f) for f in (f_old, f_new, f_new, f_old)]
        row = {"kernel": name, "shape": shape, "bound_ms": b_ms, "earlier_ms": (ms[0] + ms[3]) / 2,
               "ms": (ms[1] + ms[2]) / 2, "turns": ms}
        print(f"compare {name} {shape}: earlier {row['earlier_ms']:.4f} ms, this {row['ms']:.4f} ms "
              f"(turns {', '.join(f'{v:.4f}' for v in ms)}); bound {b_ms:.4f} ms, "
              f"{100 * share(b_ms, row['earlier_ms']):.1f}% -> {100 * share(b_ms, row['ms']):.1f}%")
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
    total = {k: sum(per[(s, torch.float32)][k] for s in shapes) for k in ("earlier_ms", "ms")}
    bound = sum(per[(s, torch.float32)]["bound_ms"] for s in shapes)
    print(f"compare bn_stats_kernel over the 53 BN inputs of one R50 forward (f32): earlier "
          f"{total['earlier_ms']:.4f} ms, this {total['ms']:.4f} ms, bound {bound:.4f} ms "
          f"({100 * share(bound, total['earlier_ms']):.1f}% -> {100 * share(bound, total['ms']):.1f}%)")
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


def seeded_model(torch, cfg, device, layers, droprate, multi_level, **options):
    """(model, variables): the registry's seeded model of cfg or, given a
    droprate, a seeded ProDA R50 cut to `layers` with the build `options`."""
    from onda_torch import registry
    from onda_torch.models import build_deeplab_v2

    if droprate is None:
        return registry.get_model(cfg, 19, device=device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_deeplab_v2(19, layers, "ProDA", multi_level=multi_level, droprate=droprate,
                                 **options)
    model = model.to(device)
    return model, registry.variables_of(model)


def make_adapter(torch, device, hw, batch, layers=(3, 4, 6, 3), droprate=None, logger=None,
                 multi_level=None, bn_policy=None, config="hybrid_switch", model=None,
                 others=None, load=None, **options):
    """The adapter of configs/<config>.yml at hw with seeded weights; the
    model multi-level as the config says unless `multi_level` is given;
    `model` a MODEL.NAME, `others` OTHERS overrides (PRECISION, REMAT) and
    `load` a MODEL.LOAD for the registry's model; `options` the build options
    of a cut model (droprate given)."""
    from onda_torch import registry
    from onda_torch.config import Config, cfg_from_file

    cfg = cfg_from_file(os.path.join(HERE, "configs", f"{config}.yml"))
    cfg.SCHEME.RESOLUTION = [hw[1], hw[0]]
    cfg.MODEL.LOAD = Config() if load is None else load
    if model is not None:
        cfg.MODEL.NAME = model
    for key, value in (others or {}).items():
        cfg.OTHERS[key] = value
    if multi_level is not None:
        cfg.MODEL.MULTI_LEVEL = multi_level
    cfg.OTHERS.GENERATE_SAMPLES_EVERY = 0
    cfg.OTHERS.SNAPSHOT_DIR = tempfile.mkdtemp(prefix="onda_smoke_")
    spec = cfg.METHOD.ADAPTATION[cfg.METHOD.ADAPTATION.NAME]
    spec.LOAD_PROTO = Config()
    spec.EPOCHS = 1
    spec.set_ = "smoke"
    if bn_policy is not None:
        spec.BN_POLICY = bn_policy
    model, variables = seeded_model(torch, cfg, device, layers, droprate,
                                    bool(cfg.MODEL.MULTI_LEVEL), **options)
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
    """Bootstrap + one step of a tiny model on the card vs the CPU: BN_POLICY
    freeze, double and keep, and a multi-level model; then one SEGMENT step."""
    hw, batch = (32, 64), 2
    src, trg = make_batches(torch, 1, batch, hw, 5), make_batches(torch, 1, batch, hw, 6)
    for bn_policy, multi_level in (("freeze", False), ("double", False), ("keep", False),
                                   ("freeze", True)):
        results = {}
        for device in ("cpu", "cuda"):
            ad = make_adapter(torch, device, hw, batch, layers=(1, 1, 1, 1), droprate=0.0,
                              multi_level=multi_level, bn_policy=bn_policy)
            ad.calculate_prototypes(src)
            step = ad.step_fn(True, 1, False)
            dev = torch.device(device)
            state, logs = step(ad.state, trg[0]["image"].to(dev), src[0]["image"][None].to(dev),
                               src[0]["label_res"][None].to(dev), 1e-3)
            stats = {k: v.cpu() for k, v in {**state.batch_stats, **{
                f"alt.{k}": v for k, v in state.alt_batch_stats.items()}}.items()
                if "running" in k}
            results[device] = (dict(logs.items()), state.params["layer6.head.1.weight"].cpu(),
                               state.proto.mean.cpu(), stats)
        (l_cpu, k_cpu, m_cpu, s_cpu), (l_gpu, k_gpu, m_gpu, s_gpu) = results["cpu"], results["cuda"]
        tag = f"small input (BN_POLICY {bn_policy}, multi_level {multi_level})"
        # the card's f32 convolutions and sums run in another order than the CPU's
        for key in ("ce_loss", "rce_loss", "regularization_loss", "buff_ce_loss",
                    "Total target loss"):
            check(math.isclose(l_cpu[key], l_gpu[key], rel_tol=1e-3, abs_tol=1e-5),
                  f"{tag}: {key} cpu {l_cpu[key]} vs cuda {l_gpu[key]}")
        check(abs(l_cpu["pseudolabel_pixel_num"] - l_gpu["pseudolabel_pixel_num"]) <= 2,
              f"{tag}: pseudo-label counts differ")
        check(torch.allclose(k_cpu, k_gpu, rtol=1e-3, atol=1e-6), f"{tag}: head kernels differ")
        check(torch.allclose(m_cpu, m_gpu, rtol=1e-3, atol=1e-5), f"{tag}: prototypes differ")
        for k, v in s_cpu.items():
            check(torch.allclose(v, s_gpu[k], rtol=1e-3, atol=1e-5), f"{tag}: {k} differs")
        print(f"{tag}, R50 cut to 1 block per stage, 32x64, b2: Total target loss cpu "
              f"{l_cpu['Total target loss']:.6f} cuda {l_gpu['Total target loss']:.6f}; "
              f"{len(s_cpu)} running-stat tensors; agree")

    small_bf16_check(torch, src[0], trg[0])

    # one SEGMENT step (multi-level: CE of both heads)
    results = {}
    for device in ("cpu", "cuda"):
        trainer = make_trainer(torch, device, hw, layers=(1, 1, 1, 1), droprate=0.0)
        dev = torch.device(device)
        loss = trainer.step(src[0]["image"].to(dev), src[0]["label"].to(dev), 1e-2)
        results[device] = (float(loss), {k: v.cpu() for k, v in trainer.params.items()},
                           {k: v.cpu() for k, v in trainer.batch_stats.items()})
    (loss_cpu, p_cpu, b_cpu), (loss_gpu, p_gpu, b_gpu) = results["cpu"], results["cuda"]
    check(math.isclose(loss_cpu, loss_gpu, rel_tol=1e-3, abs_tol=1e-5),
          f"small input SEGMENT step: loss cpu {loss_cpu} vs cuda {loss_gpu}")
    for k in ("layer6.head.1.weight", "layer5.head.1.weight"):
        check(torch.allclose(p_cpu[k], p_gpu[k], rtol=1e-3, atol=1e-6),
              f"small input SEGMENT step: {k} differs")
    for k, v in b_cpu.items():
        check(torch.allclose(v.float(), b_gpu[k].float(), rtol=1e-3, atol=1e-5),
              f"small input SEGMENT step: {k} differs")
    print(f"small input SEGMENT step (multi-level, 32x64, b2): loss cpu {loss_cpu:.6f} "
          f"cuda {loss_gpu:.6f}; both heads and {len(b_cpu)} buffers agree")
    small_adversarial_check(torch, src[0], trg[0])


# bounds of small_bf16_check: about 3x what an H100 measured against the CPU
# (PERF.md, phase 5's bf16 row), tighter than bf16's own rounding of the values
BF16_BOUNDS = {"loss_rel": 7e-3, "pl_count": 2, "update_max": 3e-4, "update_mean": 2.5e-5,
               "proto_max": 0.15, "stats_max": 9e-4}


def small_bf16_check(torch, src, trg):
    """Bootstrap and one hybrid step of the tiny model in bf16 (compute dtype
    bf16 over f32 parameters, OTHERS.PRECISION's model) on the card against
    the CPU. cuDNN's and oneDNN's bf16 convolutions both round the f32 sum,
    but single-ulp flips compound through the backbone (the CPU tests measure
    the same drift between the JAX package and the port), so the two differ
    by more than in f32; each gap is held to `BF16_BOUNDS`."""
    results = {}
    for device in ("cpu", "cuda"):
        dev = torch.device(device)
        ad = make_adapter(torch, device, (32, 64), 2, layers=(1, 1, 1, 1), droprate=0.0,
                          dtype=torch.bfloat16)
        ad.calculate_prototypes([src])
        before = ad.state.params["layer6.head.1.weight"].clone()
        dtypes = []
        hook = ad.model.layer6.register_forward_hook(lambda m, a, o: dtypes.append(o["out"].dtype))
        state, logs = ad.step_fn(True, 1, False)(
            ad.state, trg["image"].to(dev), src["image"][None].to(dev),
            src["label_res"][None].to(dev), 1e-3)
        hook.remove()
        check(set(dtypes) == {torch.bfloat16}, f"bf16 small input on {device}: logits {dtypes}")
        check(all(v.dtype == torch.float32 for v in state.params.values()),
              f"bf16 small input on {device}: a parameter is not f32")
        stats = {k: v.cpu() for k, v in state.batch_stats.items() if "running" in k}
        results[device] = ({k: float(v) for k, v in logs.items()},
                           (state.params["layer6.head.1.weight"] - before).cpu(),
                           state.proto.mean.cpu(), stats)
    (l_cpu, d_cpu, m_cpu, s_cpu), (l_gpu, d_gpu, m_gpu, s_gpu) = results["cpu"], results["cuda"]
    upd = (d_cpu - d_gpu).abs()
    gaps = {
        "loss_rel": max(abs(l_cpu[k] - l_gpu[k]) / max(abs(l_cpu[k]), 1e-3)
                        for k in ("ce_loss", "rce_loss", "regularization_loss", "buff_ce_loss",
                                  "Total target loss")),
        "pl_count": abs(l_cpu["pseudolabel_pixel_num"] - l_gpu["pseudolabel_pixel_num"]),
        "update_max": upd.max().item(), "update_mean": upd.mean().item(),
        "proto_max": (m_cpu - m_gpu).abs().max().item(),
        "stats_max": max((v - s_gpu[k]).abs().max().item() for k, v in s_cpu.items())}
    tag = "small input bf16 (OTHERS.PRECISION bf16)"
    print(f"{tag}, R50 cut to 1 block per stage, 32x64, b2: logits bf16, parameters f32 on both; "
          f"Total target loss cpu {l_cpu['Total target loss']:.6f} cuda "
          f"{l_gpu['Total target loss']:.6f}; card-vs-CPU gaps {json.dumps(gaps)} (bounds "
          f"{json.dumps(BF16_BOUNDS)}); the head's update reaches {d_cpu.abs().max().item():.3e}, "
          f"|prototypes| {m_cpu.abs().max().item():.3e}, |running stats| "
          f"{max(v.abs().max().item() for v in s_cpu.values()):.3e}")
    for key, gap in gaps.items():
        check(gap <= BF16_BOUNDS[key], f"{tag}: {key} gap {gap} over its bound {BF16_BOUNDS[key]}")


LR_D = 1e-4  # the discriminators' Adam rate in the small-input check


def check_discriminators(torch, tag, cpu, gpu):
    """Discriminator states ({"main", "main_opt", "aux", "aux_opt"}) of the
    CPU and card runs of one step. Adam's first moment (0.1 x the gradient)
    and second agree at rtol 1e-3 and the counts exactly. Its first step moves
    every weight by lr_d·g/(|g| + eps), ±lr_d unless g is within rounding of
    0, where the card and the CPU may move it differently: every weight
    agrees within 2·lr_d and at least 99.9% of them at rtol 1e-3, atol 1e-7."""
    for name in ("main", "aux"):
        opt_c, opt_g = cpu[f"{name}_opt"], gpu[f"{name}_opt"]
        check(opt_c["count"] == opt_g["count"], f"{tag}: d_{name} Adam counts differ")
        for moment, atol in (("mu", 1e-9), ("nu", 1e-12)):
            for k, v in opt_c[moment].items():
                check(torch.allclose(v, opt_g[moment][k].cpu(), rtol=1e-3, atol=atol),
                      f"{tag}: d_{name} Adam {moment} {k} differs")
        for k, v in cpu[name].items():
            w = gpu[name][k].cpu()
            close = torch.isclose(v, w, rtol=1e-3, atol=1e-7).float().mean().item()
            check((v - w).abs().max().item() <= 2 * LR_D and close >= 0.999,
                  f"{tag}: d_{name} {k} differs ({close:.6f} of the weights agree)")


def small_adversarial_check(torch, src, trg):
    """One multi-level ADVENT step and one PROTO_ADVENT step of a tiny model
    (R50 cut to one block a stage, Dropout2d off, 32x64, b2) on the card
    against the same on the CPU, from the same seeded start."""
    t = time.perf_counter()
    hw, batch = (32, 64), 2
    results = {}
    for device in ("cpu", "cuda"):
        dev = torch.device(device)
        ad = make_adapter(torch, device, hw, batch, layers=(1, 1, 1, 1), droprate=0.0,
                          multi_level=True, config="advent")
        state, logs = ad.build_step()(ad.state, src["image"].to(dev), src["label"].to(dev),
                                      trg["image"].to(dev), 1e-3, LR_D)
        d_state = {"main": state.d_main, "main_opt": state.d_main_opt, "aux": state.d_aux,
                   "aux_opt": state.d_aux_opt}
        results[device] = (dict(logs.items()), {k: v.cpu() for k, v in state.params.items()},
                           {k: v.cpu() for k, v in state.batch_stats.items()}, d_state)
    (l_cpu, p_cpu, b_cpu, d_cpu), (l_gpu, p_gpu, b_gpu, d_gpu) = results["cpu"], results["cuda"]
    tag = "small input ADVENT step (multi-level)"
    for key in ("Segmentation loss", "Adversarial loss", "Discriminator loss"):
        check(math.isclose(l_cpu[key], l_gpu[key], rel_tol=1e-3, abs_tol=1e-6),
              f"{tag}: {key} cpu {l_cpu[key]} vs cuda {l_gpu[key]}")
    for k in ("layer6.head.1.weight", "layer5.head.1.weight"):
        check(torch.allclose(p_cpu[k], p_gpu[k], rtol=1e-3, atol=1e-6), f"{tag}: {k} differs")
    for k, v in b_cpu.items():
        check(torch.allclose(v.float(), b_gpu[k].float(), rtol=1e-3, atol=1e-5), f"{tag}: {k} differs")
    check_discriminators(torch, tag, d_cpu, d_gpu)
    check(d_gpu["aux_opt"]["count"] == d_gpu["main_opt"]["count"] == 1,
          f"{tag}: the discriminators took {d_gpu['main_opt']['count']} and "
          f"{d_gpu['aux_opt']['count']} Adam steps")
    print(f"{tag}, 32x64, b2: losses cpu/cuda " + ", ".join(
        f"{k} {l_cpu[k]:.6f}/{l_gpu[k]:.6f}" for k in sorted(l_cpu))
        + f"; both heads, {len(b_cpu)} buffers and both discriminators agree")

    results = {}
    for device in ("cpu", "cuda"):
        dev = torch.device(device)
        ad = make_adapter(torch, device, hw, batch, layers=(1, 1, 1, 1), droprate=0.0,
                          config="proto_advent")
        ad.calculate_prototypes([src])
        state, d_state, logs = ad.pa_step_fn()(
            ad.state, ad.d_state, src["image"].to(dev), src["label"].to(dev),
            trg["image"].to(dev), 1e-5, LR_D)
        stats = {k: v.cpu() for k, v in {**state.batch_stats, **{
            f"alt.{k}": v for k, v in state.alt_batch_stats.items()}}.items() if "running" in k}
        results[device] = (dict(logs.items()), state.params["layer6.head.1.weight"].cpu(),
                           state.proto.mean.cpu(), stats, d_state)
    (l_cpu, k_cpu, m_cpu, s_cpu, d_cpu), (l_gpu, k_gpu, m_gpu, s_gpu, d_gpu) = (
        results["cpu"], results["cuda"])
    tag = "small input PROTO_ADVENT step"
    for key in ("Segmentation loss", "Adversarial loss", "Discriminator loss", "ce_loss",
                "rce_loss", "regularization_loss", "Total target loss"):
        check(math.isclose(l_cpu[key], l_gpu[key], rel_tol=1e-3, abs_tol=1e-5),
              f"{tag}: {key} cpu {l_cpu[key]} vs cuda {l_gpu[key]}")
    check(abs(l_cpu["pseudolabel_pixel_num"] - l_gpu["pseudolabel_pixel_num"]) <= 2,
          f"{tag}: pseudo-label counts differ")
    check(torch.allclose(k_cpu, k_gpu, rtol=1e-3, atol=1e-6), f"{tag}: head kernels differ")
    check(torch.allclose(m_cpu, m_gpu, rtol=1e-3, atol=1e-5), f"{tag}: prototypes differ")
    for k, v in s_cpu.items():
        check(torch.allclose(v, s_gpu[k], rtol=1e-3, atol=1e-5), f"{tag}: {k} differs")
    check_discriminators(torch, tag, d_cpu, d_gpu)
    print(f"{tag}, 32x64, b2: Total target loss cpu {l_cpu['Total target loss']:.6f} cuda "
          f"{l_gpu['Total target loss']:.6f}, Adversarial loss cpu "
          f"{l_cpu['Adversarial loss']:.6g} cuda {l_gpu['Adversarial loss']:.6g}; the head, "
          f"prototypes, {len(s_cpu)} running-stat tensors (main and alt) and the discriminators "
          f"agree; both adversarial checks {time.perf_counter() - t:.3f} s")


def make_trainer(torch, device, hw, layers=(3, 4, 6, 3), droprate=None, others=None):
    """A SegmentTrainer of configs/training_fog.yml (multi-level R50) at hw
    (OTHERS overrides `others`)."""
    from onda_torch.config import Config, cfg_from_file
    from onda_torch.methods.segmentation import SegmentTrainer

    cfg = cfg_from_file(os.path.join(HERE, "configs", "training_fog.yml"))
    for key, value in (others or {}).items():
        cfg.OTHERS[key] = value
    cfg.SCHEME.RESOLUTION = [hw[1], hw[0]]
    cfg.MODEL.LOAD = Config()
    cfg.OTHERS.SNAPSHOT_DIR = tempfile.mkdtemp(prefix="onda_smoke_")
    check(bool(cfg.MODEL.MULTI_LEVEL), "training_fog.yml is no longer multi-level")
    model, variables = seeded_model(torch, cfg, device, layers, droprate, multi_level=True)
    return SegmentTrainer(model, variables, cfg, cfg.METHOD.PRETRAIN.SEGMENT, 19, device=device)


def count_syncs(torch, fn):
    """fn() under the CUDA sync debug mode; returns (result, host syncs)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    return result, syncs


def profile_step(torch, fn, path, tag) -> int:
    """One call of fn (which ends at a host read) under torch.profiler: prints
    its wall time, the device's busy time (the kernel rows only: operator rows
    repeat their kernels' time) and K1's and K2's share, writes the table by
    operator to path; returns K2's device launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t_prof = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t_prof = time.perf_counter() - t_prof
    events = p.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    busy = sum(dev_us(e) for e in kernels) / 1e3
    names = {"pseudo_labels_kernel": ("pseudo_labels_kernel",),
             "bn_stats_kernel": ("bn_stats_cluster_kernel", "stats_cl_kernel", "finalize_kernel"),
             "bn passes": ("bn_apply_", "bn_grad_sums_", "bn_grad_dx_")}
    ours = {name: [e for e in kernels if any(k in e.key for k in keys)]
            for name, keys in names.items()}
    top = sorted(kernels, key=dev_us, reverse=True)[:6]
    print(f"{tag}: wall {1e3 * t_prof:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / (1e3 * t_prof):.1f}%); " +
          ", ".join(f"{k} {sum(dev_us(e) for e in v) / 1e3:.3f} ms in "
                    f"{sum(e.count for e in v)} device launches" for k, v in ours.items())
          + "; the longest kernels: " + "; ".join(
              f"{e.key[:70]} {dev_us(e) / 1e3:.3f} ms x{e.count}" for e in top))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(events.table(sort_by="cuda_time_total", row_limit=80))
    print(f"{tag}: profile written to {path}")
    return sum(e.count for e in ours["bn_stats_kernel"])


def main_path(torch, K, profile: bool, out_dir: str):
    hw, batch, steps = (512, 1024), 4, MAIN_STEPS
    logger = StepLogger()
    base = release(torch)
    print(f"main path: {base / 2**30:.3f} GiB allocated on the card before it starts")
    t0 = time.perf_counter()
    ad = make_adapter(torch, "cuda", hw, batch, logger=logger)
    check(int(ad.cfg.TRAINING.BATCH_SIZE) == batch, "hybrid_switch.yml no longer has batch 4")
    src = make_batches(torch, 2, batch, hw, 10)
    trg = make_batches(torch, steps, batch, hw, 11)
    val = make_batches(torch, 1, batch, hw, 12)
    torch.cuda.synchronize()
    print(f"main path set-up (model, state, data): {time.perf_counter() - t0:.3f} s")
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
    counts = {k: boot[k] + trained[k] + evaluated[k] for k in boot}

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
    K.reset_launches()
    (ad.state, logs), syncs = count_syncs(torch, lambda: step(ad.state, img, s_img, s_lbl, 1e-5))
    print(f"host syncs inside one step: {len(syncs)} {syncs}")
    # BatchNorm's passes a step: a forward of each teacher and of the source
    # and target slices, a backward of the two slices
    fired = float(logs["dynamic forward fired"]) > 0.5
    want_bn = {"bn_apply_kernel": 53 * (4 + fired), "bn_grad_sums_kernel": 106,
               "bn_grad_dx_kernel": 106}
    print(f"BatchNorm pass launches in one step (dynamic teacher fired: {fired}): "
          f"{dict(K.bn_launches)}")
    check(K.bn_launches == want_bn, f"BatchNorm pass launches {K.bn_launches}, expected {want_bn}")
    check(len(syncs) == 1, f"expected one host sync (the dynamic-teacher gate), got {len(syncs)}")
    check(math.isfinite(logs["Total target loss"]), "extra step: non-finite loss")

    if profile:
        def one_step():
            ad.state, logs = step(ad.state, img, s_img, s_lbl, 1e-5)
            return logs["Total target loss"]

        k2_launches = profile_step(torch, one_step, os.path.join(out_dir, "profile_step.txt"),
                                   "profiled step")
        check(k2_launches == 159, f"K2 took {k2_launches} device launches in the profiled step, "
                                  f"expected one per call (159)")
    return counts, {"step_ms": step_ms, "frames_per_s": batch / (step_ms / 1e3),
                    "peak_gib": peak / 2**30}


# ---------------------------------------------------------------------------
# phase 7: the CLI on PNG files on disk
# ---------------------------------------------------------------------------

CLI_INTENSITIES = (0, 25, 50)
CLI_FRAMES = {"train": 32, "val": 4}  # frames per intensity and set
FRAME_HW = (1024, 2048)               # Cityscapes' own frame size
PROFILE_AT = 5                        # the first step OTHERS.PROFILE traces
STEP_KEYS = ("Total target loss", "ce_loss", "rce_loss", "regularization_loss", "buff_ce_loss",
             "pseudolabel_pixel_num", "encoder_lr", "dynamic forward fired",
             "prototypes confidence ma", "Total buffer updates", "time/Batch Fetch")


def frame_image(rng, hw):
    """A smooth seeded RGB pattern with mild noise: its PNG compresses about as a
    photograph's does (white noise would decode at a cost no real frame has)."""
    import numpy as np

    h, w = hw
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        fx, fy = rng.uniform(1.0, 8.0, 2)
        px, py = rng.uniform(0.0, 2 * np.pi, 2)
        img[..., c] = (120 + 60 * np.sin(2 * np.pi * fx * x + px) * np.cos(2 * np.pi * fy * y + py)
                       + 40 * (x - y))
    img += rng.normal(0.0, 2.5, (h, w, 3)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def frame_label(rng, hw):
    """Blocks of raw Cityscapes labelIds (0-33)."""
    import numpy as np

    h, w = hw
    return np.repeat(np.repeat(rng.integers(0, 34, (8, 16), dtype=np.uint8), h // 8, 0), w // 16, 1)


def write_dataset(root, seed):
    """A seeded weather-Cityscapes tree (clear, rain/25mm, rain/50mm; labels
    shared by the intensities of a frame, as in the real dataset) and its
    metadata.json; returns (rows, bytes of image PNGs)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from onda_torch.data.metadata import Table
    from onda_torch.utils.viz import write_png

    jobs, rows = [], []
    for set_, n in CLI_FRAMES.items():
        for i in range(n):
            frame = f"city_{set_}_{i:03d}"
            lbl_rel = f"gtFine/{set_}/city/{frame}_gtFine_labelIds.png"
            jobs.append((lbl_rel, frame_label))
            for intensity in CLI_INTENSITIES:
                domain = "clear" if intensity == 0 else f"rain/{intensity}mm"
                img_rel = f"leftImg8bit/{set_}/{domain}/city/{frame}_leftImg8bit.png"
                jobs.append((img_rel, frame_image))
                rows.append({"image_path": img_rel, "label_path": lbl_rel, "set": set_,
                             "intensity": intensity})

    def write(job):
        index, (rel, make) = job
        write_png(os.path.join(root, rel), make(np.random.default_rng([seed, index]), FRAME_HW))

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        list(pool.map(write, enumerate(jobs)))
    Table(rows, ["image_path", "label_path", "set", "intensity"]).to_json(
        os.path.join(root, "metadata.json"))
    return rows, sum(os.path.getsize(os.path.join(root, r["image_path"])) for r in rows)


def read_records(snap):
    with open(os.path.join(snap, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def workflow_config(name, path, **cuts):
    """configs/<name>.yml as shipped but for `cuts` ({"A.B.C": value})."""
    import yaml

    with open(os.path.join(HERE, "configs", f"{name}.yml")) as f:
        cfg = yaml.safe_load(f)
    for key, value in cuts.items():
        node = cfg
        *parents, last = key.split(".")
        for part in parents:
            node = node[part]
        if value is None:
            node.pop(last, None)
        else:
            node[last] = value
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return cfg


def cli_config(root, snap, path, domains, **others):
    """configs/hybrid_switch.yml as shipped but for the cuts of phase 7."""
    cuts = {"SCHEME.PATH": root, "SCHEME.DOMAIN_ORDER": domains, "MODEL.LOAD": None,
            "METHOD.ADAPTATION.PROTO_ONLINE_HYBRIDSWITCH.LOAD_PROTO": None,
            "METHOD.ADAPTATION.PROTO_ONLINE_HYBRIDSWITCH.EPOCHS": 1,
            "OTHERS.SNAPSHOT_DIR": snap, "OTHERS.SCHEDULE": True}
    return workflow_config("hybrid_switch", path, **cuts, **others)


def run_cli(torch, K, cfg_path, log_path):
    """onda_torch.train_ouda.main in this process, its output into log_path;
    the launch and batch counts are reset just before and read just after.
    Returns (launches, batches, seconds, output, what main returned)."""
    from onda_torch import train_ouda
    from onda_torch.data import loader

    K.reset_launches()
    loader.reset_batches()
    t = time.perf_counter()
    with open(log_path, "w") as log:
        try:
            with contextlib.redirect_stdout(log):
                result = train_ouda.main(["--cfg", cfg_path])
        finally:
            torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    with open(log_path) as log:
        text = log.read()
    return dict(K.launches), dict(loader.BATCHES), seconds, text, result


def step_stage_ms(records):
    """Per-step host stage times from OTHERS.SCHEDULE's running averages in
    seconds (the average over steps 0..k, logged at step k, differenced);
    ms. The stages' device keys (`time/... device`, already ms) are left out."""
    out = {}
    for key in [k for k in records[0] if k.startswith("time/") and not k.endswith(" device")]:
        avg = [r[key] for r in records]
        out[key] = [1e3 * ((k + 1) * avg[k] - k * avg[k - 1] if k else avg[0]) for k in range(len(avg))]
    return out


def prep_rate(root, rows, workers, batch=4, repeats=5):
    """The C++ prep alone: images and labels per second for one batch at
    `workers` threads (files in the page cache)."""
    import numpy as np
    from onda_torch.data.metadata import load_dataset_info
    from onda_torch.data.segmentation import LabelMapper
    from onda_torch.native import BatchExecutor

    info = load_dataset_info()
    lut = LabelMapper(dict(tuple(p) for p in info["label2train"])).lut
    pick = [r for r in rows if r["set"] == "train" and r["intensity"] == 25][:batch]
    images = [os.path.join(root, r["image_path"]) for r in pick]
    labels = [os.path.join(root, r["label_path"]) for r in pick]
    ex = BatchExecutor(workers)
    img = np.empty((batch, 3, 512, 1024), np.float32)
    full, res = np.empty((batch, 512, 1024), np.int32), np.empty((batch, 65, 129), np.int32)
    times = {"images": [], "labels": []}
    for _ in range(repeats):
        t = time.perf_counter()
        ex.wait(ex.submit_images(images, (512, 1024), info["mean"], info["std"], img), images)
        times["images"].append(time.perf_counter() - t)
        t = time.perf_counter()
        ex.wait(ex.submit_labels(labels, (512, 1024), (65, 129), lut, full, res), labels)
        times["labels"].append(time.perf_counter() - t)
    ex.close()
    return {k: batch / statistics.median(v) for k, v in times.items()}


def cli_path(torch, K, out_dir, in_memory_fps, work, root, rows):
    """Phase 7: the shipped config through `onda_torch.train_ouda.main` on the
    seeded dataset of PNG files at `root`, then a resumed run that inserts
    into the replay buffer. Returns the launch counts of both runs and the
    numbers."""
    snap = os.path.join(work, "snapshots")
    cfg = cli_config(root, snap, os.path.join(work, "run1.yml"), [[25], [50]],
                     **{"OTHERS.PROFILE": 2})
    workers = int(cfg["OTHERS"]["NUM_WORKERS"])
    batch = int(cfg["TRAINING"]["BATCH_SIZE"])
    print("phase 7 run 1: configs/hybrid_switch.yml with the cuts SCHEME.PATH=<the dataset>, "
          "DOMAIN_ORDER=[[25], [50]], EPOCHS=1, MODEL.LOAD and LOAD_PROTO unset, "
          "SNAPSHOT_DIR=<temporary>, OTHERS.SCHEDULE=true, OTHERS.PROFILE=2; as shipped: "
          f"b{batch}, {cfg['SCHEME']['RESOLUTION']}, REPLAY_BUFFER "
          f"{cfg['TRAINING']['REPLAY_BUFFER']}, NUM_WORKERS {workers}, "
          f"GENERATE_SAMPLES_EVERY {cfg['OTHERS']['GENERATE_SAMPLES_EVERY']}, "
          f"VALIDATION {cfg['OTHERS']['VALIDATION']}")
    rates = prep_rate(root, rows, workers)
    print(f"host prep alone (C++ executor, {workers} threads, one batch of {batch}, files in "
          f"the page cache): {rates['images']:.3f} images/s, {rates['labels']:.3f} labels/s")

    launches, batches, seconds, text, _ = run_cli(torch, K, os.path.join(work, "run1.yml"),
                                                  os.path.join(out_dir, "cli_run1.log"))
    records = read_records(snap)
    n_run1 = len(records)
    steps_per_domain = CLI_FRAMES["train"] // batch
    steps = 2 * steps_per_domain
    n_src = min(int(cfg["TRAINING"]["REPLAY_BUFFER"]), CLI_FRAMES["train"])
    boot = n_src // batch  # the source loader drops the last partial batch
    print(f"phase 7 run 1: {seconds:.3f} s; launches {launches}; batches made {batches}")
    want = {"pseudo_labels_kernel": 2 * steps, "bn_stats_kernel": 159 * steps + 53 * boot}
    check(launches == want, f"CLI run launches {launches}, expected {want} "
                            f"(K1 2/step, K2 159/step + 53 per bootstrap batch)")
    check(batches.get("collate", 0) == 0 and batches.get("executor", 0) > 0,
          f"every batch must come from the C++ executor, got {batches}")
    step_records = [r for r in records if "Total target loss" in r]
    check(len(step_records) == steps, f"{len(step_records)} step records, expected {steps}")
    for r in step_records:
        for key, value in r.items():
            check("loss" not in key or math.isfinite(value), f"step {r['_step']}: {key} = {value}")
        missing = [k for k in STEP_KEYS if k not in r]
        check(not missing, f"step record {r['_step']} lacks {missing}")
    keys = set().union(*records)
    for prefix in ("Adaptation frames per second", "Val mIoU model of ", "Condition "):
        check(any(k.startswith(prefix) for k in keys), f"metrics.jsonl has no {prefix!r} key")
    files = os.listdir(snap)
    samples = os.listdir(os.path.join(snap, "samples"))
    n_val_sets = len(CLI_INTENSITIES)
    check("adapt_state.pt" in files, "no adapt_state.pt")
    check(any(f.startswith("proto_") and f.endswith(".pickle") for f in files), "no proto pickle")
    check("model_train_[[0]]_after_src_training.pth" in files, f"no source .pth in {files}")
    check(len(samples) == 2 * n_val_sets * CLI_FRAMES["val"],
          f"{len(samples)} sample PNGs, expected {2 * n_val_sets * CLI_FRAMES['val']}")

    fps = [r["Adaptation frames per second"] for r in step_records
           if "Adaptation frames per second" in r]
    print("phase 7 CLI from disk: Adaptation frames per second per domain "
          + ", ".join(f"{v:.3f}" for v in fps)
          + f"; phase 6 in memory {in_memory_fps:.3f} frames/s")
    stages = {}
    for d in range(2):
        per = step_stage_ms(step_records[d * steps_per_domain:(d + 1) * steps_per_domain])
        for key, ms in per.items():
            stages.setdefault(key, []).append(ms)
        print(f"phase 7 domain {d}: per-step stage ms (steps 0..{steps_per_domain - 1}): "
              + "; ".join(f"{k[5:]} " + ", ".join(f"{v:.3f}" for v in ms) for k, ms in per.items()))
    # steps 1..4 of each domain: step 0 warms up, 5 and 6 are profiled (the
    # trace starts in 5's Batch Fetch and is written in 6's Host Work), 7
    # evaluates, renders samples and checkpoints
    clean = slice(1, PROFILE_AT)
    median = {k[5:]: statistics.median(x for ms in v for x in ms[clean]) for k, v in stages.items()}
    step_ms = statistics.median(sum(col) for v in zip(*stages.values())
                                for col in zip(*(ms[clean] for ms in v)))
    print("phase 7 median stage ms over steps 1..4 of both domains: "
          + ", ".join(f"{k} {v:.3f}" for k, v in median.items())
          + f"; their sum {step_ms:.3f} ms per step, {batch / (step_ms / 1e3):.3f} frames/s")
    with open(os.path.join(snap, "profile", "summary.json")) as f:
        prof = json.load(f)
    print(f"phase 7 profiled steps 5-6 of domain 1 (torch.profiler): wall {prof['wall_ms']:.3f} ms, "
          f"kernels {prof['kernel_ms']:.3f} ms ({100 * prof['kernel_share']:.1f}% busy, "
          f"{100 * (1 - prof['kernel_share']):.1f}% idle), copies {prof['copy_ms']:.3f} ms")
    shutil.copy(os.path.join(snap, "profile", "profile.txt"),
                os.path.join(out_dir, "cli_profile.txt"))

    cli_config(root, snap, os.path.join(work, "run2.yml"), [[25]], **{
        "OTHERS.AUTO_RESUME": True, "TRAINING.BUFFER_DYNAMIC": True,
        "TRAINING.PERC_FILL_PER_DOMAIN": 1.0})
    launches2, _, seconds2, text2, _ = run_cli(torch, K, os.path.join(work, "run2.yml"),
                                               os.path.join(out_dir, "cli_run2.log"))
    records2 = read_records(snap)[n_run1:]
    inserted = sum(r.get("Total buffer updates", 0) for r in records2)
    resumed = [line for line in text2.splitlines() if line.startswith("AUTO_RESUME: restoring")]
    buffer_line = [line for line in text2.splitlines() if line.startswith("Buffer size:")]
    fps2 = [r["Adaptation frames per second"] for r in records2 if "Adaptation frames per second" in r]
    print(f"phase 7 run 2 (run 1's cuts but no PROFILE; AUTO_RESUME, BUFFER_DYNAMIC, "
          f"PERC_FILL_PER_DOMAIN 1.0, DOMAIN_ORDER [[25]]): {seconds2:.3f} s; {resumed[:1]} "
          f"{buffer_line[:1]}; launches {launches2}; buffer insertions {inserted}; "
          f"Adaptation frames per second {', '.join(f'{v:.3f}' for v in fps2)}")
    check(resumed, "the second run did not resume")
    want2 = {"pseudo_labels_kernel": 2 * steps_per_domain, "bn_stats_kernel": 159 * steps_per_domain}
    check(launches2 == want2, f"resumed run launches {launches2}, expected {want2} (no bootstrap)")
    check(inserted > 0, "the resumed run inserted nothing into the replay buffer")
    summary = {"cli_frames_per_s": fps, "cli_resumed_frames_per_s": fps2,
               "in_memory_frames_per_s": in_memory_fps, "stage_ms_median": median,
               "steady_step_ms": step_ms, "steady_frames_per_s": batch / (step_ms / 1e3),
               "prep_images_per_s": rates["images"], "prep_labels_per_s": rates["labels"],
               "profile": prof, "buffer_insertions": inserted}
    return [launches, launches2], summary


# ---------------------------------------------------------------------------
# phase 8: the workflow (SEGMENT pretraining, adaptation, EVALUATION)
# ---------------------------------------------------------------------------

# phase 7's frames under fog visibilities: 0 is the clear frame, 75 and 375
# the 25 mm ones, 150 and 750 the 50 mm ones (no new image is written)
FOG_OF_RAIN = {0: (0,), 25: (75, 375), 50: (150, 750)}
SEGMENT_EPOCHS = 4          # 8 steps an epoch: 32 SEGMENT steps at 128x64
SEGMENT_TIMED_STEPS = 8     # phase 8.5, after 2 warm-up steps
MAIN_HW = (512, 1024)       # the adaptation's input size, (H, W)


def write_fog_metadata(root, rows):
    """metadata_fog.json beside phase 7's metadata.json, over the same files."""
    from onda_torch.data.metadata import Table

    fog = [dict(r, intensity=v) for r in rows for v in FOG_OF_RAIN[r["intensity"]]]
    Table(fog, ["image_path", "label_path", "set", "intensity"]).to_json(
        os.path.join(root, "metadata_fog.json"))


def timed_ms(torch, fn, warmup, n):
    """Host wall ms of each of n calls of fn (each ends in a device sync), after warmup."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    return times


def aux_head_cost(torch, adapter, one_step):
    """--aux-cost: the offline_fog step as it is (aux head skipped) and with the
    head computed in every forward and thrown away, timed in turns (skipped,
    computed, computed, skipped); returns the median ms of each."""
    forward = adapter.model.forward
    turns = {"skipped": [], "computed": []}
    try:
        for mode in ("skipped", "computed", "computed", "skipped"):
            adapter.model.forward = (forward if mode == "skipped" else
                                     lambda x, **kw: forward(x, **{**kw, "with_aux": True}))
            turns[mode] += timed_ms(torch, lambda: one_step()["Total target loss"], warmup=1, n=3)
    finally:
        adapter.model.forward = forward
    aux_ms = {k: statistics.median(v) for k, v in turns.items()}
    print(f"phase 8.2 the same step with the aux head computed and discarded, in turns: "
          f"median {aux_ms['computed']:.3f} ms against {aux_ms['skipped']:.3f} ms skipped "
          f"({aux_ms['computed'] - aux_ms['skipped']:+.3f} ms)")
    return aux_ms


def workflow_path(torch, K, out_dir, work, root, rows, aux_cost=False):
    """Phase 8: training_fog.yml (SEGMENT) → offline_fog.yml (adaptation from
    its .pth) → validation_offline_fog.yml (EVALUATION of the adaptation's
    snapshot, then OTHERS.EVAL_SWEEP) → validation.yml (PREDICTION_SAVE),
    each through `onda_torch.train_ouda.main` on phase 7's PNG files, then a
    SEGMENT step timed in memory at 1024x512. Returns launch counts by path,
    the numbers and 8.1's `.pth`."""
    from onda_torch.utils.checkpoint import checkpoints_by_mtime

    write_fog_metadata(root, rows)
    n_train, n_val = CLI_FRAMES["train"], CLI_FRAMES["val"]
    paths, summary = {}, {}

    def cli(name):
        return run_cli(torch, K, os.path.join(work, f"{name}.yml"),
                       os.path.join(out_dir, f"workflow_{name}.log"))

    # 8.1 training_fog.yml: SEGMENT at its own 128x64, multi-level
    snap1 = os.path.join(work, "fog_source_model")
    cfg = workflow_config("training_fog", os.path.join(work, "segment.yml"), **{
        "SCHEME.PATH": root, "SCHEME.DOMAIN_ORDER": [[750]], "MODEL.LOAD": None,
        "METHOD.PRETRAIN.SEGMENT.EPOCHS": SEGMENT_EPOCHS, "OTHERS.SNAPSHOT_DIR": snap1,
        "METHOD.ADAPTATION.PROTO_ONLINE_HYBRIDSWITCH.LOAD_PROTO": None})
    batch = int(cfg["TRAINING"]["BATCH_SIZE"])
    check(cfg["MODEL"]["MULTI_LEVEL"] and cfg["SCHEME"]["RESOLUTION"] == [128, 64],
          "training_fog.yml is no longer multi-level at 128x64")
    launches, batches, seconds, text, adapter = cli("segment")
    seg_steps = SEGMENT_EPOCHS * (n_train // batch)
    boot = min(int(cfg["TRAINING"]["REPLAY_BUFFER"]), n_train) // batch
    check(int(cfg["METHOD"]["ADAPTATION"]["PROTO_ONLINE_HYBRIDSWITCH"]["EPOCHS"]) == 0,
          "training_fog.yml's adaptation no longer has EPOCHS 0")
    want = {"pseudo_labels_kernel": 0, "bn_stats_kernel": 53 * (seg_steps + boot)}
    print(f"phase 8.1 training_fog.yml (SEGMENT, {SEGMENT_EPOCHS} epochs of {n_train // batch} "
          f"steps, b{batch} 128x64, multi-level; then the adaptation's bootstrap of {boot} batches "
          f"and evaluation, EPOCHS 0 as shipped): {seconds:.3f} s; launches {launches}; "
          f"batches {batches}")
    check(launches == want, f"SEGMENT run launches {launches}, expected {want} "
                            f"(K2 53 per SEGMENT step and per bootstrap batch, K1 0)")
    check(batches.get("collate", 0) == 0, f"every batch must come from the C++ executor: {batches}")
    records = read_records(snap1)
    seg = [r["Segmentation loss"] for r in records if "Segmentation loss" in r]
    check(len(seg) == -(-seg_steps // 10) and all(math.isfinite(v) for v in seg),
          f"Segmentation loss records {seg}")
    epochs = [r for r in records if "epoch" in r]
    val_sets = ["(0,)", "(750,)"]
    want_keys = {f"{k} of {v}" for v in val_sets for k in ("Val mIoU", "Val std IoU", "val entropy")}
    check(len(epochs) == SEGMENT_EPOCHS and all(want_keys <= set(r) for r in epochs),
          f"epoch records lack {want_keys - set(epochs[-1]) if epochs else want_keys}")
    check(all(math.isfinite(r[k]) for r in epochs for k in want_keys), "non-finite epoch metrics")
    trained = torch.load(os.path.join(snap1, "model_train_[[0]].pth"))
    after_path = os.path.join(snap1, "model_train_[[0]]_after_src_training.pth")
    after = torch.load(after_path)
    start = {**adapter.state.static_params, **adapter.state.static_batch_stats}
    for k, v in after.items():
        check(torch.equal(trained[k], v), f"{k}: model_train_[[0]].pth != _after_src_training.pth")
        check(torch.equal(start[k].cpu(), v), f"{k}: the adaptation did not start from the .pth")
    print(f"phase 8.1: Segmentation loss {', '.join(f'{v:.4f}' for v in seg)}; last epoch "
          + ", ".join(f"{k} {epochs[-1][k]:.4f}" for k in sorted(want_keys))
          + "; model_train_[[0]].pth = _after_src_training.pth = the adaptation's start")
    paths["segment_cli"] = launches
    summary["segment_cli_seconds"] = seconds
    del adapter, trained, start

    # 8.2 offline_fog.yml: adaptation from 8.1's .pth at 1024x512, multi-level
    snap2 = os.path.join(work, "offline_fog")
    cfg = workflow_config("offline_fog", os.path.join(work, "offline.yml"), **{
        "SCHEME.PATH": root, "SCHEME.DOMAIN_ORDER": [[750]], "MODEL.LOAD": after_path,
        "METHOD.ADAPTATION.PROTO_ONLINE.EPOCHS": 1, "OTHERS.SNAPSHOT_DIR": snap2,
        "OTHERS.SCHEDULE": True})
    spec = cfg["METHOD"]["ADAPTATION"]["PROTO_ONLINE"]
    check(cfg["MODEL"]["MULTI_LEVEL"] and not spec["SKIP_PROTO_EVAL"], "offline_fog.yml changed")
    launches, batches, seconds, text, adapter = cli("offline")
    steps = n_train // batch
    boot = n_train // batch  # REPLAY_BUFFER 1.0: every source row
    val_batches = len(val_sets) * -(-n_val // batch)
    evals = 2  # before the epoch (SKIP_CALC false) and after it
    want = {"pseudo_labels_kernel": 2 * steps + evals * val_batches,
            "bn_stats_kernel": 159 * steps + 53 * boot}
    print(f"phase 8.2 offline_fog.yml (PROTO_ONLINE, multi-level, b{batch} "
          f"{'x'.join(map(str, cfg['SCHEME']['RESOLUTION']))}, MODEL.LOAD = 8.1's .pth, "
          f"{steps} steps): {seconds:.3f} s; launches {launches}")
    check(launches == want, f"offline_fog run launches {launches}, expected {want} (K1 2/step + "
                            f"1 per validation batch, K2 159/step + 53 per bootstrap batch)")
    records = read_records(snap2)
    step_records = [r for r in records if "Total target loss" in r]
    check(len(step_records) == steps, f"{len(step_records)} step records for {steps} steps")
    for r in step_records:
        for key, value in r.items():
            check("loss" not in key or math.isfinite(value), f"offline_fog {key} = {value}")
    stage = step_stage_ms(step_records)
    # one step of the adapter the CLI returned, on device tensors: its host
    # syncs (the dynamic teacher's gate, absent at DYNAMIC_LAMBDA 0) and
    # whether the aux head ran
    aux_calls = []
    hook = adapter.model.layer5.register_forward_pre_hook(lambda m, a: aux_calls.append(1))
    src = make_batches(torch, 1, batch, MAIN_HW, 20)[0]
    trg = make_batches(torch, 1, batch, MAIN_HW, 21)[0]
    img, s_img, s_lbl = (trg["image"].cuda(), src["image"][None].cuda(),
                         src["label_res"][None].cuda())
    step = adapter.step_fn(True, 1, False)

    def one_step():
        adapter.state, logs = step(adapter.state, img, s_img, s_lbl, 1e-5)
        return logs

    K.reset_launches()
    logs, syncs = count_syncs(torch, one_step)
    one = dict(K.launches)
    want_syncs = 1 if float(spec["DYNAMIC_LAMBDA"]) > 0 else 0
    print(f"phase 8.2 one step: launches {one}, host syncs {len(syncs)} {syncs}, aux head "
          f"forwards {len(aux_calls)}")
    check(one == {"pseudo_labels_kernel": 2, "bn_stats_kernel": 159}, f"one step launched {one}")
    check(len(syncs) == want_syncs, f"expected {want_syncs} host syncs per step (the dynamic "
                                    f"teacher's gate; DYNAMIC_LAMBDA {spec['DYNAMIC_LAMBDA']})")
    check(math.isfinite(logs["Total target loss"]), "offline_fog extra step: non-finite loss")
    with torch.no_grad():
        aux, _ = adapter.model(img[:1, :, :64, :128])
    check(not aux_calls[:-1] and len(aux_calls) == 1 and aux is not None,
          f"the step ran the aux head ({len(aux_calls) - 1} times) or a plain forward skipped it")
    hook.remove()
    times = timed_ms(torch, lambda: one_step()["Total target loss"], warmup=1, n=5)
    step_ms = statistics.median(times)
    if aux_cost:
        summary["offline_fog_aux_turns_ms"] = aux_head_cost(torch, adapter, one_step)
    print(f"phase 8.2 offline_fog step in memory (static teacher, no dynamic one, multi-level "
          f"model, aux head skipped): {', '.join(f'{t:.3f}' for t in times)} ms; median "
          f"{step_ms:.3f} ms, {batch / (step_ms / 1e3):.3f} frames/s; CLI steady stages "
          + "; ".join(f"{k[5:]} {statistics.median(v[1:-1]):.3f} ms" for k, v in stage.items()))
    paths["multi_level_cli"] = launches
    summary.update(offline_fog_step_ms=step_ms, offline_fog_frames_per_s=batch / (step_ms / 1e3),
                   offline_fog_cli_seconds=seconds)
    del adapter, img, s_img, s_lbl, step

    # 8.3 validation_offline_fog.yml on 8.2's snapshots, then EVAL_SWEEP
    workflow_config("validation_offline_fog", os.path.join(work, "evaluation.yml"), **{
        "SCHEME.PATH": root, "MODEL.LOAD": None, "OTHERS.SNAPSHOT_DIR": snap2})
    n_records = len(read_records(snap2))
    launches, _, seconds, text, runner = cli("evaluation")
    eval_sets = 1 + 4  # the source and DOMAIN_ORDER's four visibilities, one batch each
    loaded = [line for line in text.splitlines() if line.endswith("is being loaded")]
    print(f"phase 8.3 validation_offline_fog.yml: {seconds:.3f} s; {loaded}; launches {launches}")
    check(loaded == [f"Model {os.path.join(snap2, 'adapt_state.pt')} is being loaded"],
          f"EVALUATION loaded {loaded}, not 8.2's adapt_state.pt")
    check(launches == {"pseudo_labels_kernel": eval_sets, "bn_stats_kernel": 0},
          f"EVALUATION launches {launches}, expected K1 one per validation batch ({eval_sets}), K2 0")
    result = read_records(snap2)[n_records:]
    miou = {k: v for r in result for k, v in r.items() if k.startswith("Val mIoU")}
    check(len(miou) == 2 * eval_sets and all(math.isfinite(v) for v in miou.values()),
          f"EVALUATION mIoU keys {miou}")
    print(f"phase 8.3 mIoU: {json.dumps(miou)}")
    paths["evaluation_cli"] = launches
    del runner

    workflow_config("validation_offline_fog", os.path.join(work, "sweep.yml"), **{
        "SCHEME.PATH": root, "MODEL.LOAD": None, "OTHERS.SNAPSHOT_DIR": snap2, "OTHERS.EVAL_SWEEP": True})
    files = [p.name for p in checkpoints_by_mtime(snap2)]
    launches, _, seconds, text, runner = cli("sweep")
    swept = [line.split()[1] for line in text.splitlines() if line.startswith("sweep: ")]
    best = [line for line in text.splitlines() if line.startswith("best: ")]
    print(f"phase 8.3 EVAL_SWEEP over {files}: {seconds:.3f} s; swept {swept}; {best}; "
          f"launches {launches}")
    check(swept == files and best, f"the sweep evaluated {swept}, the directory holds {files}")
    check(launches == {"pseudo_labels_kernel": eval_sets * len(files), "bn_stats_kernel": 0},
          f"EVAL_SWEEP launches {launches}")
    paths["sweep_cli"] = launches
    del runner

    # 8.4 validation.yml: PREDICTION_SAVE of every target batch
    preds = os.path.join(work, "predictions")
    cfg = workflow_config("validation", os.path.join(work, "predictions.yml"), **{
        "SCHEME.PATH": root, "MODEL.LOAD": None, "OTHERS.SNAPSHOT_DIR": snap2,
        "METHOD.PRETRAIN.EVALUATION.PREDICTION_SAVE": preds})
    launches, _, seconds, text, runner = cli("predictions")
    domains = cfg["SCHEME"]["DOMAIN_ORDER"]
    dumped = {str(tuple(d)): sorted(os.listdir(os.path.join(preds, "_".join(str(tuple(d))))))
              for d in domains}
    per_domain = -(-n_train // batch)
    w, h = cfg["SCHEME"]["RESOLUTION"]
    out_shape = (batch, 19, h // 8 + 1, w // 8 + 1)
    print(f"phase 8.4 validation.yml (PREDICTION_SAVE, {len(domains)} target domains): "
          f"{seconds:.3f} s; launches {launches}; files per domain "
          f"{ {k: len(v) for k, v in dumped.items()} } of shape {out_shape}")
    check(launches == {"pseudo_labels_kernel": 0, "bn_stats_kernel": 0},
          f"PREDICTION_SAVE launched kernels {launches}")
    for d, names in dumped.items():
        check(names == sorted(f"batch-{i}.pt" for i in range(per_domain)), f"{d}: files {names}")
        for name in names:
            logits = torch.load(os.path.join(preds, "_".join(d), name))
            check(tuple(logits.shape) == out_shape and bool(torch.isfinite(logits).all()),
                  f"{d}/{name}: shape {tuple(logits.shape)} or non-finite values")
    paths["predictions_cli"] = launches
    del runner

    # 8.5 one SEGMENT step at the adaptation's 1024x512, b4, in memory
    base = release(torch)
    trainer = make_trainer(torch, "cuda", MAIN_HW)
    data = make_batches(torch, 1, batch, MAIN_HW, 22)[0]
    img, lbl = data["image"].cuda(), data["label"].cuda()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    times = timed_ms(torch, lambda: float(trainer.step(img, lbl, 2.5e-4)), warmup=2,
                     n=SEGMENT_TIMED_STEPS)
    launches = dict(K.launches)
    peak = torch.cuda.max_memory_allocated()
    n_steps = 2 + SEGMENT_TIMED_STEPS
    check(launches == {"pseudo_labels_kernel": 0, "bn_stats_kernel": 53 * n_steps},
          f"SEGMENT steps launched {launches}, expected K2 53 per step")
    seg_ms = statistics.median(times)
    print(f"phase 8.5 SEGMENT step in memory (training_fog.yml's multi-level R50, b{batch} "
          f"{MAIN_HW[1]}x{MAIN_HW[0]}, both heads' CE): {', '.join(f'{t:.3f}' for t in times)} ms; median "
          f"{seg_ms:.3f} ms, {batch / (seg_ms / 1e3):.3f} frames/s, peak memory "
          f"{peak / 2**30:.3f} GiB (max_memory_allocated; {base / 2**30:.3f} GiB were allocated "
          f"before the trainer was made); launches {launches}")
    paths["segment_in_memory"] = launches
    summary.update(segment_step_ms=seg_ms, segment_frames_per_s=batch / (seg_ms / 1e3),
                   segment_peak_gib=peak / 2**30)
    del trainer, img, lbl
    release(torch)
    return paths, summary, after_path


# ---------------------------------------------------------------------------
# phase 9: the adversarial family (ADVENT, its EVALUATION, PROTO_ADVENT)
# ---------------------------------------------------------------------------

ADVERSARIAL_TIMED_STEPS = 5  # phase 9.4, after 1 warm-up step


def discriminator_cost(torch, ad, batch):
    """Device ms of one discriminator's share of a step at the input size:
    the student's adversarial BCE forward and its backward to the entropy map
    (`fool_loss`), and the discriminator's own loss, two forwards and the
    weights' backward (`discriminator_loss`). ADVENT (multi-level) runs each
    twice a step, PROTO_ADVENT once."""
    from onda_torch.methods.advent import discriminator_loss, fool_loss

    g = torch.Generator(device=ad.device).manual_seed(32)
    h, w = MAIN_HW
    ent = torch.rand(batch, 19, h, w, device=ad.device, generator=g).requires_grad_(True)
    d = ad.state.d_main

    def fool():
        torch.autograd.grad(fool_loss(ad.disc, d, ent), [ent])

    def events_ms(fn, n=10):
        # CUDA events around n back-to-back calls after two warm-up calls
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    def d_loss():
        discriminator_loss(ad.disc, d, ent, ent)

    # events around back-to-back calls read the host's queueing too where a
    # call syncs, so the syncs are counted beside the times
    cost = {"fool_fwd_bwd": events_ms(fool), "discriminator_loss": events_ms(d_loss),
            "host_syncs": len(count_syncs(torch, fool)[1]) + len(count_syncs(torch, d_loss)[1])}
    print(f"phase 9.4 one discriminator at b{batch} {w}x{h}: adversarial BCE forward and backward "
          f"to the map {cost['fool_fwd_bwd']:.3f} ms, discriminator loss (two forwards, weight "
          f"backward) {cost['discriminator_loss']:.3f} ms (CUDA events around 10 back-to-back "
          f"calls); host syncs in one call of each {cost['host_syncs']}")
    return cost


def adversarial_path(torch, K, out_dir, work, root, pth, profile=False):
    """Phase 9: advent.yml (from phase 8.1's multi-level `.pth`) →
    validation_offline_advent.yml on its snapshot → proto_advent.yml, each
    through `onda_torch.train_ouda.main` on phase 7's rain files, then one
    step of each method timed in memory at 1024x512, b4 (with `profile`, one
    more step of each under torch.profiler). Returns launch counts by path
    and the numbers."""
    t_phase = time.perf_counter()
    paths, summary = {}, {}
    n_train, n_val = CLI_FRAMES["train"], CLI_FRAMES["val"]

    def cli(name):
        return run_cli(torch, K, os.path.join(work, f"{name}.yml"),
                       os.path.join(out_dir, f"adversarial_{name}.log"))

    # 9.1 advent.yml: one mixed domain, multi-level, from 8.1's .pth
    snap = os.path.join(work, "advent")
    cfg = workflow_config("advent", os.path.join(work, "advent.yml"), **{
        "SCHEME.PATH": root, "SCHEME.DOMAIN_ORDER": [[25, 50]], "MODEL.LOAD": pth,
        "METHOD.ADAPTATION.ADVENT.EPOCHS": 1, "OTHERS.SNAPSHOT_DIR": snap})
    batch = int(cfg["TRAINING"]["BATCH_SIZE"])
    check(cfg["MODEL"]["MULTI_LEVEL"] and cfg["SCHEME"]["RESOLUTION"] == [1024, 512]
          and batch == 4, "advent.yml is no longer multi-level at b4 1024x512")
    launches, batches, seconds, text, adapter = cli("advent")
    steps = 2 * n_train // batch  # both intensities' train frames, one epoch
    want = {"pseudo_labels_kernel": 0, "bn_stats_kernel": 106 * steps}
    print(f"phase 9.1 advent.yml (ADVENT, multi-level, b{batch} 1024x512, DOMAIN_ORDER "
          f"[[25, 50]], MODEL.LOAD = 8.1's .pth, REPLAY_BUFFER "
          f"{cfg['TRAINING']['REPLAY_BUFFER']}, {steps} steps): {seconds:.3f} s; launches "
          f"{launches}; batches {batches}")
    check(launches == want, f"advent.yml launches {launches}, expected {want} (K2 106 per step)")
    check(batches.get("collate", 0) == 0, f"every batch must come from the C++ executor: {batches}")
    records = read_records(snap)
    step_records = [r for r in records if "Adversarial loss" in r]
    check(len(step_records) == steps, f"{len(step_records)} ADVENT step records for {steps} steps")
    losses = ("Segmentation loss", "Adversarial loss", "Discriminator loss")
    for r in step_records:
        for key in losses:
            check(math.isfinite(r[key]), f"advent.yml step {r['_step']}: {key} = {r[key]}")
    print("phase 9.1 losses per step (Segmentation / Adversarial / Discriminator): " + "; ".join(
        "/".join(f"{r[k]:.5g}" for k in losses) for r in step_records))
    state = torch.load(os.path.join(snap, "advent_state.pt"), map_location="cpu", weights_only=False)
    counts = {k: state[k]["count"] for k in ("d_main_opt", "d_aux_opt")}
    print(f"phase 9.1 advent_state.pt keys {sorted(state)}; Adam counts {counts}; step "
          f"{state['step']}")
    check({"params", "batch_stats", "opt_momentum", "d_aux", "d_aux_opt", "d_main", "d_main_opt",
           "generator", "step"} <= set(state), f"advent_state.pt holds {sorted(state)}")
    check(counts == {"d_main_opt": steps, "d_aux_opt": steps} and state["step"] == steps,
          f"advent_state.pt: Adam counts {counts}, step {state['step']}, expected {steps}")
    paths["advent_cli"] = launches
    summary["advent_cli_seconds"] = seconds
    del adapter, state

    # 9.2 validation_offline_advent.yml on 9.1's snapshot directory
    cfg = workflow_config("validation_offline_advent", os.path.join(work, "advent_eval.yml"), **{
        "SCHEME.PATH": root, "SCHEME.DOMAIN_ORDER": [[25], [50]], "MODEL.LOAD": None,
        "OTHERS.SNAPSHOT_DIR": snap})
    check(not cfg["METHOD"]["ADAPTATION"]["PROTO_ONLINE"]["SKIP_PROTO_EVAL"],
          "validation_offline_advent.yml no longer evaluates the prototypes")
    n_records = len(read_records(snap))
    launches, _, seconds, text, runner = cli("advent_eval")
    val_batches = 3 * -(-n_val // batch)  # the source and the two target sets
    loaded = [line for line in text.splitlines() if line.endswith("is being loaded")]
    result = read_records(snap)[n_records:]
    miou = {k: v for r in result for k, v in r.items() if k.startswith("Val mIoU")}
    print(f"phase 9.2 validation_offline_advent.yml: {seconds:.3f} s; {loaded}; launches "
          f"{launches} ({launches['pseudo_labels_kernel'] / val_batches:g} K1 per validation "
          f"batch); mIoU keys {sorted(miou)}")
    check(loaded == [f"Model {os.path.join(snap, 'advent_state.pt')} is being loaded"],
          f"EVALUATION loaded {loaded}, not 9.1's advent_state.pt")
    check(launches == {"pseudo_labels_kernel": val_batches, "bn_stats_kernel": 0},
          f"EVALUATION launches {launches}, expected K1 one per validation batch ({val_batches})")
    check(len(miou) == 2 * 3 and all(math.isfinite(v) for v in miou.values()),
          f"EVALUATION mIoU {miou}")
    paths["advent_evaluation_cli"] = launches
    summary["advent_evaluation_seconds"] = seconds
    del runner

    # 9.3 proto_advent.yml: two domains, seeded weights, bootstrapped prototypes
    snap = os.path.join(work, "proto_advent")
    cfg = workflow_config("proto_advent", os.path.join(work, "proto_advent.yml"), **{
        "SCHEME.PATH": root, "SCHEME.DOMAIN_ORDER": [[25], [50]], "MODEL.LOAD": None,
        "METHOD.ADAPTATION.PROTO_ADVENT.LOAD_PROTO": None,
        "METHOD.ADAPTATION.PROTO_ADVENT.EPOCHS": 1, "OTHERS.SNAPSHOT_DIR": snap})
    launches, _, seconds, text, adapter = cli("proto_advent")
    steps = 2 * (n_train // batch)
    boot = min(int(cfg["TRAINING"]["REPLAY_BUFFER"]), n_train) // batch
    want = {"pseudo_labels_kernel": 2 * steps, "bn_stats_kernel": 159 * steps + 53 * boot}
    records = read_records(snap)
    step_records = [r for r in records if "Adversarial loss" in r]
    keys = sorted(set().union(*step_records))
    print(f"phase 9.3 proto_advent.yml (PROTO_ADVENT, b{batch} 1024x512, DOMAIN_ORDER [[25], "
          f"[50]], {steps} steps, {boot} bootstrap batches): {seconds:.3f} s; launches "
          f"{launches}; step keys {keys}")
    check(launches == want, f"proto_advent.yml launches {launches}, expected {want} (K1 2 and "
                            f"K2 159 per step, K2 53 per bootstrap batch)")
    check(len(step_records) == steps, f"{len(step_records)} PROTO_ADVENT step records")
    for r in step_records:
        for key, value in r.items():
            check("loss" not in key or math.isfinite(value), f"proto_advent.yml {key} = {value}")
    check(adapter.d_state["main_opt"]["count"] == steps, "the discriminator missed steps")
    check("adapt_state.pt" in os.listdir(snap), "proto_advent.yml wrote no adapt_state.pt")
    paths["proto_advent_cli"] = launches
    summary["proto_advent_cli_seconds"] = seconds
    del adapter

    # 9.4 one step of each, in memory at 1024x512 b4
    for config in ("advent", "proto_advent"):
        base = release(torch)
        torch.cuda.reset_peak_memory_stats()
        ad = make_adapter(torch, "cuda", MAIN_HW, batch, config=config)
        src = make_batches(torch, 1, batch, MAIN_HW, 30)[0]
        trg = make_batches(torch, 1, batch, MAIN_HW, 31)[0]
        s_img, s_lbl, t_img = src["image"].cuda(), src["label"].cuda(), trg["image"].cuda()
        lr_d = float(ad.cfg_spec.LEARNING_RATE_D)
        if config == "advent":
            step = ad.build_step()

            def one_step():
                ad.state, logs = step(ad.state, s_img, s_lbl, t_img, 1e-5, lr_d)
                return logs
            per_step, want_syncs = {"pseudo_labels_kernel": 0, "bn_stats_kernel": 106}, 0
        else:
            K.reset_launches()
            ad.calculate_prototypes([src])
            check(dict(K.launches) == {"pseudo_labels_kernel": 0, "bn_stats_kernel": 53},
                  f"PROTO_ADVENT bootstrap launches {dict(K.launches)}")
            step = ad.pa_step_fn()

            def one_step():
                ad.state, ad.d_state, logs = step(ad.state, ad.d_state, s_img, s_lbl, t_img,
                                                  1e-5, lr_d)
                return logs
            per_step, want_syncs = {"pseudo_labels_kernel": 2, "bn_stats_kernel": 159}, 1
        K.reset_launches()
        times = timed_ms(torch, lambda: one_step()["Adversarial loss"], warmup=1,
                         n=ADVERSARIAL_TIMED_STEPS)
        launches = dict(K.launches)
        peak = torch.cuda.max_memory_allocated()
        logs, syncs = count_syncs(torch, one_step)
        check(math.isfinite(logs["Adversarial loss"]), f"{config} in memory: non-finite loss")
        n_steps = 1 + ADVERSARIAL_TIMED_STEPS
        check(launches == {k: v * n_steps for k, v in per_step.items()},
              f"{config} steps in memory launched {launches}, expected {per_step} per step")
        check(len(syncs) == want_syncs, f"{config}: {len(syncs)} host syncs in a step, expected "
                                        f"{want_syncs}: {syncs}")
        ms = statistics.median(times)
        print(f"phase 9.4 {config}.yml step in memory (b{batch} {MAIN_HW[1]}x{MAIN_HW[0]}, "
              f"seeded weights): {', '.join(f'{t:.3f}' for t in times)} ms; median {ms:.3f} ms, "
              f"{batch / (ms / 1e3):.3f} frames/s; peak memory {peak / 2**30:.3f} GiB "
              f"(max_memory_allocated; {base / 2**30:.3f} GiB allocated before); host syncs "
              f"{len(syncs)} {syncs}; launches per step {per_step}")
        if profile:
            # the wrapper's count above is the check; the trace's own count is
            # printed beside it (one of an ADVENT step's 106 K2 launches was
            # missing from a trace once)
            k2 = profile_step(torch, lambda: one_step()["Adversarial loss"],
                              os.path.join(out_dir, f"profile_{config}_step.txt"),
                              f"phase 9.4 {config}.yml profiled step")
            print(f"phase 9.4 {config}.yml: the trace holds {k2} K2 launches of the step's "
                  f"{per_step['bn_stats_kernel']} calls")
        if config == "advent":
            summary["discriminator_ms"] = discriminator_cost(torch, ad, batch)
        paths[f"{config}_in_memory"] = launches
        summary.update({f"{config}_step_ms": ms, f"{config}_frames_per_s": batch / (ms / 1e3),
                        f"{config}_peak_gib": peak / 2**30})
        del ad, step, one_step, s_img, s_lbl, t_img
    release(torch)
    summary["phase_seconds"] = time.perf_counter() - t_phase
    print(f"phase 9: {summary['phase_seconds']:.3f} s")
    return paths, summary


# ---------------------------------------------------------------------------
# phase 10: every get_model option (bf16, REMAT, R101, ProDA-R101, GN-R50)
# ---------------------------------------------------------------------------

OPTION_TIMED_STEPS = 4  # phase 10, after 1 warm-up step


def block_bns(torch) -> int:
    """The BatchNorms inside R50's bottlenecks (all but the stem's): those a
    REMAT backward runs again when it recomputes the blocks."""
    from onda_torch.models import build_deeplab_v2
    from onda_torch.models.layers import TorchBatchNorm

    with torch.device("meta"):
        model = build_deeplab_v2(19, (3, 4, 6, 3), "ProDA")
    return sum(isinstance(m, TorchBatchNorm) for stage in (model.layer1, model.layer2,
                                                           model.layer3, model.layer4)
               for m in stage.modules())


def write_proda_checkpoint(torch, path):
    """A seeded Microsoft-ProDA R101 with its bn_clr `bn_pretrain`, saved in
    ProDA's training container `{"ResNet101": {"model_state": sd}}`."""
    from onda_torch.models import build_deeplab_v2

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        model = build_deeplab_v2(19, (3, 4, 23, 3), "ProDA", proda_layout=True, bn_clr=True)
        with torch.no_grad():  # running statistics that differ from the init's
            model.bn_pretrain.running_mean.uniform_(-0.1, 0.1)
            model.bn_pretrain.running_var.uniform_(0.5, 1.5)
    torch.save({"ResNet101": {"model_state": model.state_dict()}, "iteration": 0}, path)


def option_run(torch, K, card, tag, batch, per_step, steps=OPTION_TIMED_STEPS, profile=None,
               **adapter_kw):
    """The hybrid_switch.yml adapter of `adapter_kw` (a model name, OTHERS
    overrides, a MODEL.LOAD) at full width with seeded weights: a bootstrap
    on one source batch, then 1 + `steps` steps in memory at b`batch`
    1024x512 with the launch counters reset just before and read just after;
    one more step counts its host syncs (and, given a `profile` path, one
    more runs under torch.profiler). Checks `per_step` launches a step,
    finite losses and the logits' dtype at the main head. Returns (launches,
    numbers, the adapter, the first step's running statistics and loss, the
    logits' dtypes)."""
    base = release(torch)
    t0 = time.perf_counter()
    ad = make_adapter(torch, "cuda", MAIN_HW, batch, **adapter_kw)
    src = make_batches(torch, 1, batch, MAIN_HW, 40)[0]
    trg = make_batches(torch, 1, batch, MAIN_HW, 41)[0]
    ad.calculate_prototypes([src])
    s_img, s_lbl = src["image"][None].cuda(), src["label_res"][None].cuda()
    t_img = trg["image"].cuda()
    step = ad.step_fn(True, 1, False)
    head = ad.model.layer5 if ad.model.proda_layout else ad.model.layer6
    dtypes = set()
    hook = head.register_forward_hook(lambda m, a, o: dtypes.add(o["out"].dtype))
    first = {}

    def one_step():
        ad.state, logs = step(ad.state, t_img, s_img, s_lbl, 1e-5)
        if not first:
            first["stats"] = {k: v.clone() for k, v in ad.state.batch_stats.items()}
            first["loss"] = float(logs["Total target loss"])
        return logs

    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    times = timed_ms(torch, lambda: one_step()["Total target loss"], warmup=1, n=steps)
    launches = dict(K.launches)
    peak = torch.cuda.max_memory_allocated()
    logs, syncs = count_syncs(torch, one_step)
    if profile:
        k2 = profile_step(torch, lambda: one_step()["Total target loss"], profile,
                          f"phase {tag} profiled step [{card}]")
        print(f"phase {tag}: the trace holds {k2} K2 launches of the step's "
              f"{per_step['bn_stats_kernel']} calls")
    hook.remove()
    want = {k: v * (1 + steps) for k, v in per_step.items()}
    check(launches == want, f"{tag}: {1 + steps} steps launched {launches}, expected {per_step} "
                            f"per step")
    check(len(syncs) == 1, f"{tag}: {len(syncs)} host syncs in a step, expected 1 (the dynamic "
                           f"teacher's gate): {syncs}")
    for key, value in logs.items():
        check("loss" not in key or math.isfinite(value), f"{tag}: {key} = {value}")
    ms = statistics.median(times)
    numbers = {"step_ms": ms, "frames_per_s": batch / (ms / 1e3), "peak_gib": peak / 2**30,
               "launches_per_step": per_step, "logits_dtype": str(sorted(map(str, dtypes)))}
    print(f"phase 10 {tag}, b{batch} {MAIN_HW[1]}x{MAIN_HW[0]}, seeded weights [{card}]: "
          f"{', '.join(f'{t:.3f}' for t in times)} ms; median {ms:.3f} ms, "
          f"{numbers['frames_per_s']:.3f} frames/s; peak memory {peak / 2**30:.3f} GiB "
          f"(max_memory_allocated; {base / 2**30:.3f} GiB allocated before); launches per step "
          f"{per_step}; host syncs {len(syncs)}; logits {sorted(map(str, dtypes))}; set-up "
          f"{setup_s:.3f} s")
    return launches, numbers, ad, first, dtypes


def model_options_path(torch, K, card, work, out_dir, profile=False):
    """Phase 10: one step of hybrid_switch.yml in memory at b4 1024x512 for
    each option of get_model: OTHERS.PRECISION bf16; OTHERS.REMAT at b4 and
    b8, each beside the same batch without it; DeepLabv2-Resnet101;
    DeepLabv2-Resnet101-ProDA from a `.pth` in ProDA's container with
    `bn_pretrain`; DeepLabv2-Resnet50-GN. With `profile`, the bf16 step and
    the f32 step of the same batch are traced. Returns launch counts by path
    and the numbers."""
    t_phase = time.perf_counter()
    paths, summary = {}, {}
    hybrid = {"pseudo_labels_kernel": 2, "bn_stats_kernel": 159}

    # 10.1 OTHERS.PRECISION: bf16
    launches, summary["bf16"], ad, _, dtypes = option_run(
        torch, K, card, "10.1 bf16 (OTHERS.PRECISION bf16)", 4, hybrid,
        profile=profile and os.path.join(out_dir, "profile_bf16_step.txt"),
        others={"PRECISION": "bf16"})
    check(dtypes == {torch.bfloat16}, f"10.1: the bf16 config's logits are {dtypes}: it ran in f32")
    check(all(v.dtype == torch.float32 for v in ad.state.params.values()),
          "10.1: a parameter is not f32")
    paths["bf16_in_memory"] = launches
    del ad

    # 10.2 OTHERS.REMAT at b4 and b8, each beside the same batch without it;
    # the backward recomputes the student's bottlenecks in both grad forwards
    n_block = block_bns(torch)
    remat = dict(hybrid, bn_stats_kernel=159 + 2 * n_block)
    for batch in (4, 8):
        runs = {}
        for on in (False, True):
            tag = f"10.2 f32 REMAT {'on' if on else 'off'}"
            traced = profile and batch == 4 and not on
            launches, numbers, ad, first, _ = option_run(
                torch, K, card, tag, batch, remat if on else hybrid, others={"REMAT": on},
                profile=traced and os.path.join(out_dir, "profile_f32_b4_step.txt"))
            runs[on] = (numbers, first)
            paths[f"{'remat' if on else 'plain'}_b{batch}_in_memory"] = launches
            del ad
        (plain, f_plain), (rem, f_rem) = runs[False], runs[True]
        worst = max((f_rem["stats"][k] - v).abs().max().item() for k, v in f_plain["stats"].items())
        check(all(torch.allclose(f_rem["stats"][k], v, rtol=1e-6, atol=1e-6)
                  for k, v in f_plain["stats"].items()),
              f"10.2 b{batch}: the running statistics after a step differ with REMAT ({worst})")
        check(math.isclose(f_rem["loss"], f_plain["loss"], rel_tol=1e-5),
              f"10.2 b{batch}: the first step's loss {f_rem['loss']} vs {f_plain['loss']}")
        print(f"phase 10.2 b{batch} [{card}]: REMAT {rem['step_ms']:.3f} ms, peak "
              f"{rem['peak_gib']:.3f} GiB against {plain['step_ms']:.3f} ms, {plain['peak_gib']:.3f} "
              f"GiB without ({rem['step_ms'] / plain['step_ms'] - 1:+.1%} time, "
              f"{rem['peak_gib'] - plain['peak_gib']:+.3f} GiB); K2 {remat['bn_stats_kernel']} "
              f"launches a step under recompute (159 + 2 x {n_block}); running statistics "
              f"after the first step equal to {worst:.3e}")
        summary[f"remat_b{batch}"], summary[f"plain_b{batch}"] = rem, plain

    # 10.3 DeepLabv2-Resnet101: 104 BatchNorms a forward
    launches, summary["r101"], ad, _, _ = option_run(
        torch, K, card, "10.3 DeepLabv2-Resnet101", 4, dict(hybrid, bn_stats_kernel=312),
        model="DeepLabv2-Resnet101")
    paths["r101_in_memory"] = launches
    del ad

    # 10.4 DeepLabv2-Resnet101-ProDA from ProDA's container, bn_clr detected
    pth = os.path.join(work, "proda_r101_bn_clr.pth")
    write_proda_checkpoint(torch, pth)
    launches, summary["proda"], ad, _, _ = option_run(
        torch, K, card, "10.4 DeepLabv2-Resnet101-ProDA (bn_clr)", 4,
        dict(hybrid, bn_stats_kernel=315), model="DeepLabv2-Resnet101-ProDA", load=pth)
    os.remove(pth)
    check(ad.model.bn_pretrain is not None and not hasattr(ad.model, "layer6")
          and not ad.cfg.MODEL.MULTI_LEVEL, "10.4: bn_clr not detected or the layout is not ProDA's")
    start = {k: v.cuda() for k, v in ad.state.static_params.items()}
    moved = {k: (ad.state.params[k] - start[k]).abs().max().item()
             for k in ("layer5.head.1.weight", "layer5.bottleneck.1.weight", "bn_pretrain.weight",
                       "bn_pretrain.bias")}
    check(all(v > 0 for v in moved.values()), f"10.4: a head tensor did not train: {moved}")
    print(f"phase 10.4: bn_pretrain detected, MULTI_LEVEL forced off; largest change after "
          f"{1 + OPTION_TIMED_STEPS + 1} steps " + ", ".join(f"{k} {v:.3e}" for k, v in moved.items()))
    paths["proda_in_memory"] = launches
    del ad

    # 10.5 DeepLabv2-Resnet50-GN: no BatchNorm, so no K2
    launches, summary["gn"], ad, _, _ = option_run(
        torch, K, card, "10.5 DeepLabv2-Resnet50-GN", 4, dict(hybrid, bn_stats_kernel=0),
        model="DeepLabv2-Resnet50-GN")
    check(not ad.state.batch_stats, "10.5: the GN model has BatchNorm buffers")
    paths["gn_in_memory"] = launches
    del ad
    release(torch)
    summary["phase_seconds"] = time.perf_counter() - t_phase
    print(f"phase 10: {summary['phase_seconds']:.3f} s")
    return paths, summary

# ---------------------------------------------------------------------------
# phase 11: the six prototype configs no earlier phase runs, and ASYNC_SAVE
# ---------------------------------------------------------------------------

# config → its METHOD.ADAPTATION.NAME and the host syncs of one of its steps
# (the dynamic teacher's gate; base reads none: its decision is the config's)
SHIPPED_CONFIGS = {
    "static_model": ("PROTO_ONLINE", 0),
    "dynamic_model": ("PROTO_ONLINE", 0),
    "confidence_switch": ("PROTO_ONLINE_HSWITCH", 1),
    "confidence_der_switch": ("PROTO_ONLINE_VSWITCH", 1),
    "hybrid_switch_fog": ("PROTO_ONLINE_HYBRIDSWITCH", 1),
    "external_video": ("PROTO_ONLINE_HYBRIDSWITCH", 1),
}
POLICY_LOGS = ("prior static confidence ma", "percentage_static confidence ma",
               "dev avg prior static")


def write_bern_metadata(root, rows):
    """metadata_bern.json over phase 7's files: its clear train frames (with
    their labels) as the `clear` source and its 25 mm train frames, without
    labels, as the `video` target (external_video.yml's layout)."""
    from onda_torch.data.metadata import Table

    bern = [{"image_path": r["image_path"], "label_path": r["label_path"] if scene == "clear"
             else None, "set": "train", "scene": scene}
            for r in rows if r["set"] == "train"
            for scene in [{0: "clear", 25: "video"}.get(r["intensity"])] if scene]
    Table(bern, ["image_path", "label_path", "set", "scene"]).to_json(
        os.path.join(root, "metadata_bern.json"))
    return sum(b["scene"] == "video" for b in bern)


class KernelShapes:
    """Records the input shape of every K1 and K2 call while it is entered
    (the wrappers are wrapped, so the launch counts are theirs); with
    `moments`, K2's raw-moments calls too."""

    def __init__(self, K, moments=False):
        self.K, self.k1, self.k2, self.moments = K, set(), set(), moments

    def __enter__(self):
        pseudo_labels, bn_stats, bn_moments = (self.K.pseudo_labels, self.K.bn_stats,
                                               self.K.bn_moments)
        self.saved = pseudo_labels, bn_stats, bn_moments

        def k1(feat, protos, *args, **kwargs):
            self.k1.add((feat.shape[0], feat.shape[1], protos.shape[0]))
            return pseudo_labels(feat, protos, *args, **kwargs)

        def k2(x):
            self.k2.add((tuple(x.shape), str(x.dtype)))
            return bn_stats(x)

        def k2_moments(x):
            self.k2.add((tuple(x.shape), str(x.dtype)))
            return bn_moments(x)

        self.K.pseudo_labels, self.K.bn_stats = k1, k2
        if self.moments:  # K2's raw moments too (ranks that split the pixels)
            self.K.bn_moments = k2_moments
        return self

    def __exit__(self, *exc):
        self.K.pseudo_labels, self.K.bn_stats, self.K.bn_moments = self.saved


def one_step_syncs(torch, K, adapter, batch, seed):
    """One more step of an adapter the CLI returned, on device tensors: its
    launches and host syncs."""
    src = make_batches(torch, 1, batch, MAIN_HW, seed)[0]
    trg = make_batches(torch, 1, batch, MAIN_HW, seed + 1)[0]
    img, s_img, s_lbl = (trg["image"].cuda(), src["image"][None].cuda(),
                         src["label_res"][None].cuda())
    step = adapter.step_fn(True, 1, False)

    def one_step():
        adapter.state, logs = step(adapter.state, img, s_img, s_lbl, 1e-5)
        return logs

    K.reset_launches()
    logs, syncs = count_syncs(torch, one_step)
    check(math.isfinite(logs["Total target loss"]), "extra step: non-finite loss")
    return dict(K.launches), syncs


def state_tensors(torch, state):
    """Every tensor of an AdaptState by a flat name, as `save_model` writes it."""
    import dataclasses

    out = {}
    for f in dataclasses.fields(state):
        value = getattr(state, f.name)
        if f.name == "generator":
            out["generator"] = value.get_state()
        elif isinstance(value, dict):
            out.update({f"{f.name}/{k}": v for k, v in value.items()})
        elif hasattr(value, "__dict__"):  # the prototypes, the monitor, the switch
            out.update({f"{f.name}/{k}": v for k, v in vars(value).items()
                        if isinstance(v, torch.Tensor)})
    return out


def payload_tensors(torch, payload):
    """The tensors of a loaded `adapt_state.pt` under `state_tensors`' names."""
    out = {}
    for key, value in payload.items():
        if key == "generator":
            out["generator"] = value
        elif isinstance(value, dict):
            out.update({f"{key}/{k}": v for k, v in value.items() if isinstance(v, torch.Tensor)})
    return out


def same_bits(torch, a, b) -> bool:
    a, b = a.detach().cpu(), b.detach().cpu()
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def async_save_in_memory(torch, K, work, batch=4):
    """11.2: OTHERS.ASYNC_SAVE on the card: the hybrid adapter at b4 1024x512
    saves its state in the background while the next step changes every
    tensor in place; the file must hold the state as it was, bit for bit,
    and equal a synchronous save of that state."""
    from onda_torch.utils import checkpoint as ckpt

    release(torch)
    ad = make_adapter(torch, "cuda", MAIN_HW, batch)
    src = make_batches(torch, 1, batch, MAIN_HW, 50)[0]
    trg = make_batches(torch, 1, batch, MAIN_HW, 51)[0]
    ad.calculate_prototypes([src])
    s_img, s_lbl = src["image"][None].cuda(), src["label_res"][None].cuda()
    t_img = trg["image"].cuda()
    step = ad.step_fn(True, 1, False)

    def one_step():
        ad.state, logs = step(ad.state, t_img, s_img, s_lbl, 1e-5)
        return logs["Total target loss"]

    K.reset_launches()
    steady = statistics.median(timed_ms(torch, one_step, warmup=1, n=3))
    snap_async, snap_sync = (os.path.join(work, f"async_save_{k}") for k in ("async", "sync"))
    ad.cfg.OTHERS.SNAPSHOT_DIR = snap_async
    ad.cfg.OTHERS.ASYNC_SAVE = True
    # the path's first async save allocates its pinned buffers; later ones reuse them
    torch.cuda.synchronize()
    t = time.perf_counter()
    ad.save_model()
    cold_ms = 1e3 * (time.perf_counter() - t)
    one_step()
    path = os.path.join(snap_async, "adapt_state.pt")
    ckpt.wait_for(path)
    torch.cuda.synchronize()
    before = {k: v.clone() for k, v in state_tensors(torch, ad.state).items()}
    t = time.perf_counter()
    ad.save_model()
    async_ms = 1e3 * (time.perf_counter() - t)
    t = time.perf_counter()
    one_step()  # the step's SGD, model EMA and prototype EMA change the state in place
    torch.cuda.synchronize()
    after_ms = 1e3 * (time.perf_counter() - t)
    launches = dict(K.launches)
    want = {"pseudo_labels_kernel": 2 * 6, "bn_stats_kernel": 159 * 6}
    check(launches == want, f"11.2: six steps launched {launches}, expected {want}")
    t = time.perf_counter()
    ckpt.wait_for(path)
    drain_ms = 1e3 * (time.perf_counter() - t)
    ckpt.wait_for_saves()
    saved = payload_tensors(torch, torch.load(path, map_location="cpu", weights_only=False))
    check(set(saved) == set(before), f"11.2: the file's tensors {sorted(set(saved) ^ set(before))[:6]}")
    now = state_tensors(torch, ad.state)
    changed = [k for k, v in before.items() if not same_bits(torch, v, now[k])]
    must = ["params/layer6.head.1.weight", "opt_momentum/layer6.head.1.weight",
            "ema_params/layer6.head.1.weight", "params/conv1.weight", "proto/mean",
            "batch_stats/bn1.running_mean"]
    check(all(k in changed for k in must),
          f"11.2: the step left {[k for k in must if k not in changed]} as they were")
    wrong = [k for k, v in before.items() if not same_bits(torch, saved[k], v)]
    check(not wrong, f"11.2: the async file differs from the state at the save in {wrong[:6]}")

    ad.load_model(path)  # the saved state back, then saved synchronously
    ad.cfg.OTHERS.SNAPSHOT_DIR, ad.cfg.OTHERS.ASYNC_SAVE = snap_sync, False
    torch.cuda.synchronize()
    t = time.perf_counter()
    ad.save_model()
    sync_ms = 1e3 * (time.perf_counter() - t)
    synced = payload_tensors(torch, torch.load(os.path.join(snap_sync, "adapt_state.pt"),
                                               map_location="cpu", weights_only=False))
    wrong = [k for k, v in saved.items() if not same_bits(torch, synced[k], v)]
    check(set(synced) == set(saved) and not wrong, f"11.2: sync and async files differ: {wrong[:6]}")
    nbytes = sum(v.numel() * v.element_size() for v in saved.values())
    size = os.path.getsize(path)
    print(f"phase 11.2 ASYNC_SAVE in memory (hybrid_switch.yml, b{batch} 1024x512): payload "
          f"{nbytes / 1e9:.3f} GB in {len(saved)} tensors ({size / 1e9:.3f} GB file); save_model() "
          f"returned after {async_ms:.3f} ms async (the path's first async save, which "
          f"allocates the pinned buffers: {cold_ms:.3f} ms) against {sync_ms:.3f} ms sync; drain "
          f"{drain_ms:.3f} ms; the step right after the async save {after_ms:.3f} ms against a "
          f"steady {steady:.3f} ms; {len(changed)} of {len(before)} tensors changed in place "
          f"during the write, the file holds every one as saved (bit for bit) and equals the "
          f"synchronous save")
    shutil.rmtree(snap_async, ignore_errors=True)
    shutil.rmtree(snap_sync, ignore_errors=True)
    del ad, step, one_step, before, now, saved, synced
    release(torch)
    return launches, {"payload_gb": nbytes / 1e9, "file_gb": size / 1e9,
                      "save_return_ms_async": async_ms, "save_return_ms_async_first": cold_ms,
                      "save_return_ms_sync": sync_ms,
                      "drain_ms": drain_ms, "step_after_async_save_ms": after_ms,
                      "steady_step_ms": steady}


def shipped_configs_path(torch, K, out_dir, work, root, rows, checked):
    """Phase 11: 11.1 the six shipped prototype configs no earlier phase runs,
    each through `onda_torch.train_ouda.main` from phase 7's PNG files at its
    own width (R50 ProDA head, b4 1024x512), cut only in its data path,
    domain order (its first domain), epochs, absent files and snapshot
    directory; 11.2 OTHERS.ASYNC_SAVE in memory and through the CLI. Every K1
    and K2 shape the runs feed must be among those phases 3-4 checked
    (`checked`). Returns launch counts by path and the numbers."""
    import yaml
    from onda_torch.utils.checkpoint import checkpoints_by_mtime

    t_phase = time.perf_counter()
    write_fog_metadata(root, rows)
    n_video = write_bern_metadata(root, rows)
    n_train = CLI_FRAMES["train"]
    paths, summary = {}, {}
    shapes = KernelShapes(K)
    with shapes:
        for name, (method, want_syncs) in SHIPPED_CONFIGS.items():
            snap = os.path.join(work, f"shipped_{name}")
            with open(os.path.join(HERE, "configs", f"{name}.yml")) as f:
                order = yaml.safe_load(f)["SCHEME"]["DOMAIN_ORDER"][:1]
            spec_key = f"METHOD.ADAPTATION.{method}"
            cfg = workflow_config(name, os.path.join(work, f"{name}.yml"), **{
                "SCHEME.PATH": root, "SCHEME.DOMAIN_ORDER": order, "MODEL.LOAD": None,
                f"{spec_key}.LOAD_PROTO": None, f"{spec_key}.EPOCHS": 1,
                "OTHERS.SNAPSHOT_DIR": snap, "OTHERS.SCHEDULE": True})
            batch = int(cfg["TRAINING"]["BATCH_SIZE"])
            check(batch == 4 and cfg["SCHEME"]["RESOLUTION"] == [1024, 512]
                  and cfg["MODEL"]["NAME"] == "DeepLabv2-Resnet50"
                  and cfg["MODEL"]["CLASSIFIER"] == "ProDA", f"{name}.yml is no longer b4 "
                                                             f"1024x512 R50 ProDA")
            launches, batches, seconds, text, adapter = run_cli(
                torch, K, os.path.join(work, f"{name}.yml"),
                os.path.join(out_dir, f"shipped_{name}.log"))
            per_domain = (n_video if name == "external_video" else n_train) // batch
            steps = len(order) * per_domain
            boot = min(int(cfg["TRAINING"]["REPLAY_BUFFER"]), n_train) // batch
            want = {"pseudo_labels_kernel": 2 * steps, "bn_stats_kernel": 159 * steps + 53 * boot}
            check(launches == want, f"{name}.yml launches {launches}, expected {want} (K1 2 and K2 "
                                    f"159 per step, K2 53 per bootstrap batch)")
            check(batches.get("collate", 0) == 0 and batches.get("executor", 0) > 0,
                  f"{name}.yml: every batch must come from the C++ executor, got {batches}")
            records = read_records(snap)
            step_records = [r for r in records if "Total target loss" in r]
            check(len(step_records) == steps, f"{name}.yml: {len(step_records)} step records, "
                                              f"expected {steps}")
            finite = all(math.isfinite(v) for r in step_records for k, v in r.items() if "loss" in k)
            check(finite, f"{name}.yml: a non-finite loss")
            fired = [int(r["dynamic forward fired"]) for r in step_records]
            if name == "static_model":
                check(not any(fired), "static_model.yml ran the dynamic teacher")
            if name == "dynamic_model":
                check(all(fired), "dynamic_model.yml skipped the dynamic teacher")
            keys = set().union(*records)
            has_val = cfg["OTHERS"]["VALIDATION"] != "none"
            check(any(k.startswith("Val mIoU model of ") for k in keys) == has_val,
                  f"{name}.yml: validation keys {'missing' if has_val else 'present'}")
            files = os.listdir(snap)
            check("adapt_state.pt" in files and any(f.startswith("proto_") for f in files)
                  and not [f for f in files if f.startswith(".")], f"{name}.yml wrote {files}")
            one, syncs = one_step_syncs(torch, K, adapter, batch, 60)
            check(one == {"pseudo_labels_kernel": 2, "bn_stats_kernel": 159},
                  f"{name}.yml: one step launched {one}")
            check(len(syncs) == want_syncs, f"{name}.yml: {len(syncs)} host syncs in a step, "
                                            f"expected {want_syncs}: {syncs}")
            stages = {}
            for d in range(len(order)):
                per = step_stage_ms(step_records[d * per_domain:(d + 1) * per_domain])
                for key, ms in per.items():  # steps 1..n-2 of each domain
                    stages.setdefault(key[5:], []).extend(ms[1:-1])
            median = {k: statistics.median(v) for k, v in stages.items()}
            fps = [r["Adaptation frames per second"] for r in step_records
                   if "Adaptation frames per second" in r]
            policy_logs = {k: (min(r[k] for r in step_records), max(r[k] for r in step_records))
                           for k in POLICY_LOGS}
            numbers = {"seconds": seconds, "steps": steps, "stage_ms_median": median,
                       "step_ms": sum(median.values()), "frames_per_s": fps,
                       "k1_per_step": one["pseudo_labels_kernel"],
                       "k2_per_step": one["bn_stats_kernel"], "host_syncs_per_step": len(syncs),
                       "dynamic_steps": sum(fired), "fired": fired, "finite": finite,
                       "policy_logs": policy_logs}
            summary[name] = numbers
            paths[f"{name}_cli"] = launches
            print(f"phase 11.1 {name}.yml ({method}, policy {adapter.policy}, b{batch} 1024x512, "
                  f"DOMAIN_ORDER {order}, {steps} steps, {boot} bootstrap batches): "
                  f"{seconds:.3f} s; launches {launches}; steady stage ms "
                  + ", ".join(f"{k} {v:.3f}" for k, v in median.items())
                  + f" (sum {numbers['step_ms']:.3f}); Adaptation frames per second "
                  + ", ".join(f"{v:.3f}" for v in fps)
                  + f"; per step K1 {one['pseudo_labels_kernel']}, K2 {one['bn_stats_kernel']}, "
                  f"host syncs {len(syncs)}; dynamic teacher on {sum(fired)} of {steps} steps "
                  f"{fired}; every loss finite {finite}; "
                  + ", ".join(f"{k} {lo:.6g}..{hi:.6g}" for k, (lo, hi) in policy_logs.items()))
            del adapter
            for f in files:  # the checkpoints: over 1 GB each
                if f.endswith((".pt", ".pth")):
                    os.remove(os.path.join(snap, f))

        # 11.2 ASYNC_SAVE: in memory, then through the CLI
        paths["async_save_in_memory"], summary["async_save"] = async_save_in_memory(torch, K, work)
        snap = os.path.join(work, "async_save_cli")
        method = SHIPPED_CONFIGS["confidence_switch"][0]
        cfg = workflow_config("confidence_switch", os.path.join(work, "async_cli.yml"), **{
            "SCHEME.PATH": root, "SCHEME.DOMAIN_ORDER": [[25]], "MODEL.LOAD": None,
            f"METHOD.ADAPTATION.{method}.LOAD_PROTO": None,
            f"METHOD.ADAPTATION.{method}.EPOCHS": 1, "OTHERS.SNAPSHOT_DIR": snap,
            "OTHERS.ASYNC_SAVE": True, "OTHERS.SAVE_EVERY": 2})
        launches, _, seconds, text, adapter = run_cli(torch, K, os.path.join(work, "async_cli.yml"),
                                                      os.path.join(out_dir, "async_save_cli.log"))
        steps = n_train // 4
        check(launches["pseudo_labels_kernel"] == 2 * steps, f"11.2 CLI launches {launches}")
        files = os.listdir(snap)
        check(not [f for f in files if f.startswith(".")], f"11.2 CLI left a temporary: {files}")
        state = torch.load(os.path.join(snap, "adapt_state.pt"), map_location="cpu",
                           weights_only=False)
        check(state["step"] == steps, f"11.2 CLI: adapt_state.pt holds step {state['step']}")
        listed = [p.name for p in checkpoints_by_mtime(snap)]
        print(f"phase 11.2 confidence_switch.yml with OTHERS.ASYNC_SAVE true, SAVE_EVERY 2, "
              f"DOMAIN_ORDER [[25]] ({steps} steps): {seconds:.3f} s; launches {launches}; "
              f"adapt_state.pt loads (step {state['step']}); listed {listed}; no temporary left")
        paths["async_save_cli"] = launches
        summary["async_save"]["cli_seconds"] = seconds
        del adapter, state
        shutil.rmtree(snap, ignore_errors=True)
    k1_checked = {tuple(c) for c in checked["k1"]}
    k2_checked = {tuple(c) for c in checked["k2"]}
    check(shapes.k1 <= k1_checked, f"phase 11 fed K1 unchecked shapes {shapes.k1 - k1_checked}")
    check({s for s, _ in shapes.k2} <= k2_checked and {d for _, d in shapes.k2} <= {
        "torch.float32", "torch.bfloat16"}, f"phase 11 fed K2 unchecked shapes "
                                            f"{sorted(s for s, _ in shapes.k2 if s not in k2_checked)}")
    print(f"phase 11: K1 shapes fed {sorted(shapes.k1)}, K2 {len(shapes.k2)} shape/type pairs; "
          f"all among those phases 3-4 checked against the plain versions")
    release(torch)
    summary["phase_seconds"] = time.perf_counter() - t_phase
    print(f"phase 11: {summary['phase_seconds']:.3f} s")
    return paths, summary

# ---------------------------------------------------------------------------
# phase 12: OTHERS.DATA_PARALLEL across two ranks (the PROTO_ONLINE family)
# ---------------------------------------------------------------------------

DP_RANKS = 2
DP_TIMED_STEPS = 6
JOBS_DEADLINE = 900  # seconds for a phase's torchrun (`run_rank_jobs`); past it its ranks are killed
# one process at b4 against two ranks at b2 each, after a bootstrap and one
# step with TF32 off: losses relative, prototypes absolute, and the largest
# difference of the updated parameters in the head and in the backbone
# against the largest entry of that group's update. "exact": each sample's
# arithmetic made independent of its batch (`batch_invariant`), so only the
# order of the sums over the batch differs; "kernels": the step as it runs,
# cuDNN and K2 at b2 against b4, whose last-bit differences in the forward
# move the backbone's update by ≈2% (its BatchNorms of near-constant channels
# scale the backward by up to 1/sqrt(eps)). Each bound is ≈3-10x PR 9's
# reading on an H100.
DP_BOUNDS = {"exact": {"loss": 1e-6, "proto": 1e-5, "head": 4e-4, "backbone": 1e-4},
             "kernels": {"loss": 1e-6, "proto": 1e-4, "head": 2e-3, "backbone": 5e-2}}
DP_LOSS_KEYS = ("Total target loss", "ce_loss", "rce_loss", "regularization_loss", "buff_ce_loss")


def dp_layout(torch):
    """The backend the ranks will pick here, and the layout in words."""
    from onda_torch.parallel import distributed as D

    cards = torch.cuda.device_count()
    backend = D.choose_backend("cuda", DP_RANKS, cards)
    where = (f"one card each (cards 0-{DP_RANKS - 1}), nccl" if backend == "nccl"
             else f"both on card 0 ({cards} card(s) here), gloo, card tensors through the card's "
                  f"memory (CUDA IPC)")
    return backend, f"{DP_RANKS} ranks, {where}"


def run_ranks(args, log_path, nproc=DP_RANKS, deadline=JOBS_DEADLINE):
    """`python -m torch.distributed.run --standalone --nproc-per-node nproc
    args`, its output into log_path; every process it started is killed at
    the deadline. Returns (exit code, output, seconds)."""
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(nproc), *args]
    t = time.perf_counter()
    with open(log_path, "w+") as log:
        # unbuffered: a rank killed at the deadline leaves all it printed
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, cwd=HERE,
                                start_new_session=True, env={**os.environ, "PYTHONUNBUFFERED": "1"})
        try:
            proc.wait(timeout=deadline)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            raise SmokeFailure(f"the ranks of {args[:2]} ran past {deadline} s (a collective "
                               f"that never completed?); see {log_path}")
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        log.seek(0)
        text = log.read()
    return proc.returncode, text, time.perf_counter() - t


def digests(torch, state):
    """sha256 of the bytes of every tensor of an AdaptState."""
    return digests_of(torch, state_tensors(torch, state))


def digests_of(torch, tensors):
    """sha256 of the bytes of every tensor of a flat dict."""
    import hashlib

    return {k: hashlib.sha256(v.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
                              .numpy().tobytes()).hexdigest() for k, v in tensors.items()}


@contextlib.contextmanager
def batch_invariant(torch):
    """cuDNN off and every BatchNorm's statistics from exact f64 sums (the
    plain K2): each sample's arithmetic then does not depend on the batch."""
    from onda_torch.ops import kernels as K

    saved = K.bn_stats, K.bn_moments, torch.backends.cudnn.enabled

    def exact_stats(x):
        mean, mean_sq = K.bn_moments_plain(x)
        return mean.float(), torch.clamp(mean_sq - mean * mean, min=0.0).float()

    K.bn_stats, K.bn_moments, torch.backends.cudnn.enabled = exact_stats, K.bn_moments_plain, False
    try:
        yield
    finally:
        K.bn_stats, K.bn_moments, torch.backends.cudnn.enabled = saved


def dp_compare_step(torch, device, batch, exact, others=None, split=False, split_rows=False):
    """The adapter of hybrid_switch.yml at b`batch` 1024x512 (seeded
    weights, OTHERS overrides `others`) on `device`, bootstrapped on this
    rank's rows of two seeded source batches (those of its data index), after
    one step on its rows of a seeded target batch, with TF32 off and
    deterministic cuDNN (`exact`: `batch_invariant`; `split`: the layers a
    grid shards compute in its blocks, `split_sharded_layers`; `split_rows`:
    every convolution computes in a spatial axis's row blocks,
    `split_spatial_rows`); returns
    (adapter, step, logs, local batch fn, the parameters before the step on
    the host)."""
    from onda_torch.parallel import distributed as D
    from onda_torch.parallel import spatial as S

    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = False, True
    with batch_invariant(torch) if exact else contextlib.nullcontext():
        ad = make_adapter(torch, device, MAIN_HW, batch, others=others)
        if split:
            n = split_sharded_layers(torch, ad)
            check(n == TP_SHARDED_LAYERS, f"the witness split {n} layers, expected "
                                          f"{TP_SHARDED_LAYERS}")
        if split_rows:
            n = split_spatial_rows(torch, ad)
            check(n == SP_CONVS, f"the spatial witness split {n} convolutions, expected {SP_CONVS}")
        d, b = D.data_rank(), batch // D.data_world()

        def local(bt):  # on a spatial grid (phase 14) also this rank's block of rows
            out = {k: v[d * b:(d + 1) * b] for k, v in bt.items()}
            if S.active():
                out = {k: S.shard_rows(v, 2 if k == "image" else 1) for k, v in out.items()}
            return out

        ad.cfg_spec.PSEUDO_THRESH = 0.06  # random weights: keep pseudo-labels, so CE and RCE count
        start = {k: v.detach().to("cpu", copy=True) for k, v in ad.state.params.items()}
        ad.calculate_prototypes([local(x) for x in make_batches(torch, 2, batch, MAIN_HW, 10)])
        step = ad.step_fn(True, 1, False)
        src = local(make_batches(torch, 1, batch, MAIN_HW, 12)[0])
        trg = local(make_batches(torch, 1, batch, MAIN_HW, 13)[0])
        dev = ad.device
        ad.state, logs = step(ad.state, trg["image"].to(dev), src["image"][None].to(dev),
                              src["label_res"][None].to(dev), 1e-5)
        logs = dict(logs.items())
        torch.cuda.synchronize()
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = True, False
    return ad, step, logs, local, start


def compared_state(torch, ad):
    """The parameters and prototypes of an adapter, on the host."""
    return {"params": {k: v.detach().to("cpu", copy=True) for k, v in ad.state.params.items()},
            "proto": {k: v.detach().to("cpu", copy=True) for k, v in vars(ad.state.proto).items()}}


def dp_rank(work):
    """One rank of phase 12.1 (run under torch.distributed.run): the compared
    step, the digests of its whole state, then DP_TIMED_STEPS timed steps
    with TF32 on; writes rank<r>.json (and rank 0 its state after the
    compared step) into `work`."""
    import torch

    sys.path.insert(0, HERE)
    from onda_torch.ops import kernels as K
    from onda_torch.parallel import distributed as D

    from onda_torch.models.layers import TorchBatchNorm

    device = D.initialize("cuda")
    rank, world = D.rank(), D.world()
    batch = 4
    out = {"rank": rank, "world": world, "backend": D.backend(), "device": str(device)}
    for mode in DP_BOUNDS:  # "exact", then "kernels", whose adapter goes on to the timed steps
        ad, step, logs, local, _ = dp_compare_step(torch, device, batch, mode == "exact")
        out[mode] = {"logs": logs, "digests": digests(torch, ad.state)}
        if rank == 0:
            torch.save(compared_state(torch, ad), os.path.join(work, f"rank0_{mode}.pt"))
    out["n_bn"] = sum(isinstance(m, TorchBatchNorm) for m in ad.model.modules())
    batches = [(local(s), local(t)) for s, t in zip(
        make_batches(torch, DP_TIMED_STEPS, batch, MAIN_HW, 20),
        make_batches(torch, DP_TIMED_STEPS, batch, MAIN_HW, 21))]
    feed = [(t["image"].to(device), s["image"][None].to(device), s["label_res"][None].to(device))
            for s, t in batches]
    torch.cuda.synchronize()
    K.reset_launches()
    D.reset_counts()
    torch.cuda.reset_peak_memory_stats(device)
    times, finite = [], True
    for img, s_img, s_lbl in feed:
        t = time.perf_counter()
        ad.state, step_logs = step(ad.state, img, s_img, s_lbl, 1e-5)
        finite &= math.isfinite(step_logs["Total target loss"])  # the step ends at its log read
        times.append(1e3 * (time.perf_counter() - t))
    out.update(step_ms=times, finite=finite, launches=dict(K.launches), collectives=D.counts(),
               peak_gib=torch.cuda.max_memory_allocated(device) / 2**30)
    img, s_img, s_lbl = feed[0]
    D.reset_counts()
    (ad.state, step_logs), syncs = count_syncs(
        torch, lambda: step(ad.state, img, s_img, s_lbl, 1e-5))
    out.update(debug_syncs=len(syncs), sync_collectives=D.counts()["collectives"])
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    D.destroy()


def cli_rank(work, argv):
    """The CLI runs of a rank of phases 12-13 (a `rank_jobs` job): the runs
    of argv, separated by `--then`, each `onda_torch.train_ouda.main(run)`
    in turn in the job's process group (`one_process_group`); each run's
    launches, the K1/K2 shapes it fed, its seconds, the records its snapshot
    directory's metrics.jsonl then holds and (on a grid) its state's digests
    go into work/cli_rank<r>_<i>.json."""
    import torch

    sys.path.insert(0, HERE)
    from onda_torch import train_ouda
    from onda_torch.ops import kernels as K
    from onda_torch.parallel import distributed as D

    rank = int(os.environ.get("RANK", "0"))
    runs = [[]]
    for arg in argv:
        if arg == "--then":
            runs.append([])
        else:
            runs[-1].append(arg)
    for i, run in enumerate(runs):
        K.reset_launches()
        shapes = KernelShapes(K)
        t = time.perf_counter()
        with shapes:
            ad = train_ouda.main(run)
        torch.cuda.synchronize()
        metrics = os.path.join(str(ad.cfg.OTHERS.SNAPSHOT_DIR), "metrics.jsonl")
        out = {"rank": rank, "launches": dict(K.launches), "collectives": D.counts(),
               "k1_shapes": sorted(shapes.k1), "k2_shapes": sorted(shapes.k2),
               "seconds": time.perf_counter() - t,
               "records_end": len(read_records(os.path.dirname(metrics)))
               if os.path.exists(metrics) else 0}
        if getattr(ad, "plan", None):  # a grid (13.3, 13.5): this rank's tensors, its shards
            tensors = (family_tensors(torch, ad) if hasattr(ad.state, "d_main") else
                       {f"{t}/{k}": v for t in TP_TREES for k, v in getattr(ad.state, t).items()})
            out["digests"] = digests_of(torch, tensors)
        with open(os.path.join(work, f"cli_rank{rank}_{i}.json"), "w") as f:
            json.dump(out, f)
        del ad
        release(torch)


@contextlib.contextmanager
def one_process_group(D):
    """Work that calls `D.destroy` more than once, in one process group: the
    calls inside do nothing, and the group is left once, after the work
    ends without an error."""
    destroy, D.destroy = D.destroy, (lambda: None)
    try:
        yield
    finally:
        D.destroy = destroy
    destroy()


def rank_jobs(argv):
    """One rank of a phase's torchrun (`run_rank_jobs`): the jobs of argv,
    separated by `--job`, in turn in one process group, which the first
    joins and which is left after the last (`one_process_group`); each
    job's seconds printed when it ends."""
    from onda_torch.parallel import distributed as D

    jobs = [[]]
    for arg in argv:
        if arg == "--job":
            jobs.append([])
        else:
            jobs[-1].append(arg)
    run = {"--dp-rank": lambda d: dp_rank(d), "--adv-rank": lambda d: adv_rank(d),
           "--tp-rank": lambda d, n, x: tp_rank(d, int(n), x == "1"),
           "--tp-adv-rank": lambda d, n: tp_adv_rank(d, int(n)),
           "--sp-rank": lambda d, shape, n, modes: sp_rank(
               d, tuple(int(v) for v in shape.split("x")), int(n), modes.split(",")),
           "--cli-rank": lambda d, _, *a: cli_rank(d, list(a))}
    with one_process_group(D):
        for i, (kind, *args) in enumerate(jobs):
            t = time.perf_counter()
            run[kind](*args)
            print(f"chip_smoke rank {os.environ.get('RANK', '0')} job {i} {kind}: "
                  f"{time.perf_counter() - t:.3f} s", flush=True)


def run_rank_jobs(jobs, log_path, nproc=DP_RANKS):
    """One torchrun of `nproc` ranks that runs `jobs` (lists of a rank mode's
    arguments: `--dp-rank DIR`, `--adv-rank DIR`, `--tp-rank DIR STEPS
    TRANSPORT`, `--tp-adv-rank DIR STEPS`, `--sp-rank DIR DxS STEPS MODES`,
    `--cli-rank DIR -- <CLI args>
    [--then <CLI args>]...`) in turn in one process group: one start-up for
    all of them. Returns (exit code, output, seconds, rank 0's seconds of
    each job)."""
    argv = [os.path.join(HERE, "chip_smoke.py"), "--rank-jobs"]
    for i, job in enumerate(jobs):
        argv += (["--job"] if i else []) + list(job)
    rc, text, seconds = run_ranks(argv, log_path, nproc=nproc)
    job_seconds = [float(v) for v in re.findall(r"chip_smoke rank 0 job \d+ \S+: (\S+) s", text)]
    return rc, text, seconds, job_seconds


def cli_chain(run_dir, runs):
    """The `--cli-rank` job of the CLI runs `runs` ({name: config path}, in
    order) chained in one torchrun."""
    argv = []
    for cfg_path in runs.values():
        argv += (["--then"] if argv else []) + ["--cfg", cfg_path]
    return ["--cli-rank", run_dir, "--", *argv]


def chain_results(run_dir, runs, nproc=DP_RANKS):
    """Each chained run's per-rank outputs (`cli_rank`), by name."""
    out = {name: [] for name in runs}
    for r in range(nproc):
        for i, name in enumerate(runs):
            with open(os.path.join(run_dir, f"cli_rank{r}_{i}.json")) as f:
                out[name].append(json.load(f))
    return out


def chain_records(runs, results, snaps):
    """Each chained run's records: its snapshot directory's metrics.jsonl
    from where the run before it in that directory left it to where it left
    it (rank 0's counts; `snaps`: {name: directory})."""
    out, seen = {}, {}
    for name in runs:
        snap, end = snaps[name], results[name][0]["records_end"]
        out[name] = read_records(snap)[seen.get(snap, 0):end] if end else []
        seen[snap] = end
    return out


def update_gap(got, want, start, keys):
    """The largest |got − want| over the tensors `keys`, against the largest
    entry of want's update from start among them."""
    diff = max((got[k].double() - want[k].double()).abs().max().item() for k in keys)
    update = max((want[k].double() - start[k].double()).abs().max().item() for k in keys)
    return diff / max(update, 1e-30)


def data_parallel_ranks(torch, out_dir, work, root, rows):
    """Phase 12's one torchrun of two ranks: 12.1's ranks (`dp_rank`), 12.3's
    (`adv_rank`), then the CLI runs of 12.2, 12.4 and 12.5 chained (one
    domain each: hybrid_switch.yml, advent.yml and its AUTO_RESUME,
    proto_advent.yml, training_fog.yml, then validation_offline_fog.yml, its
    EVAL_SWEEP and validation.yml's PREDICTION_SAVE on the SEGMENT run's
    snapshots). Returns what the phase's checks read."""
    write_fog_metadata(root, rows)
    dirs = {k: os.path.join(work, k) for k in ("dp", "adv", "dp_chain")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    snaps = {"hybrid": os.path.join(work, "dp_cli"), "advent": os.path.join(work, "dp_advent"),
             "proto_advent": os.path.join(work, "dp_proto_advent"),
             "segment": os.path.join(work, "dp_segment")}
    snaps.update(advent_resume=snaps["advent"], eval_evaluation=snaps["segment"],
                 eval_sweep=snaps["segment"], eval_predictions=snaps["segment"])
    preds = os.path.join(work, "dp_predictions_ranks")
    base = {"SCHEME.PATH": root, "MODEL.LOAD": None}
    advent = {**base, "SCHEME.DOMAIN_ORDER": [[25]], "METHOD.ADAPTATION.ADVENT.EPOCHS": 1,
              "OTHERS.SNAPSHOT_DIR": snaps["advent"]}
    plan = {
        "advent": ("advent", advent),
        "advent_resume": ("advent", {**advent, "OTHERS.AUTO_RESUME": True}),
        "proto_advent": ("proto_advent", {
            **base, "SCHEME.DOMAIN_ORDER": [[25]], "OTHERS.SNAPSHOT_DIR": snaps["proto_advent"],
            "METHOD.ADAPTATION.PROTO_ADVENT.LOAD_PROTO": None,
            "METHOD.ADAPTATION.PROTO_ADVENT.EPOCHS": 1}),
        "segment": ("training_fog", {
            **base, "SCHEME.DOMAIN_ORDER": [[750]], "METHOD.PRETRAIN.SEGMENT.EPOCHS": 1,
            "METHOD.ADAPTATION.PROTO_ONLINE_HYBRIDSWITCH.LOAD_PROTO": None,
            "OTHERS.SNAPSHOT_DIR": snaps["segment"]}),
        **{f"eval_{name}": (config, {**base, "OTHERS.SNAPSHOT_DIR": snaps["segment"], **cuts})
           for name, (config, cuts) in dp_eval_runs(preds).items()},
    }
    runs = {"hybrid": os.path.join(work, "dp_cli.yml")}
    cfgs = {"hybrid": cli_config(root, snaps["hybrid"], runs["hybrid"], [[25]])}
    for name, (config, cuts) in plan.items():
        runs[name] = os.path.join(work, f"dp_{name}.yml")
        cfgs[name] = workflow_config(config, runs[name], **cuts)
    rc, text, seconds, job_seconds = run_rank_jobs(
        [["--dp-rank", dirs["dp"]], ["--adv-rank", dirs["adv"]],
         cli_chain(dirs["dp_chain"], runs)], os.path.join(out_dir, "dp_ranks.log"))
    check(rc == 0, f"phase 12: a rank failed (exit {rc}):\n{text[-3000:]}")
    check(len(job_seconds) == 3, f"phase 12: rank 0 reports {job_seconds} job seconds")
    results = chain_results(dirs["dp_chain"], runs)
    print(f"phase 12 ranks: one torchrun of {DP_RANKS} ranks, {seconds:.3f} s with start-up: "
          f"12.1's ranks {job_seconds[0]:.3f} s, 12.3's {job_seconds[1]:.3f} s, the {len(runs)} "
          f"CLI runs of 12.2, 12.4 and 12.5 {job_seconds[2]:.3f} s (" + ", ".join(
              f"{k} {v[0]['seconds']:.3f}" for k, v in results.items()) + ")")
    return {"text": text, "seconds": seconds, "job_seconds": job_seconds, "dirs": dirs,
            "runs": runs, "cfgs": cfgs, "snaps": snaps, "preds": preds, "results": results,
            "records": chain_records(runs, results, snaps)}


def dp_eval_runs(preds):
    """12.5's EVALUATION runs: name → (config, cuts), PREDICTION_SAVE into `preds`."""
    return {"evaluation": ("validation_offline_fog", {}),
            "sweep": ("validation_offline_fog", {"OTHERS.EVAL_SWEEP": True}),
            "predictions": ("validation", {"SCHEME.DOMAIN_ORDER": [[750]],
                                           "METHOD.PRETRAIN.EVALUATION.PREDICTION_SAVE": preds})}


def data_parallel_path(torch, K, out_dir, work, root, rows, one, launched):
    """Phase 12.1-12.2 (`launched`: `data_parallel_ranks`): 12.1
    hybrid_switch.yml in memory at full width, one process at b4 (`one`,
    `one_process_references`) against two ranks at b2 each (bootstrap and
    one step compared, the ranks bit for bit), then timed; 12.2 the CLI
    under torch.distributed.run on phase 7's files. Returns launch counts by
    path and the numbers."""
    t_phase = time.perf_counter()
    backend, layout = dp_layout(torch)
    summary = {"backend": backend, "layout": layout}
    dp_dir = launched["dirs"]["dp"]
    seconds = launched["job_seconds"][0]
    ranks = []
    for r in range(DP_RANKS):
        with open(os.path.join(dp_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    check(all(r["world"] == DP_RANKS and r["backend"] == backend for r in ranks),
          f"phase 12.1: ranks report {[(r['world'], r['backend']) for r in ranks]}, expected "
          f"{DP_RANKS} on {backend}")
    gaps = {}
    for mode, bounds in DP_BOUNDS.items():
        differ = sorted(k for k in r0[mode]["digests"] if any(
            r[mode]["digests"][k] != r0[mode]["digests"][k] for r in ranks[1:]))
        check(not differ, f"phase 12.1 {mode}: the ranks' states differ after the step in "
                          f"{differ[:6]}")
        check(all(r[mode]["logs"] == r0[mode]["logs"] for r in ranks),
              f"phase 12.1 {mode}: the ranks' logs differ")
        got = torch.load(os.path.join(dp_dir, f"rank0_{mode}.pt"), weights_only=False)
        gaps[mode] = grid_gaps(torch, f"phase 12.1 {mode}", one[mode], got, r0[mode]["logs"])
        print(f"phase 12.1 {mode}: hybrid_switch.yml in memory, b4 1024x512 ({layout}), one "
              f"process at b4 against the ranks at b2 after a bootstrap and one step (TF32 off): "
              + ", ".join(f"{k} {v:.3e} (bound {bounds[k]:.0e})" for k, v in gaps[mode].items())
              + f"; the ranks' {len(r0[mode]['digests'])} state tensors equal bit for bit")
    check_gaps("phase 12.1", gaps, DP_BOUNDS)
    steps, n_bn = DP_TIMED_STEPS, r0["n_bn"]  # 53 BatchNorms in the R50
    for r in ranks:
        check(r["finite"], f"phase 12.1 rank {r['rank']}: a non-finite loss")
        check(r["launches"] == {"pseudo_labels_kernel": 2 * steps,
                                "bn_stats_kernel": 3 * n_bn * steps},
              f"phase 12.1 rank {r['rank']}: launches {r['launches']}, expected K1 2 and K2 "
              f"{3 * n_bn} a step")
        check(r["collectives"]["collectives"] == (5 * n_bn + 6) * steps,
              f"phase 12.1 rank {r['rank']}: {r['collectives']} collectives over {steps} steps, "
              f"expected {5 * n_bn + 6} a step ({3 * n_bn} BatchNorm forwards, {2 * n_bn} "
              f"backwards, 3 in the teachers, the loss counts, the gradients, the logs)")
    step_ms = [statistics.median(r["step_ms"][1:]) for r in ranks]
    summary.update(step_ms=step_ms, peak_gib=[r["peak_gib"] for r in ranks],
                   collectives_per_step=r0["collectives"]["collectives"] / steps,
                   bytes_per_step=r0["collectives"]["bytes"] / steps,
                   debug_syncs=r0["debug_syncs"], sync_collectives=r0["sync_collectives"],
                   gaps=gaps, seconds_12_1=seconds)
    staged = (f", two of them for each of its {r0['sync_collectives']} collectives of card "
              f"tensors through the card's memory" if backend == "gloo" else "")
    print(f"phase 12.1 timed ({steps} steps, TF32 on, {layout}): median step ms per rank "
          + ", ".join(f"{v:.3f}" for v in step_ms) + " (steps 1..): "
          + "; ".join(", ".join(f"{v:.3f}" for v in r["step_ms"]) for r in ranks)
          + f"; per rank and step K1 {r0['launches']['pseudo_labels_kernel'] // steps}, K2 "
          f"{r0['launches']['bn_stats_kernel'] // steps}; {summary['collectives_per_step']:.0f} "
          f"all-reduces of {summary['bytes_per_step'] / 1e6:.3f} MB a step; host syncs the CUDA "
          f"sync debug mode counts in one step: {r0['debug_syncs']}{staged}; peak memory per "
          f"rank " + ", ".join(f"{r['peak_gib']:.3f} GiB" for r in ranks)
          + f"; {seconds:.3f} s of ranks")
    paths = {f"data_parallel_rank{r['rank']}": r["launches"] for r in ranks}

    # 12.2: the CLI under torch.distributed.run on phase 7's files
    snap, cfg = launched["snaps"]["hybrid"], launched["cfgs"]["hybrid"]
    batch, n_train = int(cfg["TRAINING"]["BATCH_SIZE"]), CLI_FRAMES["train"]
    cli = launched["results"]["hybrid"]
    seconds = cli[0]["seconds"]
    steps = n_train // batch
    boot = min(int(cfg["TRAINING"]["REPLAY_BUFFER"]), n_train) // batch
    want = {"pseudo_labels_kernel": 2 * steps, "bn_stats_kernel": n_bn * (3 * steps + boot)}
    for r in range(DP_RANKS):
        check(cli[r]["launches"] == want, f"phase 12.2 rank {r}: launches {cli[r]['launches']}, "
                                          f"expected {want} (K1 2 and K2 {3 * n_bn} a step, "
                                          f"K2 {n_bn} a bootstrap batch)")
        paths[f"data_parallel_cli_rank{r}"] = cli[r]["launches"]
    records = launched["records"]["hybrid"]
    step_records = [rec for rec in records if "Total target loss" in rec]
    check(len(step_records) == steps, f"phase 12.2: {len(step_records)} step records for {steps} "
                                      f"steps (one writer)")
    finite = all(math.isfinite(v) for rec in step_records for k, v in rec.items() if "loss" in k)
    check(finite, "phase 12.2: a non-finite loss")
    files = sorted(os.listdir(snap))
    check({"adapt_state.pt", "metrics.jsonl", "proto_current.pickle", "proto_(25,).pickle"}
          <= set(files) and not [f for f in files if f.startswith(".")],
          f"phase 12.2 wrote {files}")
    miou = {k: v for rec in records for k, v in rec.items() if k.startswith("Val mIoU")}
    stages = {}
    for key, ms in step_stage_ms(step_records).items():
        stages.setdefault(key[5:], []).extend(ms[1:-1] or ms)
    median = {k: statistics.median(v) for k, v in stages.items()}
    print(f"phase 12.2 configs/hybrid_switch.yml (phase 7's cuts, DOMAIN_ORDER [[25]]) "
          f"through torch.distributed.run --nproc-per-node {DP_RANKS} ({layout}): {seconds:.3f} s "
          f"in the phase's torchrun; per rank launches " + "; ".join(str(c["launches"]) for c in cli)
          + f"; {len(step_records)} step records from rank 0, every loss finite; files {files}; "
          f"steady stage ms " + ", ".join(f"{k} {v:.3f}" for k, v in median.items())
          + f" (sum {sum(median.values()):.3f}); last mIoU keys {json.dumps(miou)}")
    shutil.rmtree(snap, ignore_errors=True)
    summary.update(cli_seconds=seconds, cli_stage_ms=median,
                   phase_seconds=time.perf_counter() - t_phase)
    print(f"phase 12.1-12.2 checks: {summary['phase_seconds']:.3f} s")
    return paths, summary



# ---------------------------------------------------------------------------
# phases 12.3-12.5: the other families across two ranks (ADVENT, PROTO_ADVENT,
# SEGMENT training, EVALUATION)
# ---------------------------------------------------------------------------

ADV_TIMED_STEPS = 5  # phase 12.3, after 1 warm-up step (phase 9.4's count)
ADV_LAUNCHES = {"advent": {"pseudo_labels_kernel": 0, "bn_stats_kernel": 106},
                "proto_advent": {"pseudo_labels_kernel": 2, "bn_stats_kernel": 159}}
# one process at b4 against two ranks at b2 each after one step (PROTO_ADVENT
# after a bootstrap), TF32 off, in DP_BOUNDS' two modes: losses relative; the
# largest difference of the updated weights in the student's head and in the
# rest of the student (the aux head among it) against the largest entry of
# that group's update; and the discriminators' gradients (Adam's first
# moment after the step) against their largest entry. Their weights are not
# compared: Adam's first step moves each by ±lr_d, the sign of a gradient
# that is a near cancellation (BCE toward 0 and 1 of near-equal maps), which
# the forward's last bits flip where it is near 0 (as the step runs, a
# discriminator weight moved 1.58 lr_d apart). Each bound is ≈5-10x the
# larger of the two methods' readings on an H100 (loss 9.6e-08; exact: head
# 2.0e-04, backbone 3.6e-03 (ADVENT's aux head), discriminators 4.5e-05; as
# it runs: head 2.6e-04, backbone 1.7e-02, discriminators 2.4e-03).
ADV_BOUNDS = {"exact": {"loss": 1e-6, "head": 2e-3, "backbone": 2e-2, "disc": 5e-4},
              "kernels": {"loss": 1e-6, "head": 3e-3, "backbone": 1e-1, "disc": 2e-2}}
# 12.5, the ranks against one process on the same files, as users run them
# (cuDNN's TF32 convolutions at b2 against b4, which move a few pixels'
# argmax): each mIoU's absolute gap (read 2.1e-06 on an H100), the dumps'
# gap against their largest entry (3.0e-04) and each batch confidence's
# absolute gap (1.0e-07); ≈10x those
EVAL_MIOU_ATOL, EVAL_DUMP_RTOL, EVAL_CONF_ATOL = 2e-5, 3e-3, 1e-6


def adv_tensors(torch, ad, whole=False):
    """Every tensor of an ADVENT or PROTO_ADVENT adapter by a flat name: the
    student's state, both discriminators and both Adam states (`count`
    included); this rank's, or with `whole` the whole ones (on a grid the
    shards gathered: a collective every rank joins)."""
    if hasattr(ad, "d_state"):
        out = state_tensors(torch, ad.state)
        if whole:
            out.update({f"{t}/{k}": v for t in TP_TREES
                        for k, v in ad._whole(getattr(ad.state, t)).items()})
        discs = {"d_aux": ad.d_state["aux"], "d_main": ad.d_state["main"],
                 "d_aux_opt": ad.d_state["aux_opt"], "d_main_opt": ad.d_state["main_opt"]}
    else:
        fields = ("params", "batch_stats", "opt_momentum", "d_aux", "d_main", "d_aux_opt",
                  "d_main_opt")
        trees = {name: getattr(ad.state, name) for name in fields}
        if whole:
            trees = ad._trees(trees, ad._whole)
        out = {f"{tree}/{k}": v for tree in fields[:3] for k, v in trees[tree].items()}
        out["generator"] = ad.state.generator.get_state()
        discs = {name: trees[name] for name in fields[3:]}
    for name, tree in discs.items():
        if name.endswith("_opt"):
            out.update({f"{name}/{m}/{k}": v for m in ("mu", "nu") for k, v in tree[m].items()})
            out[f"{name}/count"] = torch.tensor(tree["count"])
        else:
            out.update({f"{name}/{k}": v for k, v in tree.items()})
    return out


def adv_compare_step(torch, device, config, batch, exact, others=None, split=False,
                     fool_only=False):
    """The adapter of configs/<config>.yml (advent or proto_advent) at
    b`batch` 1024x512 on `device`, seeded weights and discriminators (OTHERS
    overrides `others`), PROTO_ADVENT bootstrapped on its data index's rows
    of a seeded source batch, after one step on its rows of seeded batches
    at the config's own LRs, with TF32 off and deterministic cuDNN (`exact`:
    `batch_invariant`; `split`: the layers a (1 x TP_SIZE) grid shards
    compute in its blocks, the discriminators' among them,
    `split_sharded_layers`; `fool_only`: the source labels all ignored and
    no weight decay, so that the student's momentum after the step is the
    gradient of the fool losses alone). Returns (adapter, one-step fn of
    (src, trg) device batches, logs, local batch fn, the student's and
    discriminators' weights before the step on the host)."""
    from onda_torch.parallel import distributed as D

    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = False, True
    with batch_invariant(torch) if exact else contextlib.nullcontext():
        ad = make_adapter(torch, device, MAIN_HW, batch, config=config, others=others)
        if split:
            n = split_sharded_layers(torch, ad)
            want = TP_SHARDED_LAYERS + (3 if config == "advent" else 0)
            check(n == want, f"the {config} witness split {n} layers, expected {want}")
        rank, b = D.data_rank(), batch // D.data_world()

        def local(bt):
            return {k: v[rank * b:(rank + 1) * b] for k, v in bt.items()}

        start = {k: v.detach().to("cpu", copy=True) for k, v in adv_tensors(torch, ad).items()
                 if k.startswith(("params/", "d_main/", "d_aux/"))}
        lr, lr_d = float(ad.cfg_spec.LEARNING_RATE), float(ad.cfg_spec.LEARNING_RATE_D)
        if fool_only:
            ad.cfg_spec.WEIGHT_DECAY = 0.0
        if config == "proto_advent":
            ad.calculate_prototypes([local(make_batches(torch, 1, batch, MAIN_HW, 30)[0])])
            step = ad.pa_step_fn()

            def one(src, trg):
                ad.state, ad.d_state, logs = step(ad.state, ad.d_state, src["image"],
                                                  src["label"], trg["image"], lr, lr_d)
                return logs
        else:
            step = ad.build_step()

            def one(src, trg):
                ad.state, logs = step(ad.state, src["image"], src["label"], trg["image"], lr, lr_d)
                return logs
        dev = ad.device
        src = {k: v.to(dev) for k, v in local(make_batches(torch, 1, batch, MAIN_HW, 32)[0]).items()}
        if fool_only:
            src["label"] = torch.full_like(src["label"], 255)
        trg = {k: v.to(dev) for k, v in local(make_batches(torch, 1, batch, MAIN_HW, 33)[0]).items()}
        logs = dict(one(src, trg).items())
        torch.cuda.synchronize()
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = True, False
    return ad, one, logs, local, start


def adv_compared(torch, ad):
    """What 12.3 and 13.4 compare, on the host: the student's parameters and
    SGD momentum (its gradient after one step, with weight decay's share),
    both discriminators' first moments (their gradients after one step), the
    Adam counts (whole: on a grid every rank joins their gathers); a SEGMENT
    trainer's parameters and momentum."""
    tensors = family_tensors(torch, ad, whole=True)
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()
            if k.startswith(("params/", "opt_momentum/", "momentum/", "d_main_opt/mu/",
                             "d_aux_opt/mu/")) or k.endswith("_opt/count")}


def family_tensors(torch, obj, whole=False):
    """`adv_tensors` of an ADVENT or PROTO_ADVENT adapter; a SEGMENT trainer's
    parameters, BN buffers and momentum by flat names (`whole`: gathered)."""
    if not hasattr(obj, "momentum_buf"):
        return adv_tensors(torch, obj, whole)
    cut = obj._whole if whole else (lambda tree: tree)
    return {f"{t}/{k}": v for t, tree in (("params", obj.params), ("batch_stats", obj.batch_stats),
                                          ("momentum", obj.momentum_buf))
            for k, v in cut(tree).items()}


def seg_compare_step(torch, device, batch, exact, others=None, split=False):
    """The SegmentTrainer of training_fog.yml's multi-level R50 at b`batch`
    1024x512 on `device` (OTHERS overrides `others`), after one step at its
    LR on its data index's rows of a seeded batch, with TF32 off and
    deterministic cuDNN (`exact`, `split`: as `adv_compare_step`). Returns
    (trainer, one-step fn of a device batch, logs, local batch fn, the
    parameters before the step on the host)."""
    from onda_torch.parallel import distributed as D

    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = False, True
    with batch_invariant(torch) if exact else contextlib.nullcontext():
        tr = make_trainer(torch, device, MAIN_HW, others=others)
        if split:
            n = split_sharded_layers(torch, tr)
            check(n == TP_SHARDED_LAYERS, f"the SEGMENT witness split {n} layers, expected "
                                          f"{TP_SHARDED_LAYERS}")
        rank, b = D.data_rank(), batch // D.data_world()

        def local(bt):
            return {k: v[rank * b:(rank + 1) * b] for k, v in bt.items()}

        start = {f"params/{k}": v.detach().to("cpu", copy=True) for k, v in tr.params.items()}
        lr = float(tr.spec.LEARNING_RATE)

        def one(bt):
            return {"Segmentation loss": tr.step(bt["image"], bt["label"], lr)}

        bt = {k: v.to(tr.device) for k, v in local(make_batches(torch, 1, batch, MAIN_HW, 37)[0])
              .items()}
        logs = {k: float(v) for k, v in one(bt).items()}
        torch.cuda.synchronize()
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = True, False
    return tr, one, logs, local, start


def family_references(torch):
    """The one-process references of 12.3 and 13.4: ADVENT, PROTO_ADVENT and
    a SEGMENT step at b4 after one step, in both of DP_BOUNDS' modes and,
    batch-invariant, as phase 13's witness ("exact_split"), and ADVENT's
    fool-only step as the witness ("advent_fool"): the compared tensors
    (`adv_compared`), the logs and the weights before the step."""
    one = {}
    for config in TP_ADV_LAUNCHES:
        for mode in (*DP_BOUNDS, "exact_split"):
            release(torch)
            args = (torch, "cuda", 4, mode != "kernels")
            if config == "segment":
                obj, _, logs, _, start = seg_compare_step(*args, split=mode == "exact_split")
            else:
                obj, _, logs, _, start = adv_compare_step(args[0], args[1], config, *args[2:],
                                                          split=mode == "exact_split")
            one[(config, mode)] = {"w": adv_compared(torch, obj), "logs": logs, "start": start}
            del obj
    release(torch)
    obj, _, logs, _, start = adv_compare_step(torch, "cuda", "advent", 4, True, split=True,
                                              fool_only=True)
    one[("advent_fool", "exact_split")] = {"w": adv_compared(torch, obj), "logs": logs,
                                           "start": start}
    del obj
    release(torch)
    return one


def adv_rank(work):
    """One rank of phase 12.3 (run under torch.distributed.run): for ADVENT
    and PROTO_ADVENT, the compared step in both modes, the digests of the
    whole state, then ADV_TIMED_STEPS timed steps after one with TF32 on and
    one more under the CUDA sync debug mode; writes adv_rank<r>.json (and
    rank 0 the compared weights) into `work`."""
    import torch

    sys.path.insert(0, HERE)
    from onda_torch.ops import kernels as K
    from onda_torch.parallel import distributed as D

    device = D.initialize("cuda")
    rank, world, batch = D.rank(), D.world(), 4
    out = {"rank": rank, "world": world, "backend": D.backend()}
    for config in ADV_LAUNCHES:
        res = out[config] = {}
        for mode in ADV_BOUNDS:  # "kernels" last: its adapter goes on to the timed steps
            ad, one, logs, local, _ = adv_compare_step(torch, device, config, batch,
                                                       mode == "exact")
            res[mode] = {"logs": logs, "digests": digests_of(torch, adv_tensors(torch, ad))}
            if rank == 0:
                torch.save(adv_compared(torch, ad), os.path.join(work, f"adv0_{config}_{mode}.pt"))
            if mode == "exact":
                del ad, one
                release(torch)
        feed = [({k: v.to(device) for k, v in local(s).items()},
                 {k: v.to(device) for k, v in local(t).items()}) for s, t in zip(
            make_batches(torch, 1 + ADV_TIMED_STEPS, batch, MAIN_HW, 34),
            make_batches(torch, 1 + ADV_TIMED_STEPS, batch, MAIN_HW, 35))]
        torch.cuda.synchronize()
        K.reset_launches()
        D.reset_counts()
        torch.cuda.reset_peak_memory_stats(device)
        times, finite = [], True
        for src, trg in feed:
            t = time.perf_counter()
            finite &= math.isfinite(one(src, trg)["Adversarial loss"])  # ends at its log read
            times.append(1e3 * (time.perf_counter() - t))
        res.update(step_ms=times, finite=finite, launches=dict(K.launches),
                   collectives=D.counts(),
                   peak_gib=torch.cuda.max_memory_allocated(device) / 2**30)
        D.reset_counts()
        _, syncs = count_syncs(torch, lambda: one(*feed[0]))
        res.update(debug_syncs=len(syncs), sync_collectives=D.counts()["collectives"])
        del ad, one, feed
        release(torch)
    # a SEGMENT step of training_fog.yml's multi-level R50 at the same size
    trainer = make_trainer(torch, device, MAIN_HW)
    feed = [{k: v.to(device) for k, v in local(bt).items()}
            for bt in make_batches(torch, 1 + ADV_TIMED_STEPS, batch, MAIN_HW, 36)]
    torch.cuda.synchronize()
    K.reset_launches()
    D.reset_counts()
    torch.cuda.reset_peak_memory_stats(device)
    times, finite = [], True
    for bt in feed:
        t = time.perf_counter()
        finite &= math.isfinite(float(trainer.step(bt["image"], bt["label"], 2.5e-4)))
        times.append(1e3 * (time.perf_counter() - t))
    out["segment"] = {
        "step_ms": times, "finite": finite, "launches": dict(K.launches),
        "collectives": D.counts(), "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30,
        "digests": digests_of(torch, {**{f"params/{k}": v for k, v in trainer.params.items()},
                                      **{f"stats/{k}": v for k, v in trainer.batch_stats.items()},
                                      **{f"momentum/{k}": v
                                         for k, v in trainer.momentum_buf.items()}})}
    del trainer, feed
    release(torch)
    with open(os.path.join(work, f"adv_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    D.destroy()


def adv_gaps(torch, got, want, start):
    """12.3's and 13.4's gaps of the ranks' weights against one process's (see
    ADV_BOUNDS; a SEGMENT trainer's have no discriminators)."""
    groups = {"head": [k for k in start if k.startswith("params/layer6")],
              "backbone": [k for k in start if k.startswith("params/")
                           and not k.startswith("params/layer6")]}
    gaps = {g: update_gap(got, want, start, [k for k in keys if not torch.equal(
        want[k], start[k])]) for g, keys in groups.items()}
    moments = [k for k in want if "_opt/mu/" in k and bool(want[k].any())]
    if not moments:
        return gaps
    gaps["disc"] = update_gap(got, want, {k: torch.zeros_like(want[k]) for k in moments}, moments)
    return gaps


def grad_gaps(torch, got, want, start):
    """13.4's gaps of the grid's student against the witness's after one
    step, besides `adv_gaps`: its SGD momentum (the step's gradient, with
    weight decay's share) by group, the largest difference over the largest
    entry; and "backbone_excess", the backbone's update gap once each weight
    may differ by the rounding of its update: 4 units in the last place of
    its value (a backbone weight takes up to 4 chained sub-updates,
    `optim.label_params`)."""
    out = {}
    for group in ("head", "backbone"):
        keys = [k for k in want if k.startswith(("opt_momentum/", "momentum/"))
                and k.split("/", 1)[1].startswith("layer6") == (group == "head")]
        scale = max(want[k].abs().max().item() for k in keys)
        diff = max((got[k].double() - want[k].double()).abs().max().item() for k in keys)
        out[f"{group}_grad"] = diff / max(scale, 1e-30)
    excess = update = 0.0
    for k in start:
        if k.startswith("params/") and not k.startswith("params/layer6"):
            w = torch.maximum(got[k].abs(), want[k].abs())
            last_places = 4 * (torch.nextafter(w, torch.full_like(w, math.inf)) - w)
            excess = max(excess, ((got[k] - want[k]).abs() - last_places).max().item())
            update = max(update, (want[k] - start[k]).abs().max().item())
    out["backbone_excess"] = max(excess, 0.0) / max(update, 1e-30)
    return out


def check_one_writer(tag, snap, want_files):
    """The files of a run's snapshot directory: `want_files` among them, each
    once, and no hidden temporary left."""
    files = sorted(os.listdir(snap))
    check(set(want_files) <= set(files) and not [f for f in files if f.startswith(".")],
          f"{tag}: wrote {files}, expected {sorted(want_files)} and no temporary")
    return files


def data_parallel_families_path(torch, K, out_dir, work, root, rows, refs, launched):
    """Phases 12.3-12.5: 12.3 ADVENT and PROTO_ADVENT in memory at full width,
    one process at b4 against two ranks of b2 (both modes, the ranks bit for
    bit), then timed; 12.4 advent.yml (and an AUTO_RESUME run of it),
    proto_advent.yml and training_fog.yml (SEGMENT, then its adaptation)
    through the CLI under torch.distributed.run on phase 7's files; 12.5
    validation_offline_fog.yml, its EVAL_SWEEP and validation.yml
    (PREDICTION_SAVE) on 12.4's snapshots, the ranks against one process.
    `refs`: the one-process references (`family_references`); `launched`:
    the ranks' runs (`data_parallel_ranks`). Returns launch counts by path
    and the numbers."""
    backend, layout = dp_layout(torch)
    paths, summary = {}, {}
    n_train = CLI_FRAMES["train"]

    # 12.3: the two ranks against the one-process references
    t = time.perf_counter()
    one = refs
    adv_dir = launched["dirs"]["adv"]
    seconds = launched["job_seconds"][1]
    ranks = []
    for r in range(DP_RANKS):
        with open(os.path.join(adv_dir, f"adv_rank{r}.json")) as f:
            ranks.append(json.load(f))
    check(all(r["world"] == DP_RANKS and r["backend"] == backend for r in ranks),
          f"phase 12.3: ranks report {[(r['world'], r['backend']) for r in ranks]}")
    n_bn = 53
    for config, per_step in ADV_LAUNCHES.items():
        r0 = ranks[0][config]
        for mode, bounds in ADV_BOUNDS.items():
            differ = sorted(k for k in r0[mode]["digests"] if any(
                r[config][mode]["digests"][k] != r0[mode]["digests"][k] for r in ranks[1:]))
            check(not differ, f"phase 12.3 {config} {mode}: the ranks' states differ after the "
                              f"step in {differ[:6]}")
            check(all(r[config][mode]["logs"] == r0[mode]["logs"] for r in ranks),
                  f"phase 12.3 {config} {mode}: the ranks' logs differ")
            got = torch.load(os.path.join(adv_dir, f"adv0_{config}_{mode}.pt"), weights_only=False)
            want = one[(config, mode)]
            logs = r0[mode]["logs"]
            keys = [k for k in want["logs"] if "loss" in k]
            gaps = {"loss": max(abs(logs[k] - want["logs"][k]) / max(abs(want["logs"][k]), 1e-12)
                                for k in keys),
                    **adv_gaps(torch, got, want["w"], want["start"])}
            counts = {k: int(v) for k, v in got.items() if k.endswith("_opt/count")}
            check(counts == {k: int(v) for k, v in want["w"].items() if k.endswith("_opt/count")},
                  f"phase 12.3 {config} {mode}: Adam counts {counts} differ from one process's")
            print(f"phase 12.3 {config} {mode}: {config}.yml in memory, b4 1024x512 ({layout}), "
                  f"one process at b4 against the ranks at b2 after one step (TF32 off): "
                  + ", ".join(f"{k} {v:.3e} (bound {bounds[k]:.0e})" for k, v in gaps.items())
                  + f"; Adam counts {counts}; the ranks' {len(r0[mode]['digests'])} state "
                  f"tensors (both discriminators and Adam states among them) equal bit for bit")
            for key, gap in gaps.items():
                check(gap <= bounds[key], f"phase 12.3 {config} {mode}: {key} gap {gap:.3e} > "
                                          f"{bounds[key]}")
            summary[f"{config}_{mode}_gaps"] = gaps
        n_steps = 1 + ADV_TIMED_STEPS
        want_collectives = (4 * n_bn + 4) if config == "advent" else (5 * n_bn + 3 + 4)
        for r in ranks:
            res = r[config]
            check(res["finite"], f"phase 12.3 {config} rank {r['rank']}: a non-finite loss")
            check(res["launches"] == {k: v * n_steps for k, v in per_step.items()},
                  f"phase 12.3 {config} rank {r['rank']}: launches {res['launches']}, expected "
                  f"{per_step} a step")
            check(res["collectives"]["collectives"] == want_collectives * n_steps,
                  f"phase 12.3 {config} rank {r['rank']}: {res['collectives']} collectives over "
                  f"{n_steps} steps, expected {want_collectives} a step")
            paths[f"data_parallel_{config}_in_memory_rank{r['rank']}"] = res["launches"]
        step_ms = [statistics.median(r[config]["step_ms"][1:]) for r in ranks]
        staged = (f", two for each of its {r0['sync_collectives']} collectives of card tensors "
                  f"through the card's memory" if backend == "gloo" else "")
        print(f"phase 12.3 {config} timed ({ADV_TIMED_STEPS} steps after 1, TF32 on, {layout}): "
              f"median step ms per rank " + ", ".join(f"{v:.3f}" for v in step_ms) + " ("
              + "; ".join(", ".join(f"{v:.3f}" for v in r[config]["step_ms"]) for r in ranks)
              + f"); per rank and step {per_step}; {want_collectives} collectives of "
              f"{r0['collectives']['bytes'] / n_steps / 1e6:.3f} MB a step; host syncs the CUDA "
              f"sync debug mode counts in one step: {r0['debug_syncs']}{staged}; peak memory per "
              f"rank " + ", ".join(f"{r[config]['peak_gib']:.3f} GiB" for r in ranks))
        summary.update({f"{config}_step_ms": step_ms,
                        f"{config}_peak_gib": [r[config]["peak_gib"] for r in ranks],
                        f"{config}_collectives_per_step": want_collectives,
                        f"{config}_bytes_per_step": r0["collectives"]["bytes"] / n_steps,
                        f"{config}_debug_syncs": r0["debug_syncs"]})
    r0 = ranks[0]["segment"]
    n_steps = 1 + ADV_TIMED_STEPS
    differ = sorted(k for k in r0["digests"] if ranks[1]["segment"]["digests"][k] != r0["digests"][k])
    check(not differ, f"phase 12.3 segment: the ranks' trainers differ after {n_steps} steps in "
                      f"{differ[:6]}")
    for r in ranks:
        res = r["segment"]
        check(res["finite"], f"phase 12.3 segment rank {r['rank']}: a non-finite loss")
        check(res["launches"] == {"pseudo_labels_kernel": 0, "bn_stats_kernel": n_bn * n_steps},
              f"phase 12.3 segment rank {r['rank']}: launches {res['launches']}, expected K2 "
              f"{n_bn} a step")
        check(res["collectives"]["collectives"] == (2 * n_bn + 2) * n_steps,
              f"phase 12.3 segment rank {r['rank']}: {res['collectives']} collectives over "
              f"{n_steps} steps, expected {2 * n_bn + 2} a step")
        paths[f"data_parallel_segment_in_memory_rank{r['rank']}"] = res["launches"]
    step_ms = [statistics.median(r["segment"]["step_ms"][1:]) for r in ranks]
    print(f"phase 12.3 segment timed (training_fog.yml's multi-level R50, b4 1024x512 as two "
          f"ranks of b2, {ADV_TIMED_STEPS} steps after 1, TF32 on, {layout}): median step ms per "
          f"rank " + ", ".join(f"{v:.3f}" for v in step_ms) + " ("
          + "; ".join(", ".join(f"{v:.3f}" for v in r["segment"]["step_ms"]) for r in ranks)
          + f"); per rank and step K2 {n_bn}; {2 * n_bn + 2} collectives of "
          f"{r0['collectives']['bytes'] / n_steps / 1e6:.3f} MB a step; peak memory per rank "
          + ", ".join(f"{r['segment']['peak_gib']:.3f} GiB" for r in ranks)
          + f"; the ranks' {len(r0['digests'])} trainer tensors equal bit for bit")
    summary.update(segment_step_ms=step_ms, segment_peak_gib=[r["segment"]["peak_gib"]
                                                              for r in ranks],
                   segment_bytes_per_step=r0["collectives"]["bytes"] / n_steps)
    summary["seconds_12_3"] = time.perf_counter() - t
    print(f"phase 12.3: {summary['seconds_12_3']:.3f} s ({seconds:.3f} s of ranks with start-up)")

    # 12.4: the CLI under torch.distributed.run on phase 7's files (chained
    # in the phase's torchrun, one domain each)
    t = time.perf_counter()
    runs = {}

    def cli_run(name):
        ranks, records = launched["results"][name], launched["records"][name]
        for r in ranks:
            paths[f"data_parallel_cli_{name}_rank{r['rank']}"] = r["launches"]
        check(all(math.isfinite(v) for rec in records for k, v in rec.items()
                  if "loss" in k and isinstance(v, float)), f"phase 12.4 {name}: a non-finite loss")
        runs[name] = {"ranks": ranks, "text": launched["text"], "seconds": ranks[0]["seconds"],
                      "records": records, "snap": launched["snaps"][name],
                      "cfg": launched["cfgs"][name], "cfg_path": launched["runs"][name]}
        return runs[name]

    run = cli_run("advent")
    batch = int(run["cfg"]["TRAINING"]["BATCH_SIZE"])
    steps = n_train // batch
    want = {"pseudo_labels_kernel": 0, "bn_stats_kernel": 106 * steps}
    check(all(r["launches"] == want for r in run["ranks"]),
          f"phase 12.4 advent: launches {[r['launches'] for r in run['ranks']]}, expected {want}")
    adv_steps = [rec for rec in run["records"] if "Adversarial loss" in rec]
    check(len(adv_steps) == steps, f"phase 12.4 advent: {len(adv_steps)} step records for "
                                   f"{steps} steps (one writer)")
    files = check_one_writer("phase 12.4 advent", run["snap"], ["advent_state.pt", "metrics.jsonl"])
    print(f"phase 12.4 advent.yml (DOMAIN_ORDER [[25]], seeded weights, {steps} steps at "
          f"global b{batch}, {layout}): {run['seconds']:.3f} s; per rank launches "
          + "; ".join(str(r["launches"]) for r in run["ranks"]) + f"; {len(adv_steps)} step "
          f"records from rank 0, every loss finite; files {files}")
    run = cli_run("advent_resume")
    # the ranks' lines may share a line of the joined output: matched, not split
    restored = re.findall(r"AUTO_RESUME: restoring (\S+?advent_state\.pt)", run["text"])
    check(len(restored) == DP_RANKS and len(set(restored)) == 1,
          f"phase 12.4 advent AUTO_RESUME: {restored}, expected both ranks to restore "
          f"advent_state.pt")
    state = torch.load(os.path.join(run["snap"], "advent_state.pt"), map_location="cpu",
                       weights_only=False)
    check(state["step"] == steps + n_train // batch and state["d_main_opt"]["count"]
          == state["d_aux_opt"]["count"] == state["step"],
          f"phase 12.4 advent AUTO_RESUME: step {state['step']}, Adam counts "
          f"{state['d_main_opt']['count']}/{state['d_aux_opt']['count']} after the resumed run")
    del state
    print(f"phase 12.4 advent.yml AUTO_RESUME (DOMAIN_ORDER [[25]]): {run['seconds']:.3f} s; "
          f"{restored}; advent_state.pt step {steps} + {n_train // batch}")

    run = cli_run("proto_advent")
    boot = min(int(run["cfg"]["TRAINING"]["REPLAY_BUFFER"]), n_train) // batch
    want = {"pseudo_labels_kernel": 2 * steps, "bn_stats_kernel": 159 * steps + 53 * boot}
    check(all(r["launches"] == want for r in run["ranks"]),
          f"phase 12.4 proto_advent: launches {[r['launches'] for r in run['ranks']]}, "
          f"expected {want}")
    pa_steps = [rec for rec in run["records"] if "Adversarial loss" in rec]
    check(len(pa_steps) == steps, f"phase 12.4 proto_advent: {len(pa_steps)} step records")
    files = check_one_writer("phase 12.4 proto_advent", run["snap"],
                             ["adapt_state.pt", "metrics.jsonl", "proto_current.pickle",
                              "proto_(25,).pickle"])
    print(f"phase 12.4 proto_advent.yml (DOMAIN_ORDER [[25]], {steps} steps, {boot} "
          f"bootstrap batches): {run['seconds']:.3f} s; per rank launches "
          + "; ".join(str(r["launches"]) for r in run["ranks"]) + f"; files {files}")

    run = cli_run("segment")
    seg_batch = int(run["cfg"]["TRAINING"]["BATCH_SIZE"])
    seg_steps = n_train // seg_batch
    boot = min(int(run["cfg"]["TRAINING"]["REPLAY_BUFFER"]), n_train) // seg_batch
    want = {"pseudo_labels_kernel": 0, "bn_stats_kernel": 53 * (seg_steps + boot)}
    check(all(r["launches"] == want for r in run["ranks"]),
          f"phase 12.4 training_fog: launches {[r['launches'] for r in run['ranks']]}, expected "
          f"{want} (K2 53 per SEGMENT step and bootstrap batch)")
    seg = [rec["Segmentation loss"] for rec in run["records"] if "Segmentation loss" in rec]
    epochs = [rec for rec in run["records"] if "epoch" in rec]
    check(len(seg) == -(-seg_steps // 10) and len(epochs) == 1,
          f"phase 12.4 training_fog: {len(seg)} loss and {len(epochs)} epoch records")
    files = check_one_writer("phase 12.4 training_fog", run["snap"], [
        "model_train_[[0]].pth", "model_train_[[0]]_after_src_training.pth", "adapt_state.pt",
        "metrics.jsonl"])
    trained = torch.load(os.path.join(run["snap"], "model_train_[[0]].pth"))
    after = torch.load(os.path.join(run["snap"], "model_train_[[0]]_after_src_training.pth"))
    check(all(torch.equal(trained[k], v) for k, v in after.items()),
          "phase 12.4 training_fog: model_train_[[0]].pth != _after_src_training.pth")
    del trained, after
    print(f"phase 12.4 training_fog.yml (SEGMENT 1 epoch of {seg_steps} steps at global "
          f"b{seg_batch} 128x64, then the adaptation's bootstrap of {boot} batches, EPOCHS 0 as "
          f"shipped): {run['seconds']:.3f} s; per rank launches "
          + "; ".join(str(r["launches"]) for r in run["ranks"]) + f"; Segmentation loss "
          + ", ".join(f"{v:.4f}" for v in seg) + f"; epoch "
          + json.dumps({k: v for k, v in epochs[0].items() if k.startswith(("Val", "val"))})
          + f"; files {files}")
    summary.update({f"cli_{k}_seconds": v["seconds"] for k, v in runs.items()})
    summary["seconds_12_4"] = time.perf_counter() - t
    print(f"phase 12.4: {summary['seconds_12_4']:.3f} s")

    # 12.5: EVALUATION on 12.4's SEGMENT snapshots, the ranks (chained in the
    # phase's torchrun) then one process
    t = time.perf_counter()
    snap = runs["segment"]["snap"]
    preds = {"ranks": launched["preds"], "one": os.path.join(work, "dp_predictions_one")}
    evals = dp_eval_runs(preds["one"])
    for name, (config, cuts) in evals.items():
        ranks = launched["results"][f"eval_{name}"]
        for r in ranks:
            paths[f"data_parallel_cli_{name}_rank{r['rank']}"] = r["launches"]
        res = {"ranks": {"records": launched["records"][f"eval_{name}"], "text": launched["text"],
                         "seconds": ranks[0]["seconds"]}}
        cfg_path = os.path.join(work, f"dp_{name}_one.yml")
        workflow_config(config, cfg_path, **{"SCHEME.PATH": root, "MODEL.LOAD": None,
                                             "OTHERS.SNAPSHOT_DIR": snap, **cuts})
        n_records = len(read_records(snap))
        _, _, seconds, text, runner = run_cli(torch, K, cfg_path,
                                              os.path.join(out_dir, f"dp_{name}_one.log"))
        del runner
        release(torch)
        res["one"] = {"records": read_records(snap)[n_records:], "text": text, "seconds": seconds}
        miou = {who: {k: v for rec in r["records"] for k, v in rec.items()
                      if k.startswith("Val mIoU")} for who, r in res.items()}
        loaded = {who: sorted(set(re.findall(r"Model (\S+) is being loaded", r["text"])))
                  for who, r in res.items()}
        check(loaded["ranks"] == loaded["one"] and len(loaded["one"]) == 1,
              f"phase 12.5 {name}: the ranks loaded {loaded['ranks']}, one process "
              f"{loaded['one']}")
        line = f"phase 12.5 {name} ({evals[name][0]}.yml on 12.4's SEGMENT snapshots, {layout}): "
        if name == "predictions":
            dirs = sorted(os.listdir(preds["one"]))
            check(sorted(os.listdir(preds["ranks"])) == dirs and dirs,
                  f"phase 12.5 predictions: domains {os.listdir(preds['ranks'])} against {dirs}")
            worst, n_files = 0.0, 0
            for d in dirs:
                names = sorted(os.listdir(os.path.join(preds["one"], d)))
                check(sorted(os.listdir(os.path.join(preds["ranks"], d))) == names,
                      f"phase 12.5 predictions {d}: the ranks dumped other files")
                for fname in names:
                    want_t = torch.load(os.path.join(preds["one"], d, fname))
                    got_t = torch.load(os.path.join(preds["ranks"], d, fname))
                    b = len(want_t) // DP_RANKS
                    order = [r + DP_RANKS * j for r in range(DP_RANKS) for j in range(b)]
                    check(got_t.shape == want_t.shape, f"phase 12.5 {d}/{fname}: shape "
                                                       f"{tuple(got_t.shape)}")
                    gap = ((got_t - want_t[order]).abs().max()
                           / want_t.abs().max().clamp(min=1e-30)).item()
                    worst, n_files = max(worst, gap), n_files + 1
            check(worst <= EVAL_DUMP_RTOL, f"phase 12.5 predictions: the rank-major dumps differ from "
                                      f"one process's by {worst:.3e} of their largest entry")
            conf = {who: [rec["Prediction confidence"] for rec in r["records"]
                          if "Prediction confidence" in rec] for who, r in res.items()}
            check(len(conf["ranks"]) == len(conf["one"]) == n_files,
                  f"phase 12.5 predictions: {len(conf['ranks'])} confidence records from the "
                  f"ranks, {len(conf['one'])} from one process, {n_files} dumps")
            conf_gap = max(abs(a - b) for a, b in zip(conf["ranks"], conf["one"]))
            check(conf_gap <= EVAL_CONF_ATOL, f"phase 12.5 predictions: confidence gap "
                                              f"{conf_gap:.3e}")
            line += (f"{n_files} dumps equal one process's after the rank-major reorder within "
                     f"{worst:.3e} of their largest entry (bound {EVAL_DUMP_RTOL:.0e}); global "
                     f"confidence within {conf_gap:.3e} (bound {EVAL_CONF_ATOL:.0e})")
        else:
            check(set(miou["ranks"]) == set(miou["one"]) and miou["one"],
                  f"phase 12.5 {name}: mIoU keys {sorted(miou['ranks'])} against "
                  f"{sorted(miou['one'])}")
            gap = max(abs(miou["ranks"][k] - v) for k, v in miou["one"].items())
            exact = all(miou["ranks"][k] == v for k, v in miou["one"].items())
            check(gap <= EVAL_MIOU_ATOL, f"phase 12.5 {name}: mIoU gap {gap:.3e} > {EVAL_MIOU_ATOL}")
            if name == "sweep":
                swept = {who: re.findall(r"sweep: (\S+) mIoU", r["text"])
                         for who, r in res.items()}
                # each rank prints its sweep lines: every file twice
                check(sorted(swept["ranks"]) == sorted(swept["one"] * DP_RANKS),
                      f"phase 12.5 sweep: the ranks swept {swept['ranks']}, one process "
                      f"{swept['one']}")
                line += f"swept {swept['one']}; "
            line += (f"{len(miou['one'])} Val mIoU keys, the ranks' against one process's: "
                     f"largest gap {gap:.3e} ({'equal' if exact else 'not bit-equal'}); loaded "
                     f"{loaded['one']}")
        print(line + f"; {res['ranks']['seconds']:.3f} s (ranks), {res['one']['seconds']:.3f} s "
                     f"(one process)")
        summary[f"eval_{name}_seconds"] = res["ranks"]["seconds"]
    for d in preds.values():
        shutil.rmtree(d, ignore_errors=True)
    for run in runs.values():
        shutil.rmtree(run["snap"], ignore_errors=True)
    summary["seconds_12_5"] = time.perf_counter() - t
    print(f"phase 12.5: {summary['seconds_12_5']:.3f} s")
    return paths, summary


# ---------------------------------------------------------------------------
# phase 13: OTHERS.TENSOR_PARALLEL on a (data x model) grid (the PROTO_ONLINE
# family)
# ---------------------------------------------------------------------------

TP_SIZE = 2
TP_GRIDS = {"13.1": (2, 6), "13.2": (4, 2)}  # sub-phase: (ranks, timed steps)
# the trees of the state that hold the model's tensors (13.3 compares them)
TP_TREES = ("params", "batch_stats", "alt_batch_stats", "opt_momentum", "ema_params",
            "static_params", "static_batch_stats", "dynamic_params", "dynamic_batch_stats")
TP_SHARDED_LAYERS = 60  # the Conv2d/Linear a grid shards: 46 of R50, 7 in each ProDA head
# one process at b4 against the grid after a bootstrap and one step, in
# DP_BOUNDS' two modes. Batch-invariance does not make the grid's arithmetic
# one process's: each sharded layer computes its output channels in tp
# blocks (other GEMM shapes) and its input gradient as the sum of their
# partial products. "exact_split" holds the grid batch-invariant against a
# witness that does just that in one process (`split_sharded_layers`), at
# DP_BOUNDS' "exact" bounds (read ≤1.430e-05 on an NVIDIA H100); "exact"
# against the plain one process, whose backbone bound is 3x the witness's own
# gap to it (read 1.005e-02 on an NVIDIA H100, as the grid's: BatchNorms of
# near-constant channels amplify the blocks' last bits).
TP_BOUNDS = {"exact": {**DP_BOUNDS["exact"], "backbone": 3e-2},
             "exact_split": DP_BOUNDS["exact"], "kernels": DP_BOUNDS["kernels"]}


def split_sharded_layers(torch, ad):
    """Phase 13's witness: every Conv2d and Linear of the adapter's (or
    SEGMENT trainer's) model, and of ADVENT's discriminators, that a
    (1 x TP_SIZE) grid shards computes its output channels in TP_SIZE
    blocks, as the grid's ranks do, and (through autograd) its input
    gradient as the sum of the blocks' partial products, in one process
    with no collective. Returns how many layers."""
    import types

    import torch.nn.functional as F

    from onda_torch.parallel import tensor as T

    Conv2d = torch.nn.Conv2d

    def blocks(m):
        biases = [None] * TP_SIZE if m.bias is None else m.bias.chunk(TP_SIZE)
        return zip(m.weight.chunk(TP_SIZE), biases)

    def conv(m, x):
        return torch.cat([m._conv_forward(x, w, b) for w, b in blocks(m)], dim=1)

    def linear(m, x):
        return torch.cat([F.linear(x, w, b) for w, b in blocks(m)], dim=-1)

    state = getattr(ad, "state", None)  # a SEGMENT trainer has none
    models = [(ad.model, ad.params if state is None else state.params)]
    if hasattr(state, "d_main"):  # ADVENT's discriminators are sharded too
        models.append((ad.disc, state.d_main))
    n = 0
    for model, tensors in models:
        plan = T.tensor_parallel_plan({k: v.shape for k, v in tensors.items()}, TP_SIZE)
        modules = dict(model.named_modules())
        for name in plan:
            m = modules.get(name.rsplit(".", 1)[0])
            if name.endswith(".weight") and isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                m.forward = types.MethodType(conv if isinstance(m, Conv2d) else linear, m)
                n += 1
    return n


def tp_layout(torch, world):
    """The backend the grid's ranks will pick here, and the layout in words."""
    from onda_torch.parallel import distributed as D

    cards = torch.cuda.device_count()
    backend = D.choose_backend("cuda", world, cards)
    where = (f"one card each (cards 0-{world - 1})" if backend == "nccl"
             else f"all on card 0 ({cards} card(s) here): gloo, card tensors through the card's "
                  f"memory (CUDA IPC)")
    return backend, (f"{world // TP_SIZE} data x {TP_SIZE} model, {world} ranks, {where}")


def whole_state(torch, ad):
    """The adapter's parameters (whole: its shards gathered over the model
    group, a collective every rank joins) and prototypes, on the host."""
    return {"params": {k: v.detach().to("cpu", copy=True)
                       for k, v in ad._whole(ad.state.params).items()},
            "proto": {k: v.detach().to("cpu", copy=True) for k, v in vars(ad.state.proto).items()}}


TRANSPORT_MB = (0.004, 1, 16, 64, 256, 275)  # phase 13.0's sizes; 275 MB: two pieces


def transport_rows(torch):
    """Phase 13.0, on the ranks of 13.1 (every rank on one card): the sum
    and the gather of a card tensor among the ranks, through the card
    channel (`shared_card`) and through gloo, at TRANSPORT_MB (one size
    above the channel's buffer: pieces). Each rank's tensor is seeded
    random; the channel's sum must equal the ranks' tensors added in rank
    order and its gather their stack, bit for bit. Then both are timed
    (host wall time a call, the ranks meeting before and after)."""
    import torch.distributed as dist

    from onda_torch.parallel import distributed as D
    from onda_torch.parallel import shared_card

    rank, world = D.rank(), D.world()
    card = shared_card.channel(None, world, rank, "world")
    check(card is not None, "phase 13.0: the ranks did not form a card channel")

    def timed(fn, iters):
        torch.cuda.synchronize()
        dist.barrier()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        dist.barrier()
        return 1e3 * (time.perf_counter() - t) / iters

    rows = []
    for i, mb in enumerate(TRANSPORT_MB):
        n = max(1, int(mb * 2**20) // 4)
        xs = [torch.randn(n, device="cuda",
                          generator=torch.Generator("cuda").manual_seed(100 * i + j))
              for j in range(world)]
        x, want = xs[rank], xs[0].clone()
        for y in xs[1:]:
            want += y
        check(torch.equal(card.all_sum(x), want) and torch.equal(card.gather(x), torch.stack(xs)),
              f"phase 13.0: the card channel's sum or gather differs from the ranks' tensors "
              f"added in rank order or stacked at {mb} MB")
        del xs, want
        bucket = torch.zeros((world, n), device="cuda")
        y = x.clone()

        def gloo_gather():
            bucket.zero_()
            bucket[rank] = x
            dist.all_reduce(bucket)

        iters = 20 if mb < 64 else 5
        rows.append({"mb": mb, "card_sum_ms": timed(lambda: card.all_sum(x), iters),
                     "card_gather_ms": timed(lambda: card.gather(x), iters),
                     "gloo_sum_ms": timed(lambda: dist.all_reduce(y), max(2, iters // 4)),
                     "gloo_gather_ms": timed(gloo_gather, max(2, iters // 4))})
    return rows


def tp_rank(work, steps, transport=False):
    """One rank of phases 13.1-13.2 (run under torch.distributed.run): with
    `transport`, phase 13.0 first; the compared step in both modes on the
    grid (OTHERS.TENSOR_PARALLEL TP_SIZE), the digests of its state, rank 0
    the whole parameters; then `steps` timed steps with TF32 on; writes
    rank<r>.json into `work`."""
    import torch

    sys.path.insert(0, HERE)
    from onda_torch.ops import kernels as K
    from onda_torch.parallel import distributed as D
    from onda_torch.parallel import shared_card

    device = D.initialize("cuda")
    rank, world, batch = D.rank(), D.world(), 4
    out = {"rank": rank, "world": world, "backend": D.backend(), "device": str(device)}
    if transport and D.backend() == "gloo":
        out["transport"] = transport_rows(torch)
    for mode in DP_BOUNDS:  # "exact", then "kernels", whose adapter goes on to the timed steps
        ad, step, logs, local, _ = dp_compare_step(torch, device, batch, mode == "exact",
                                                   others={"TENSOR_PARALLEL": TP_SIZE})
        out[mode] = {"logs": logs, "digests": digests(torch, ad.state)}
        whole = whole_state(torch, ad)
        if rank == 0:
            torch.save(whole, os.path.join(work, f"rank0_{mode}.pt"))
        del whole
    out.update(position=[D.data_rank(), D.model_rank()], grid=[D.data_world(), D.model_world()],
               plan=sorted(ad.plan))
    trees = ("params", "opt_momentum", "ema_params", "static_params", "dynamic_params")
    out["state_bytes"] = sum(v.numel() * v.element_size() for t in trees
                             for v in getattr(ad.state, t).values())
    out["one_process_state_bytes"] = sum(4 * math.prod(ad.full_shapes[k]) for t in trees
                                         for k in getattr(ad.state, t))
    batches = [(local(s), local(t)) for s, t in zip(
        make_batches(torch, steps, batch, MAIN_HW, 20),
        make_batches(torch, steps, batch, MAIN_HW, 21))]
    feed = [(t["image"].to(device), s["image"][None].to(device), s["label_res"][None].to(device))
            for s, t in batches]
    torch.cuda.synchronize()
    K.reset_launches()
    D.reset_counts()
    waits = shared_card.STATS["host_waits"]
    torch.cuda.reset_peak_memory_stats(device)
    times, finite, fired = [], True, 0
    for img, s_img, s_lbl in feed:
        t = time.perf_counter()
        ad.state, step_logs = step(ad.state, img, s_img, s_lbl, 1e-5)
        finite &= math.isfinite(step_logs["Total target loss"])  # the step ends at its log read
        times.append(1e3 * (time.perf_counter() - t))
        fired += int(step_logs["dynamic forward fired"])
    out.update(step_ms=times, finite=finite, launches=dict(K.launches), dynamic_fired=fired,
               collectives={g: dict(c) for g, c in D.COUNTS.items()},
               card_waits=shared_card.STATS["host_waits"] - waits,
               peak_gib=torch.cuda.max_memory_allocated(device) / 2**30)
    img, s_img, s_lbl = feed[0]
    (ad.state, step_logs), syncs = count_syncs(
        torch, lambda: step(ad.state, img, s_img, s_lbl, 1e-5))
    out.update(debug_syncs=len(syncs))
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    D.destroy()


def one_process_references(torch):
    """Phase 12.1's and 13's one-process references: hybrid_switch.yml at b4
    after a bootstrap and one step, in both modes, and batch-invariant with
    the sharded layers split in blocks (phase 13's witness, "exact_split")
    (the parameters and prototypes on the host, the logs, the parameters
    before the step)."""
    release(torch)
    one = {}
    for mode in (*DP_BOUNDS, "exact_split"):
        ad, _, logs, _, start = dp_compare_step(torch, "cuda", 4, mode != "kernels",
                                                split=mode == "exact_split")
        one[mode] = {**compared_state(torch, ad), "logs": logs, "start": start}
        del ad
        release(torch)
    return one


def grid_gaps(torch, tag, one, got, logs):
    """The ranks' losses, prototypes and parameter updates against one
    process's (`check_gaps` holds them to their bounds); the prototype
    counts, pseudo-labels and the gate must be equal."""
    want, start = one, one["start"]
    gaps = {
        "loss": max(abs(logs[k] - want["logs"][k]) / max(abs(want["logs"][k]), 1e-12)
                    for k in DP_LOSS_KEYS),
        "proto": max((got["proto"][k] - want["proto"][k]).abs().max().item()
                     for k in ("mean", "sq_mean")),
        **{group: update_gap(got["params"], want["params"], start,
                             [k for k in start if k.startswith("layer6") == (group == "head")])
           for group in ("head", "backbone")}}
    check(torch.equal(got["proto"]["count"], want["proto"]["count"])
          and logs["pseudolabel_pixel_num"] == want["logs"]["pseudolabel_pixel_num"]
          and logs["dynamic forward fired"] == want["logs"]["dynamic forward fired"],
          f"{tag}: prototype counts, pseudo-labels or the gate differ from one process's")
    return gaps


def check_gaps(tag, gaps, bounds):
    """Each mode's gaps against its bounds (after every mode is printed)."""
    for mode, got in gaps.items():
        for key, gap in got.items():
            check(gap <= bounds[mode][key], f"{tag} {mode}: {key} gap {gap:.3e} > "
                                            f"{bounds[mode][key]}")


def tensor_parallel_ranks(torch, out_dir, work, root, rows):
    """Phase 13's one torchrun of a (1 x 2) grid's two ranks: 13.0-13.1's
    ranks (`tp_rank`), 13.4's (`tp_adv_rank`), then the CLI runs of 13.3
    and 13.5 chained (one domain each: hybrid_switch.yml and its
    AUTO_RESUME; advent.yml and its AUTO_RESUME, validation_offline_advent.yml
    on its snapshot, proto_advent.yml, training_fog.yml,
    validation_offline_fog.yml with EVAL_SWEEP on its snapshots). 13.2's
    four ranks run apart. Returns what the phase's checks read."""
    write_fog_metadata(root, rows)
    dirs = {k: os.path.join(work, k) for k in ("tp13.1", "tp13.4", "tp_chain", "sp14.1")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    snaps = {"hybrid": os.path.join(work, "tp_cli"), "advent": os.path.join(work, "tp_advent"),
             "proto_advent": os.path.join(work, "tp_proto_advent"),
             "segment": os.path.join(work, "tp_seg")}
    snaps.update(hybrid_resume=snaps["hybrid"], advent_resume=snaps["advent"],
                 validation_offline_advent=snaps["advent"], training_fog=snaps["segment"],
                 validation_offline_fog=snaps["segment"])
    grid = {"SCHEME.PATH": root, "MODEL.LOAD": None, "OTHERS.TENSOR_PARALLEL": TP_SIZE}
    advent = {**grid, "SCHEME.DOMAIN_ORDER": [[25]], "METHOD.ADAPTATION.ADVENT.EPOCHS": 1,
              "OTHERS.SNAPSHOT_DIR": snaps["advent"]}
    plan = {
        "advent": ("advent", advent),
        "advent_resume": ("advent", {**advent, "OTHERS.AUTO_RESUME": True}),
        "validation_offline_advent": ("validation_offline_advent", {
            **grid, "SCHEME.DOMAIN_ORDER": [[25]], "OTHERS.SNAPSHOT_DIR": snaps["advent"]}),
        "proto_advent": ("proto_advent", {
            **grid, "SCHEME.DOMAIN_ORDER": [[25]], "OTHERS.SNAPSHOT_DIR": snaps["proto_advent"],
            "METHOD.ADAPTATION.PROTO_ADVENT.LOAD_PROTO": None,
            "METHOD.ADAPTATION.PROTO_ADVENT.EPOCHS": 1}),
        "training_fog": ("training_fog", {
            **grid, "SCHEME.DOMAIN_ORDER": [[750]], "METHOD.PRETRAIN.SEGMENT.EPOCHS": 1,
            "METHOD.ADAPTATION.PROTO_ONLINE_HYBRIDSWITCH.LOAD_PROTO": None,
            "OTHERS.SNAPSHOT_DIR": snaps["segment"]}),
        "validation_offline_fog": ("validation_offline_fog", {
            **grid, "OTHERS.EVAL_SWEEP": True, "OTHERS.SNAPSHOT_DIR": snaps["segment"]}),
    }
    runs, cfgs = {}, {}
    for name, resume in (("hybrid", {}), ("hybrid_resume", {"OTHERS.AUTO_RESUME": True})):
        runs[name] = os.path.join(work, f"tp_{name}.yml")
        cfgs[name] = cli_config(root, snaps["hybrid"], runs[name], [[25]],
                                **{"OTHERS.TENSOR_PARALLEL": TP_SIZE, **resume})
    for name, (config, cuts) in plan.items():
        runs[name] = os.path.join(work, f"tp_{name}.yml")
        cfgs[name] = workflow_config(config, runs[name], **cuts)
    steps_13_1 = TP_GRIDS["13.1"][1]
    rc, text, seconds, job_seconds = run_rank_jobs(
        [["--tp-rank", dirs["tp13.1"], str(steps_13_1), "1"],
         ["--tp-adv-rank", dirs["tp13.4"], str(TP_ADV_TIMED_STEPS)],
         cli_chain(dirs["tp_chain"], runs), sp_job(dirs["sp14.1"], "14.1")],
        os.path.join(out_dir, "tp_ranks.log"), nproc=TP_SIZE)
    check(rc == 0, f"phase 13: a rank failed (exit {rc}):\n{text[-3000:]}")
    check(len(job_seconds) == 4, f"phase 13: rank 0 reports {job_seconds} job seconds")
    results = chain_results(dirs["tp_chain"], runs, nproc=TP_SIZE)
    print(f"phase 13 ranks: one torchrun of a (1 x {TP_SIZE}) grid's ranks, {seconds:.3f} s with "
          f"start-up: 13.0-13.1's ranks {job_seconds[0]:.3f} s, 13.4's {job_seconds[1]:.3f} s, "
          f"the {len(runs)} CLI runs of 13.3 and 13.5 {job_seconds[2]:.3f} s (" + ", ".join(
              f"{k} {v[0]['seconds']:.3f}" for k, v in results.items())
          + f"), phase 14.1's spatial ranks {job_seconds[3]:.3f} s")
    return {"text": text, "seconds": seconds, "job_seconds": job_seconds, "dirs": dirs,
            "runs": runs, "cfgs": cfgs, "snaps": snaps, "results": results,
            "records": chain_records(runs, results, snaps)}


def tensor_parallel_path(torch, K, out_dir, work, root, rows, one, launched):
    """Phase 13.0-13.3: 13.1 and 13.2 hybrid_switch.yml in memory at full
    width on a (1 x 2) and a (2 x 2) grid, one process at b4 against the
    grid (both modes; whole leaves bit for bit across the ranks, shards
    across the ranks of a model index), then timed; 13.3 the CLI on a
    (1 x 2) grid on phase 7's files and an AUTO_RESUME rerun, the file
    loaded by one process. 13.0-13.1 and 13.3 come from the phase's
    torchrun (`launched`: `tensor_parallel_ranks`). Returns launch counts
    by path and the numbers."""
    from onda_torch.parallel import tensor as T

    t_phase = time.perf_counter()
    summary, paths = {}, {}
    n_bn, n_sharded_bn, n_sharded_convs = 53, 46, 46  # R50; the convs' inputs that sum
    witness = grid_gaps(torch, "phase 13 witness", one["exact"],
                        {k: one["exact_split"][k] for k in ("params", "proto")},
                        one["exact_split"]["logs"])
    summary["witness"] = witness
    print(f"phase 13 witness: one process at b4 with its {TP_SHARDED_LAYERS} sharded layers in "
          f"{TP_SIZE} blocks (the grid's GEMMs and input-gradient sums, no collective), "
          f"batch-invariant, against one process after a bootstrap and one step: " + ", ".join(
              f"{k} {v:.3e}" for k, v in witness.items()))
    check(witness["backbone"] <= TP_BOUNDS["exact"]["backbone"],
          f"phase 13 witness: backbone {witness['backbone']:.3e} > the bound it sets, "
          f"{TP_BOUNDS['exact']['backbone']}")
    for sub, (world, steps) in TP_GRIDS.items():
        backend, layout = tp_layout(torch, world)
        if sub == "13.1":  # in the phase's torchrun
            tp_dir, seconds = launched["dirs"]["tp13.1"], launched["job_seconds"][0]
        else:
            tp_dir, sp_dir = os.path.join(work, f"tp{sub}"), os.path.join(work, "sp14.2")
            os.makedirs(tp_dir, exist_ok=True)
            os.makedirs(sp_dir, exist_ok=True)
            release(torch)
            # the same torchrun runs phase 14.2's (2 x 2) spatial grid after it
            rc, text, seconds, job_seconds = run_rank_jobs(
                [["--tp-rank", tp_dir, str(steps), "0"], sp_job(sp_dir, "14.2")],
                os.path.join(out_dir, f"tp{sub}_ranks.log"), nproc=world)
            check(rc == 0, f"phase {sub}: a rank failed (exit {rc}):\n{text[-3000:]}")
            check(len(job_seconds) == 2, f"phase {sub}: rank 0 reports {job_seconds} job seconds")
            launched["sp14.2"] = {"dir": sp_dir, "seconds": job_seconds[1]}
            seconds -= job_seconds[1]
        ranks = []
        for r in range(world):
            with open(os.path.join(tp_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        r0 = ranks[0]
        if "transport" in r0:  # 13.0: what a collective of card tensors costs ranks on one card
            summary["13.0"] = r0["transport"]
            print(f"phase 13.0 {world} ranks on card 0, a card tensor's sum and gather, ms a call "
                  f"(card channel / gloo): " + "; ".join(
                      f"{r['mb']} MB sum {r['card_sum_ms']:.3f} / {r['gloo_sum_ms']:.3f}, gather "
                      f"{r['card_gather_ms']:.3f} / {r['gloo_gather_ms']:.3f}"
                      for r in r0["transport"]))
        check(all(r["world"] == world and r["backend"] == backend
                  and r["position"] == [r["rank"] // TP_SIZE, r["rank"] % TP_SIZE]
                  and r["grid"] == [world // TP_SIZE, TP_SIZE] for r in ranks),
              f"phase {sub}: ranks report {[(r['world'], r['backend'], r['position']) for r in ranks]}")
        plan = set(r0["plan"])
        gaps = {}
        for mode in DP_BOUNDS:
            differ = sorted(k for r in ranks for k, v in r[mode]["digests"].items()
                            if v != (ranks[r["position"][1]] if k.split("/", 1)[-1] in plan
                                     else r0)[mode]["digests"][k])
            check(not differ, f"phase {sub} {mode}: whole leaves differ across the ranks, or "
                              f"shards across the ranks of a model index: {differ[:6]}")
            check(all(r[mode]["logs"] == r0[mode]["logs"] for r in ranks),
                  f"phase {sub} {mode}: the ranks' logs differ")
            got = torch.load(os.path.join(tp_dir, f"rank0_{mode}.pt"), weights_only=False)
            for ref in (mode, "exact_split") if mode == "exact" else (mode,):
                gaps[ref] = grid_gaps(torch, f"phase {sub} {ref}", one[ref], got,
                                      r0[mode]["logs"])
                against = ("the witness (one process at b4, its sharded layers in the grid's "
                           "blocks)" if ref == "exact_split" else "one process at b4")
                print(f"phase {sub} {ref}: hybrid_switch.yml in memory, b4 1024x512 ({layout}), "
                      f"{against} against the grid after a bootstrap and one step (TF32 off; "
                      f"the grid's shards gathered): " + ", ".join(
                          f"{k} {v:.3e} (bound {TP_BOUNDS[ref][k]:.0e})"
                          for k, v in gaps[ref].items())
                      + f"; the ranks' {len(r0[mode]['digests'])} state tensors: {len(plan)} "
                        f"planned names sharded, every whole one equal bit for bit on all ranks")
        check_gaps(f"phase {sub}", gaps, TP_BOUNDS)
        # the model group: a gather after each of the 46 sharded BatchNorms and
        # the head's 7 sharded norms and SE in each forward (EMA, static and
        # target teachers, the gated dynamic one, the source and target
        # slices), a sum of the input gradient of each of the 46 sharded
        # convs' inputs in each of the 2 backwards
        fired = r0["dynamic_fired"]
        want_coll = {"data": 0 if world == TP_SIZE else 5 * n_bn + 6,
                     "model": ((4 * steps + fired) * (n_sharded_bn + 7)
                               + 2 * steps * n_sharded_convs) / steps, "world": 1}
        for r in ranks:
            check(r["finite"], f"phase {sub} rank {r['rank']}: a non-finite loss")
            check(r["launches"] == {"pseudo_labels_kernel": 2 * steps,
                                    "bn_stats_kernel": 3 * n_bn * steps},
                  f"phase {sub} rank {r['rank']}: launches {r['launches']}, expected K1 2 and "
                  f"K2 {3 * n_bn} a step")
            per_step = {g: c["collectives"] / steps for g, c in r["collectives"].items()}
            check(per_step == want_coll, f"phase {sub} rank {r['rank']}: collectives a step "
                                         f"{per_step}, expected {want_coll}")
            check(r["state_bytes"] < 0.6 * r["one_process_state_bytes"],
                  f"phase {sub} rank {r['rank']}: state {r['state_bytes']} bytes against one "
                  f"process's {r['one_process_state_bytes']}")
        step_ms = [statistics.median(r["step_ms"][1:]) for r in ranks]
        mb = {g: c["bytes"] / steps / 1e6 for g, c in r0["collectives"].items()}
        summary[sub] = {"layout": layout, "backend": backend, "step_ms": step_ms,
                        "peak_gib": [r["peak_gib"] for r in ranks], "gaps": gaps,
                        "collectives_per_step": want_coll, "mb_per_step": mb,
                        "debug_syncs": r0["debug_syncs"], "card_waits": r0["card_waits"] / steps,
                        "state_bytes": r0["state_bytes"],
                        "one_process_state_bytes": r0["one_process_state_bytes"],
                        "seconds": seconds}
        print(f"phase {sub} timed ({steps} steps after the compared ones, TF32 on, {layout}): "
              f"median step ms per rank " + ", ".join(f"{v:.3f}" for v in step_ms)
              + " (steps 1..): " + "; ".join(", ".join(f"{v:.3f}" for v in r["step_ms"])
                                             for r in ranks)
              + f"; per rank and step K1 {r0['launches']['pseudo_labels_kernel'] // steps}, K2 "
              f"{r0['launches']['bn_stats_kernel'] // steps}; collectives a step by group "
              + ", ".join(f"{g} {want_coll[g]} of {mb[g]:.3f} MB" for g in want_coll)
              + f"; host syncs the CUDA sync debug mode counts in one step: {r0['debug_syncs']}, "
              f"and the card channel's stream waits {r0['card_waits'] / steps:.0f} a step; peak "
              f"memory per rank " + ", ".join(f"{r['peak_gib']:.3f} GiB" for r in ranks)
              + f"; params + momentum + teachers per rank {r0['state_bytes'] / 2**20:.3f} MiB "
              f"against one process's {r0['one_process_state_bytes'] / 2**20:.3f} MiB "
              f"({r0['state_bytes'] / r0['one_process_state_bytes']:.3f}); {seconds:.3f} s with "
              f"start-up")
        for r in ranks:
            paths[f"tensor_parallel_{sub}_rank{r['rank']}"] = r["launches"]

    # 13.3: the CLI on a (1 x 2) grid on phase 7's files, then AUTO_RESUME
    # (chained in the phase's torchrun)
    backend, layout = tp_layout(torch, TP_SIZE)
    snap, cfg = launched["snaps"]["hybrid"], launched["cfgs"]["hybrid"]
    batch, n_train = int(cfg["TRAINING"]["BATCH_SIZE"]), CLI_FRAMES["train"]
    steps = n_train // batch
    boot = min(int(cfg["TRAINING"]["REPLAY_BUFFER"]), n_train) // batch
    want = {"pseudo_labels_kernel": 2 * steps, "bn_stats_kernel": n_bn * (3 * steps + boot)}
    cli, resumed = launched["results"]["hybrid"], launched["results"]["hybrid_resume"]
    seconds = cli[0]["seconds"]
    for r in range(TP_SIZE):
        check(cli[r]["launches"] == want, f"phase 13.3 rank {r}: launches {cli[r]['launches']}, "
                                          f"expected {want}")
        paths[f"tensor_parallel_cli_rank{r}"] = cli[r]["launches"]
        paths[f"tensor_parallel_cli_resumed_rank{r}"] = resumed[r]["launches"]
    records = launched["records"]["hybrid"]
    step_records = [rec for rec in records if "Total target loss" in rec]
    check(len(step_records) == steps, f"phase 13.3: {len(step_records)} step records for {steps} "
                                      f"steps (one writer)")
    check(all(math.isfinite(v) for rec in step_records for k, v in rec.items() if "loss" in k),
          "phase 13.3: a non-finite loss")
    files = check_one_writer("phase 13.3", snap, ["adapt_state.pt", "metrics.jsonl",
                                                  "proto_current.pickle", "proto_(25,).pickle"])
    # one process loads the grid's file (the AUTO_RESUME rerun's): cut into
    # each rank's shards, its state is each rank's, bit for bit
    release(torch)
    ad = make_adapter(torch, "cuda", MAIN_HW, batch)
    ad.load_model(os.path.join(snap, "adapt_state.pt"))
    plan = T.tensor_parallel_plan(ad.full_shapes, TP_SIZE)
    for r in range(TP_SIZE):
        mine = {f"{t}/{k}": v for t in TP_TREES
                for k, v in T.shard_state(getattr(ad.state, t), plan, r, TP_SIZE).items()}
        differ = sorted(k for k, v in digests_of(torch, mine).items()
                        if resumed[r]["digests"][k] != v)
        check(not differ, f"phase 13.3: one process's load of the grid's file differs from rank "
                          f"{r}'s state at {differ[:6]}")
    del ad
    release(torch)
    summary["13.3"] = {"seconds": seconds, "files": files}
    print(f"phase 13.3 configs/hybrid_switch.yml (phase 7's cuts, DOMAIN_ORDER [[25]], "
          f"OTHERS.TENSOR_PARALLEL {TP_SIZE}) through torch.distributed.run ({layout}): "
          f"{seconds:.3f} s in the phase's torchrun; per rank launches "
          + "; ".join(str(c["launches"]) for c in cli)
          + f"; {len(step_records)} step records from rank 0, every loss finite; files {files} "
          f"(each once); one process's load_model of adapt_state.pt, cut into shards, equals "
          f"each rank's state bit for bit")
    seconds = resumed[0]["seconds"]
    restored = re.findall(r"AUTO_RESUME: restoring \S*adapt_state\.pt", launched["text"])
    check(len(restored) == TP_SIZE, f"phase 13.3 AUTO_RESUME: {len(restored)} ranks restored "
                                    f"adapt_state.pt, expected {TP_SIZE}")
    print(f"phase 13.3 AUTO_RESUME rerun on the grid: both ranks restored adapt_state.pt; "
          f"{seconds:.3f} s in the phase's torchrun")
    shutil.rmtree(snap, ignore_errors=True)
    summary["13.3"]["resume_seconds"] = seconds
    summary["phase_seconds"] = time.perf_counter() - t_phase
    print(f"phase 13.0-13.3: {summary['phase_seconds']:.3f} s")
    return paths, summary


# ---------------------------------------------------------------------------
# phases 13.4-13.5: ADVENT, PROTO_ADVENT, SEGMENT training and EVALUATION on
# a (1 x 2) grid
# ---------------------------------------------------------------------------

TP_ADV_TIMED_STEPS = 3  # 13.4, after the compared step
TP_ADV_LAUNCHES = {**ADV_LAUNCHES, "segment": {"pseudo_labels_kernel": 0, "bn_stats_kernel": 53}}
# one process at b4 against the (1 x 2) grid after one step, in DP_BOUNDS'
# modes: ADV_BOUNDS' (the discriminators through their gradients, Adam's
# first moment, as 12.3 compares them); batch-invariant against the plain
# one process the backbone as TP_BOUNDS' (the blocks' arithmetic, see the
# witness) and the discriminators' gradients, which the student's blocks
# reach through the entropy maps, at 4x ADVENT's reading on an H100
# (4.490e-04). Against each method's witness ("exact_split"), each method's
# own bounds, from its readings in two runs on an H100 (PERF.md): the
# losses; the student's gradient (its SGD momentum, `grad_gaps`) by group
# and the backbone's update beyond each weight's last places
# ("backbone_excess"), ≈4x their larger reading; ADVENT's and
# PROTO_ADVENT's discriminators' gradients, which equal the witness's (read
# 0). The updates themselves differ in their weights' last places, and
# which weights' varies from run to run (the card's atomic sums in the
# backward): one place of the head's largest weight is 2.529e-04 of
# SEGMENT's head update, so every head is held at DP_BOUNDS' "exact"; one
# or two places of PROTO_ADVENT's backbone read 4.242e-05 or 8.485e-05, and
# SEGMENT's 1.470e-04, each held at ≈4 places. ADVENT's backbone reads
# 3.597e-03 in every run, its excess 1.218e-07 and 2.196e-07, its gradient
# ≈4.4e-06: the weights' last places are a larger share of its update (LR
# 1e-5, SEGMENT's 2.5e-4); held at 1e-2. "advent_fool": ADVENT's fool-only
# step (source labels ignored, no weight decay), the gradient that reaches
# the student through the sharded discriminators alone (read ≤1.061e-07 in
# the head, ≤6.863e-06 in the backbone).
TP_ADV_BOUNDS = {"exact": {**ADV_BOUNDS["exact"], "backbone": TP_BOUNDS["exact"]["backbone"],
                           "disc": 2e-3},
                 "kernels": ADV_BOUNDS["kernels"]}
TP_ADV_SPLIT = {
    "advent": {"loss": 1e-6, "head": 4e-4, "backbone": 1e-2, "disc": 1e-6, "head_grad": 5e-7,
               "backbone_grad": 2e-5, "backbone_excess": 1e-6},
    "proto_advent": {"loss": 1e-6, "head": 4e-4, "backbone": 2e-4, "disc": 1e-6,
                     "head_grad": 5e-7, "backbone_grad": 2e-5, "backbone_excess": 1e-5},
    "segment": {"loss": 1e-6, "head": 4e-4, "backbone": 6e-4, "head_grad": 5e-7,
                "backbone_grad": 2e-5, "backbone_excess": 1e-5},
    "advent_fool": {"loss": 1e-6, "head_grad": 5e-7, "backbone_grad": 3e-5},
}
# per step a rank's collectives by group on the (1 x 2) grid at full R50
# width: the norms a forward gathers after (46 BatchNorms, the ProDA head's 5
# branch and bottleneck GroupNorms and its SE), the sharded convs' shared
# inputs a backward sums (43 in the backbone, 3 in the head), those of the
# multi-level aux head (7, 3), an ADVENT discriminator's 3 sharded convs
TP_NORMS, TP_INPUTS, TP_AUX_NORMS, TP_AUX_INPUTS, TP_DISC = 53, 46, 7, 3, 3
TP_ADV_COLLECTIVES = {
    # 2 student forwards with the aux head, 6 discriminator forwards (the
    # student's BCE through both, each discriminator's on the source and
    # target maps); the student's backward and the discriminators'
    "advent": {"data": 0, "world": 2,
               "model": 2 * (TP_NORMS + TP_AUX_NORMS) + 6 * TP_DISC
               + 2 * (TP_INPUTS + TP_AUX_INPUTS) + 2 * TP_DISC + 4 * TP_DISC},
    # the EMA, static and source/target forwards and the gated dynamic one
    # (the count a step is fired·TP_NORMS more); whole discriminators
    "proto_advent": {"data": 0, "world": 2, "model": 4 * TP_NORMS + 2 * TP_INPUTS},
    "segment": {"data": 0, "world": 1,
                "model": TP_NORMS + TP_AUX_NORMS + TP_INPUTS + TP_AUX_INPUTS},
}


def is_shard(key, plan, disc_plan) -> bool:
    """Whether a flat name ("tree/.../leaf") is a channel shard under the
    student's plan or the discriminators'."""
    leaf = key.rsplit("/", 1)[-1]
    return leaf in (disc_plan if key.startswith("d_") else plan)


def state_nbytes(torch, tensors, prefix=()) -> int:
    """The bytes of the float tensors of a flat dict (whose names start with
    `prefix`, if given)."""
    return sum(v.numel() * v.element_size() for k, v in tensors.items()
               if isinstance(v, torch.Tensor) and v.is_floating_point()
               and (not prefix or k.startswith(prefix)))


def tp_adv_rank(work, steps):
    """One rank of phase 13.4 (under torch.distributed.run, a (1 x TP_SIZE)
    grid): for ADVENT, PROTO_ADVENT and a SEGMENT step, the compared step in
    both of DP_BOUNDS' modes, the digests of this rank's state and rank 0's
    whole compared tensors; then `steps` timed steps with TF32 on, their
    launches, collectives by group, host syncs, peak, the K1/K2 shapes they
    fed and the bytes of state this rank holds against the whole state's;
    last ADVENT's fool-only step (batch-invariant); writes
    tp_adv_rank<r>.json into `work`."""
    import torch

    sys.path.insert(0, HERE)
    from onda_torch.ops import kernels as K
    from onda_torch.parallel import distributed as D
    from onda_torch.parallel import shared_card

    device = D.initialize("cuda")
    rank, batch, grid = D.rank(), 4, {"TENSOR_PARALLEL": TP_SIZE}
    out = {"rank": rank, "world": D.world(), "backend": D.backend()}
    shapes = KernelShapes(K)
    for config in TP_ADV_LAUNCHES:
        res = out[config] = {}
        for mode in DP_BOUNDS:  # "kernels" last: its adapter goes on to the timed steps
            with shapes:
                if config == "segment":
                    obj, one, logs, local, _ = seg_compare_step(torch, device, batch,
                                                                mode == "exact", grid)
                else:
                    obj, one, logs, local, _ = adv_compare_step(torch, device, config, batch,
                                                                mode == "exact", grid)
            res[mode] = {"logs": logs, "digests": digests_of(torch, family_tensors(torch, obj))}
            compared = adv_compared(torch, obj)
            if rank == 0:
                torch.save(compared, os.path.join(work, f"tp_adv0_{config}_{mode}.pt"))
            del compared
            if mode == "exact":
                del obj, one
                release(torch)
        mine, whole = family_tensors(torch, obj), family_tensors(torch, obj, whole=True)
        res.update(position=[D.data_rank(), D.model_rank()],
                   grid=[D.data_world(), D.model_world()], plan=sorted(obj.plan),
                   disc_plan=sorted(getattr(obj, "disc_plan", ())),
                   state_bytes=state_nbytes(torch, mine),
                   one_process_state_bytes=state_nbytes(torch, whole),
                   disc_bytes=state_nbytes(torch, mine, ("d_",)),
                   one_process_disc_bytes=state_nbytes(torch, whole, ("d_",)))
        del mine, whole
        if config == "segment":
            feed = [({k: v.to(device) for k, v in local(bt).items()},)
                    for bt in make_batches(torch, steps, batch, MAIN_HW, 38)]
        else:
            feed = [({k: v.to(device) for k, v in local(s).items()},
                     {k: v.to(device) for k, v in local(t).items()}) for s, t in zip(
                make_batches(torch, steps, batch, MAIN_HW, 34),
                make_batches(torch, steps, batch, MAIN_HW, 35))]
        loss_key = "Segmentation loss" if config == "segment" else "Adversarial loss"
        torch.cuda.synchronize()
        K.reset_launches()
        D.reset_counts()
        waits = shared_card.STATS["host_waits"]
        torch.cuda.reset_peak_memory_stats(device)
        times, finite = [], True
        with shapes:
            for args in feed:
                t = time.perf_counter()
                finite &= math.isfinite(float(one(*args)[loss_key]))  # the step ends at its read
                times.append(1e3 * (time.perf_counter() - t))
        res.update(step_ms=times, finite=finite, launches=dict(K.launches),
                   collectives={g: dict(c) for g, c in D.COUNTS.items()},
                   card_waits=shared_card.STATS["host_waits"] - waits,
                   peak_gib=torch.cuda.max_memory_allocated(device) / 2**30)
        _, syncs = count_syncs(torch, lambda: one(*feed[0]))
        res["debug_syncs"] = len(syncs)
        del obj, one, feed
        release(torch)
    with shapes:  # ADVENT's fool-only step, against its witness
        obj, _, logs, _, _ = adv_compare_step(torch, device, "advent", batch, True, grid,
                                              fool_only=True)
    compared = adv_compared(torch, obj)
    if rank == 0:
        torch.save(compared, os.path.join(work, "tp_adv0_advent_fool_exact.pt"))
    out["advent_fool"] = {"logs": logs}
    del obj, compared
    release(torch)
    out.update(k1_shapes=sorted(shapes.k1), k2_shapes=sorted(shapes.k2))
    with open(os.path.join(work, f"tp_adv_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    D.destroy()


def tensor_parallel_families_path(torch, K, out_dir, work, root, rows, refs, checked,
                                  launched):
    """Phases 13.4-13.5 on a (1 x 2) grid: 13.4 ADVENT, PROTO_ADVENT and a
    SEGMENT step in memory at full width, one process at b4 against the grid
    (both modes, and batch-invariant against the witness; whole leaves bit
    for bit on both ranks), then timed, in one torchrun; 13.5 the CLI on
    phase 7's files, in one torchrun and one domain each: advent.yml, its
    AUTO_RESUME rerun, validation_offline_advent.yml on its snapshot,
    training_fog.yml (SEGMENT, one epoch) and validation_offline_fog.yml
    with EVAL_SWEEP on its snapshots; every file one process's layout, its
    one-process load cut into shards equal to the ranks' bit for bit. Both
    run in the phase's torchrun (`launched`: `tensor_parallel_ranks`).
    `refs`: `family_references`; `checked`: phases 3-4's K1/K2 shapes.
    Returns launch counts by path and the numbers."""
    from onda_torch.parallel import tensor as T

    backend, layout = tp_layout(torch, TP_SIZE)
    paths, summary = {}, {}
    t = time.perf_counter()
    tp_dir, seconds = launched["dirs"]["tp13.4"], launched["job_seconds"][1]
    steps = TP_ADV_TIMED_STEPS
    ranks = []
    for r in range(TP_SIZE):
        with open(os.path.join(tp_dir, f"tp_adv_rank{r}.json")) as f:
            ranks.append(json.load(f))
    check(all(r["world"] == TP_SIZE and r["backend"] == backend for r in ranks),
          f"phase 13.4: ranks report {[(r['world'], r['backend']) for r in ranks]}")
    k1_fed = {tuple(s) for r in ranks for s in r["k1_shapes"]}
    k2_fed = {(tuple(s), d) for r in ranks for s, d in r["k2_shapes"]}
    check(k1_fed <= {tuple(c) for c in checked["k1"]} and {s for s, _ in k2_fed}
          <= {tuple(c) for c in checked["k2"]},
          f"phase 13.4 fed unchecked shapes: K1 {k1_fed}, K2 "
          f"{sorted(s for s, _ in k2_fed if list(s) not in checked['k2'])}")
    all_gaps = {}
    for config, per_step in TP_ADV_LAUNCHES.items():
        r0 = ranks[0][config]
        want, plain = refs[(config, "exact_split")], refs[(config, "exact")]
        witness = {"loss": max(abs(want["logs"][k] - plain["logs"][k])
                               / max(abs(plain["logs"][k]), 1e-12)
                               for k in plain["logs"] if "loss" in k),
                   **adv_gaps(torch, want["w"], plain["w"], plain["start"])}
        summary[f"{config}_witness"] = witness
        print(f"phase 13.4 {config} witness: one process at b4 with the grid's sharded layers in "
              f"{TP_SIZE} blocks, batch-invariant, against one process after one step: "
              + ", ".join(f"{k} {v:.3e}" for k, v in witness.items()))
        check(all(r[config]["position"] == [0, r["rank"]] and r[config]["grid"] == [1, TP_SIZE]
                  and r[config]["plan"] == r0["plan"] for r in ranks) and r0["plan"]
              and bool(r0["disc_plan"]) == (config == "advent"),
              f"phase 13.4 {config}: positions, grids or plans "
              f"{[(r[config]['position'], r[config]['grid']) for r in ranks]}")
        plan, disc_plan = set(r0["plan"]), set(r0["disc_plan"])
        gaps, bounds = {}, {**TP_ADV_BOUNDS, "exact_split": TP_ADV_SPLIT[config]}
        for mode in DP_BOUNDS:
            whole = [k for k in r0[mode]["digests"] if not is_shard(k, plan, disc_plan)]
            differ = sorted(k for k in whole for r in ranks[1:]
                            if r[config][mode]["digests"][k] != r0[mode]["digests"][k])
            check(whole and not differ, f"phase 13.4 {config} {mode}: whole leaves differ "
                                        f"across the ranks: {differ[:6]}")
            check(all(r[config][mode]["logs"] == r0[mode]["logs"] for r in ranks),
                  f"phase 13.4 {config} {mode}: the ranks' logs differ")
            got = torch.load(os.path.join(tp_dir, f"tp_adv0_{config}_{mode}.pt"),
                             weights_only=False)
            for ref in (mode, "exact_split") if mode == "exact" else (mode,):
                want = refs[(config, ref)]
                logs = r0[mode]["logs"]
                gaps[ref] = {"loss": max(abs(logs[k] - want["logs"][k])
                                         / max(abs(want["logs"][k]), 1e-12)
                                         for k in want["logs"] if "loss" in k),
                             **adv_gaps(torch, got, want["w"], want["start"])}
                if ref == "exact_split":
                    gaps[ref].update(grad_gaps(torch, got, want["w"], want["start"]))
                counts = {k: int(v) for k, v in got.items() if k.endswith("_opt/count")}
                check(counts == {k: int(v) for k, v in want["w"].items()
                                 if k.endswith("_opt/count")},
                      f"phase 13.4 {config} {ref}: Adam counts {counts}")
                against = ("the witness (one process at b4, its sharded layers in the grid's "
                           "blocks)" if ref == "exact_split" else "one process at b4")
                print(f"phase 13.4 {config} {ref}: in memory, b4 1024x512 ({layout}), {against} "
                      f"against the grid after one step (TF32 off; the grid's shards "
                      f"gathered): " + ", ".join(f"{k} {v:.3e} (bound {bounds[ref][k]:.0e})"
                                                 for k, v in gaps[ref].items())
                      + f"; the ranks' {len(r0[mode]['digests'])} state tensors: "
                        f"{len(r0[mode]['digests']) - len(whole)} shards, every whole one equal "
                        f"bit for bit on both ranks")
        all_gaps[config] = gaps
        want_coll = dict(TP_ADV_COLLECTIVES[config])
        for r in ranks:
            res = r[config]
            per = {g: c["collectives"] for g, c in res["collectives"].items()}
            fired = 0
            if config == "proto_advent":  # the gated dynamic teacher's forwards
                fired, extra = divmod(per["model"] - steps * want_coll["model"], TP_NORMS)
                check(extra == 0 and 0 <= fired <= steps,
                      f"phase 13.4 proto_advent rank {r['rank']}: {per['model']} model-group "
                      f"collectives over {steps} steps")
            check(per == {g: n * steps + (fired * TP_NORMS if g == "model" else 0)
                          for g, n in want_coll.items()},
                  f"phase 13.4 {config} rank {r['rank']}: collectives {per} over {steps} steps, "
                  f"expected {want_coll} a step")
            check(res["finite"], f"phase 13.4 {config} rank {r['rank']}: a non-finite loss")
            check(res["launches"] == {k: v * steps for k, v in per_step.items()},
                  f"phase 13.4 {config} rank {r['rank']}: launches {res['launches']}, expected "
                  f"{per_step} a step")
            if config == "proto_advent":
                check(res["disc_bytes"] == res["one_process_disc_bytes"] > 0,
                      f"phase 13.4 proto_advent rank {r['rank']}: discriminators "
                      f"{res['disc_bytes']} bytes, whole {res['one_process_disc_bytes']}")
            else:
                check(res["state_bytes"] < 0.6 * res["one_process_state_bytes"],
                      f"phase 13.4 {config} rank {r['rank']}: state {res['state_bytes']} bytes "
                      f"against one process's {res['one_process_state_bytes']}")
            paths[f"tensor_parallel_{config}_in_memory_rank{r['rank']}"] = res["launches"]
        step_ms = [statistics.median(r[config]["step_ms"][1:]) for r in ranks]
        mb = {g: c["bytes"] / steps / 1e6 for g, c in r0["collectives"].items()}
        per_step_coll = {g: c["collectives"] / steps for g, c in r0["collectives"].items()}
        summary[config] = {"step_ms": step_ms, "gaps": gaps, "mb_per_step": mb,
                           "collectives_per_step": per_step_coll,
                           "peak_gib": [r[config]["peak_gib"] for r in ranks],
                           "debug_syncs": r0["debug_syncs"], "card_waits": r0["card_waits"] / steps,
                           "state_bytes": r0["state_bytes"],
                           "one_process_state_bytes": r0["one_process_state_bytes"],
                           "disc_bytes": r0["disc_bytes"],
                           "one_process_disc_bytes": r0["one_process_disc_bytes"]}
        print(f"phase 13.4 {config} timed ({steps} steps after the compared ones, TF32 on, "
              f"{layout}): median step ms per rank (steps 1..) " + ", ".join(
                  f"{v:.3f}" for v in step_ms) + " (" + "; ".join(
                  ", ".join(f"{v:.3f}" for v in r[config]["step_ms"]) for r in ranks)
              + f"); per rank and step {per_step}; collectives a step by group " + ", ".join(
                  f"{g} {per_step_coll[g]:g} of {mb[g]:.3f} MB" for g in per_step_coll)
              + f"; host syncs the CUDA sync debug mode counts in one step: {r0['debug_syncs']},"
              f" card channel stream waits {r0['card_waits'] / steps:.0f} a step; peak memory "
              f"per rank " + ", ".join(f"{r[config]['peak_gib']:.3f} GiB" for r in ranks)
              + f"; state a rank holds {r0['state_bytes'] / 2**20:.3f} MiB against one "
              f"process's {r0['one_process_state_bytes'] / 2**20:.3f} MiB "
              f"({r0['state_bytes'] / r0['one_process_state_bytes']:.3f}); discriminators "
              f"{r0['disc_bytes'] / 2**20:.3f} of {r0['one_process_disc_bytes'] / 2**20:.3f} MiB")
    # ADVENT's fool-only step: the student's gradient through the sharded
    # discriminators alone, against the witness's
    got = torch.load(os.path.join(tp_dir, "tp_adv0_advent_fool_exact.pt"), weights_only=False)
    want, logs = refs[("advent_fool", "exact_split")], ranks[0]["advent_fool"]["logs"]
    check(all(r["advent_fool"]["logs"] == logs for r in ranks)
          and logs["Segmentation loss"] == want["logs"]["Segmentation loss"] == 0.0
          and logs["Adversarial loss"] > 0,
          f"phase 13.4 advent_fool: logs {[r['advent_fool']['logs'] for r in ranks]}, witness "
          f"{want['logs']}")
    fool = {"loss": max(abs(logs[k] - want["logs"][k]) / max(abs(want["logs"][k]), 1e-12)
                        for k in want["logs"] if "loss" in k and want["logs"][k]),
            **{k: v for k, v in grad_gaps(torch, got, want["w"], want["start"]).items()
               if k.endswith("_grad")}}
    all_gaps["advent_fool"] = {"exact_split": fool}
    summary["advent_fool"] = fool
    print(f"phase 13.4 advent_fool exact_split: ADVENT's step with its source labels ignored "
          f"and no weight decay (the student's momentum is the fool losses' gradient through "
          f"the sharded discriminators alone), the witness against the grid: " + ", ".join(
              f"{k} {v:.3e} (bound {TP_ADV_SPLIT['advent_fool'][k]:.0e})" for k, v in fool.items()))
    del got, want
    summary["seconds_13_4"] = time.perf_counter() - t
    print(f"phase 13.4: {summary['seconds_13_4']:.3f} s of checks ({seconds:.3f} s of ranks)")

    # 13.5: the CLI on phase 7's files, the five runs chained in the phase's
    # torchrun
    t = time.perf_counter()
    names = ("advent", "advent_resume", "validation_offline_advent", "proto_advent",
             "training_fog", "validation_offline_fog")
    cli = {name: launched["results"][name] for name in names}
    cfgs, text = launched["cfgs"], launched["text"]
    snaps = {k: launched["snaps"][k] for k in ("advent", "proto_advent", "segment")}
    seconds = sum(cli[name][0]["seconds"] for name in names)
    n_train = CLI_FRAMES["train"]
    batch = int(cfgs["advent"]["TRAINING"]["BATCH_SIZE"])
    adv_steps = n_train // batch
    seg_batch = int(cfgs["training_fog"]["TRAINING"]["BATCH_SIZE"])
    seg_steps = n_train // seg_batch
    seg_boot = min(int(cfgs["training_fog"]["TRAINING"]["REPLAY_BUFFER"]), n_train) // seg_batch
    pa_batch = int(cfgs["proto_advent"]["TRAINING"]["BATCH_SIZE"])
    pa_steps = n_train // pa_batch
    pa_boot = min(int(cfgs["proto_advent"]["TRAINING"]["REPLAY_BUFFER"]), n_train) // pa_batch
    want_launches = {
        "advent": {"pseudo_labels_kernel": 0, "bn_stats_kernel": 106 * adv_steps},
        "advent_resume": {"pseudo_labels_kernel": 0, "bn_stats_kernel": 106 * adv_steps},
        "proto_advent": {"pseudo_labels_kernel": 2 * pa_steps,
                         "bn_stats_kernel": 159 * pa_steps + 53 * pa_boot},
        "training_fog": {"pseudo_labels_kernel": 0, "bn_stats_kernel": 53 * (seg_steps + seg_boot)},
    }
    for name, ranks_out in cli.items():
        for r in ranks_out:
            if name in want_launches:
                check(r["launches"] == want_launches[name],
                      f"phase 13.5 {name} rank {r['rank']}: launches {r['launches']}, expected "
                      f"{want_launches[name]}")
            else:  # EVALUATION: eval-mode BatchNorm; K1 per batch of prototype evaluation
                check(r["launches"].get("bn_stats_kernel", 0) == 0,
                      f"phase 13.5 {name} rank {r['rank']}: launches {r['launches']}")
            paths[f"tensor_parallel_cli_{name}_rank{r['rank']}"] = r["launches"]
    k1_fed = {tuple(s) for rs in cli.values() for r in rs for s in r["k1_shapes"]}
    k2_fed = {tuple(s) for rs in cli.values() for r in rs for s, _ in r["k2_shapes"]}
    check(k1_fed <= {tuple(c) for c in checked["k1"]}
          and k2_fed <= {tuple(c) for c in checked["k2"]},
          f"phase 13.5 fed unchecked shapes: K1 {sorted(k1_fed)}, K2 "
          f"{sorted(s for s in k2_fed if list(s) not in checked['k2'])}")
    records = read_records(snaps["advent"])
    adv_records = [rec for rec in records if "Adversarial loss" in rec]
    check(len(adv_records) == 2 * adv_steps and all(
        math.isfinite(v) for rec in adv_records for k, v in rec.items() if "loss" in k),
          f"phase 13.5 advent: {len(adv_records)} step records for 2 x {adv_steps} steps (one "
          f"writer), or a non-finite loss")
    restored = re.findall(r"AUTO_RESUME: restoring (\S+?advent_state\.pt)", text)
    check(len(restored) == TP_SIZE, f"phase 13.5 advent AUTO_RESUME: {restored}, expected both "
                                    f"ranks to restore advent_state.pt")
    loaded = re.findall(r"Model (\S+) is being loaded", text)
    check(len(loaded) == 2 * TP_SIZE and all(p.endswith("advent_state.pt") for p in loaded[:2]),
          f"phase 13.5: EVALUATION loads {loaded}")
    swept = re.findall(r"sweep: (\S+) mIoU", text)
    seg_files = check_one_writer("phase 13.5 training_fog", snaps["segment"], [
        "model_train_[[0]].pth", "model_train_[[0]]_after_src_training.pth", "adapt_state.pt",
        "metrics.jsonl"])
    adv_files = check_one_writer("phase 13.5 advent", snaps["advent"],
                                 ["advent_state.pt", "metrics.jsonl"])
    pa_records = [rec for rec in launched["records"]["proto_advent"] if "Adversarial loss" in rec]
    check(len(pa_records) == pa_steps and all(
        math.isfinite(v) for rec in pa_records for k, v in rec.items() if "loss" in k),
          f"phase 13.5 proto_advent: {len(pa_records)} step records for {pa_steps} steps (one "
          f"writer), or a non-finite loss")
    pa_files = check_one_writer("phase 13.5 proto_advent", snaps["proto_advent"],
                                ["adapt_state.pt", "metrics.jsonl", "proto_current.pickle",
                                 "proto_(25,).pickle"])
    check(len(swept) == TP_SIZE * 3 and swept[-1] == swept[-TP_SIZE],
          f"phase 13.5 validation_offline_fog EVAL_SWEEP: swept {swept}")
    # one process loads each file; cut into each rank's shards, its state is
    # the rank's bit for bit
    release(torch)
    adv_path = os.path.join(snaps["advent"], "advent_state.pt")
    state = torch.load(adv_path, map_location="cpu", weights_only=False)
    check(state["step"] == 2 * adv_steps
          and state["d_main_opt"]["count"] == state["d_aux_opt"]["count"] == 2 * adv_steps,
          f"phase 13.5 advent: advent_state.pt step {state['step']}, Adam counts "
          f"{state['d_main_opt']['count']}/{state['d_aux_opt']['count']}")
    del state
    last_swept = os.path.join(snaps["segment"], swept[-1])
    loads = {"advent_resume": ("advent", adv_path),
             "validation_offline_advent": ("hybrid_switch", adv_path),
             "proto_advent": ("proto_advent", os.path.join(snaps["proto_advent"],
                                                           "adapt_state.pt")),
             "training_fog": ("hybrid_switch", os.path.join(snaps["segment"],
                                                            "model_train_[[0]].pth")),
             "validation_offline_fog": ("hybrid_switch", last_swept)}
    for name, (config, path) in loads.items():
        ad = make_adapter(torch, "cuda", MAIN_HW, 4, config=config,
                          multi_level=True if config == "hybrid_switch" else None)
        ad.load_model(path)
        plan = T.tensor_parallel_plan(ad.full_shapes, TP_SIZE)
        whole = family_tensors(torch, ad) if config == "advent" else {
            f"{t}/{k}": v for t in TP_TREES for k, v in getattr(ad.state, t).items()}
        disc_plan = T.tensor_parallel_plan(ad.state.d_main, TP_SIZE) if config == "advent" else {}
        for r, rank_out in enumerate(cli[name]):
            keys = [k for k in rank_out["digests"] if config in ("advent", "proto_advent")
                    or k.startswith(("params/", "batch_stats/"))]
            mine = {}
            for k in keys:
                v = whole[k]
                if is_shard(k, plan, disc_plan):
                    c = v.shape[0] // TP_SIZE
                    v = v.narrow(0, r * c, c)
                mine[k] = v
            differ = sorted(k for k, v in digests_of(torch, mine).items()
                            if rank_out["digests"][k] != v)
            check(keys and not differ, f"phase 13.5 {name}: one process's load of "
                                       f"{os.path.basename(path)} differs from rank {r}'s state "
                                       f"at {differ[:6]}")
        del ad, whole
        release(torch)
    summary["13.5"] = {"seconds": seconds, "advent_files": adv_files, "segment_files": seg_files,
                       "proto_advent_files": pa_files, "swept": list(dict.fromkeys(swept))}
    print(f"phase 13.5 the CLI on a (1 x {TP_SIZE}) grid ({layout}), {len(names)} runs chained "
          f"in the phase's torchrun (one process group: the runs after the first reuse it), "
          f"one domain each: advent.yml ({adv_steps} steps), its AUTO_RESUME rerun (both ranks "
          f"restored advent_state.pt; step {2 * adv_steps}), validation_offline_advent.yml "
          f"(loaded {loaded[:2]}), proto_advent.yml ({pa_steps} steps, {pa_boot} bootstrap "
          f"batches, its discriminators whole), training_fog.yml (SEGMENT 1 epoch of {seg_steps} steps, "
          f"{seg_boot} bootstrap batches), validation_offline_fog.yml EVAL_SWEEP (swept "
          f"{list(dict.fromkeys(swept))}); {seconds:.3f} s of runs; per rank launches " + "; ".join(
              f"{name} {[r['launches'] for r in rs]}" for name, rs in cli.items())
          + f"; files {adv_files}, {pa_files} and {seg_files} (each once); every file loaded by "
            f"one process "
            f"and cut into shards equals each rank's state bit for bit; K1/K2 shapes fed among "
            f"phases 3-4's")
    for d in snaps.values():
        shutil.rmtree(d, ignore_errors=True)
    summary["seconds_13_5"] = time.perf_counter() - t
    print(f"phase 13.5: {summary['seconds_13_5']:.3f} s")
    for config, gaps in all_gaps.items():  # held after every line of 13.4-13.5 is printed
        check_gaps(f"phase 13.4 {config}", gaps, {**TP_ADV_BOUNDS,
                                                  "exact_split": TP_ADV_SPLIT[config]})
    return paths, summary



# ---------------------------------------------------------------------------
# phase 14: the spatial mesh axis on a (data x spatial) grid
# ---------------------------------------------------------------------------

SP_BATCH = 2  # the global batch: JAX's data x spatial step runs b2
# sub-phase: ((data, spatial), timed steps, compared modes); 14.1's ranks are
# a job of phase 13's (1 x 2) torchrun, 14.2's of 13.2's four ranks
SP_GRIDS = {"14.1": ((1, 2), 3, ("exact", "kernels")), "14.2": ((2, 2), 1, ("exact",))}
# one process at b2 against the grid after a bootstrap and one step, TF32
# off: "exact" batch-invariant (cuDNN off, every BatchNorm variance from f64
# moments) at DP_BOUNDS' exact bounds, with Σ|params| within JAX's own 1e-4
# (`__graft_entry__.py`'s data x spatial check); "kernels" as the step runs
# (cuDNN on the rows' blocks, K2 on them) at DP_BOUNDS' kernels bounds
# Batch-invariance does not make the grid's arithmetic one process's: a rank
# convolves its block of rows (GEMMs of other shapes), so "exact_split"
# holds the grid batch-invariant against a witness that convolves in the
# same row blocks in one process (`split_spatial_rows`) at DP_BOUNDS'
# "exact" bounds, and "exact" against the plain one process, whose backbone
# bound is 3x the gap the grid read there (9.973e-03 on an NVIDIA H100:
# BatchNorms of near-constant channels amplify the blocks' last bits, as on
# phase 13's grid)
SP_BOUNDS = {"exact": {**DP_BOUNDS["exact"], "backbone": 3e-2},
             "exact_split": DP_BOUNDS["exact"], "kernels": DP_BOUNDS["kernels"]}
SP_ABS_PARAMS_RTOL = 1e-4
SP_CONVS = 67  # the Conv2d of R50 3-4-6-3 and its two ProDA heads (the aux head never runs)
# per forward of R50 3-4-6-3 with the ProDA head at 1024x512 on 2 spatial
# ranks: 23 windowed ops exchange rows (the stem's conv and pool, the 16
# dilated conv2s, the 4 ASPP branches, the bottleneck's 3x3; layer 2's
# stride-2 1x1s read their own rows at this size) and 7 sums run over the
# spatial group (6 GroupNorms, the SE mean); a backward returns the rows of
# all but the stem's conv (the image takes no gradient) and sums again
SP_HALO, SP_SUMS, SP_BN = 23, 7, 53


def sp_job(work, sub):
    """The `--sp-rank` job of sub-phase `sub`."""
    (d, s), steps, modes = SP_GRIDS[sub]
    os.makedirs(work, exist_ok=True)
    return ["--sp-rank", work, f"{d}x{s}", str(steps), ",".join(modes)]


def sp_rank(work, shape, steps, modes):
    """One rank of phase 14 (a job under torch.distributed.run): the ranks
    form a (data x spatial) grid of `shape` (`mesh.spatial_grid`), run the
    compared step in `modes` on their rows (`dp_compare_step`), the digests
    of their state, rank 0 the parameters and prototypes; then `steps` timed
    steps with TF32 on (launches, the K1/K2 shapes fed, collectives and
    bytes by group, the card channel's waits, peak), and the host syncs of
    one more; writes rank<r>.json into `work`."""
    import torch

    sys.path.insert(0, HERE)
    from onda_torch.ops import kernels as K
    from onda_torch.parallel import distributed as D
    from onda_torch.parallel import mesh
    from onda_torch.parallel import shared_card

    device = D.initialize("cuda")
    mesh.spatial_grid(shape, SP_BATCH)
    rank = D.rank()
    out = {"rank": rank, "world": D.world(), "backend": D.backend(),
           "position": [D.data_rank(), D.spatial_rank()],
           "grid": [D.data_world(), D.spatial_world()]}
    for mode in modes:  # the last mode's adapter goes on to the timed steps
        D.reset_counts()
        ad, step, logs, local, _ = dp_compare_step(torch, device, SP_BATCH, mode == "exact")
        out[mode] = {"logs": logs, "digests": digests(torch, ad.state),
                     "abs_params": sum(v.double().abs().sum().item()
                                       for v in ad.state.params.values())}
        if rank == 0:
            torch.save(compared_state(torch, ad), os.path.join(work, f"rank0_{mode}.pt"))
    batches = [(local(s), local(t)) for s, t in zip(
        make_batches(torch, steps, SP_BATCH, MAIN_HW, 20),
        make_batches(torch, steps, SP_BATCH, MAIN_HW, 21))]
    feed = [(t["image"].to(device), s["image"][None].to(device), s["label_res"][None].to(device))
            for s, t in batches]
    torch.cuda.synchronize()
    K.reset_launches()
    D.reset_counts()
    waits = shared_card.STATS["host_waits"]
    torch.cuda.reset_peak_memory_stats(device)
    times, finite, fired = [], True, 0
    with KernelShapes(K, moments=True) as shapes:
        for img, s_img, s_lbl in feed:
            t = time.perf_counter()
            ad.state, step_logs = step(ad.state, img, s_img, s_lbl, 1e-5)
            finite &= math.isfinite(step_logs["Total target loss"])  # the step ends at its log read
            times.append(1e3 * (time.perf_counter() - t))
            fired += int(step_logs["dynamic forward fired"])
    out.update(step_ms=times, finite=finite, launches=dict(K.launches), dynamic_fired=fired,
               collectives={g: dict(c) for g, c in D.COUNTS.items()},
               card_waits=shared_card.STATS["host_waits"] - waits,
               peak_gib=torch.cuda.max_memory_allocated(device) / 2**30,
               k1_shapes=sorted(shapes.k1), k2_shapes=sorted(shapes.k2), rows=list(img.shape))
    img, s_img, s_lbl = feed[0]
    (ad.state, step_logs), syncs = count_syncs(
        torch, lambda: step(ad.state, img, s_img, s_lbl, 1e-5))
    out.update(debug_syncs=len(syncs))
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    D.destroy()


def split_spatial_rows(torch, ad, size=2):
    """Phase 14's witness: every Conv2d of the adapter's model computes its
    output in the row blocks of a spatial axis of `size`, each block from
    the input rows it reads with H padding at the global edges only
    (`spatial.window_plan`), as the grid's ranks do, in one process with no
    collective. Returns how many convolutions."""
    import types

    import torch.nn.functional as F

    from onda_torch.parallel import spatial as S

    def conv(m, x):
        plan = S.window_plan(x.shape[2], size, m.kernel_size[0], m.stride[0], m.padding[0],
                             m.dilation[0])
        blocks = []
        for r in range(size):
            want = plan.rows.want[r]
            win = x[:, :, want[0]:want[-1] + 1]
            top, bottom = plan.edges[r]
            if top or bottom:
                win = F.pad(win, (0, 0, top, bottom))
            blocks.append(F.conv2d(win, m.weight, m.bias, m.stride, (0, m.padding[1]),
                                   m.dilation))
        return torch.cat(blocks, dim=2)

    n = 0
    for m in ad.model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.forward = types.MethodType(conv, m)
            n += 1
    return n


def spatial_references(torch):
    """Phase 14's one-process references: hybrid_switch.yml at b2 after a
    bootstrap and one step, in both modes, and batch-invariant with every
    convolution in the row blocks of a spatial axis of 2 (the witness,
    "exact_split") (the parameters and prototypes on the host, the logs,
    Σ|params|, the parameters before the step)."""
    release(torch)
    one = {}
    for mode in SP_BOUNDS:
        ad, _, logs, _, start = dp_compare_step(torch, "cuda", SP_BATCH, mode != "kernels",
                                                split_rows=mode == "exact_split")
        one[mode] = {**compared_state(torch, ad), "logs": logs, "start": start,
                     "abs_params": sum(v.double().abs().sum().item()
                                       for v in ad.state.params.values())}
        del ad
        release(torch)
    return one


def spatial_path(torch, K, launched, checked):
    """Phase 14: hybrid_switch.yml's bootstrap and fused step at full width
    (R50 3-4-6-3, ProDA head), b2 1024x512, on a (1 x 2) (14.1) and a (2 x 2)
    (14.2) grid of spatial ranks on the card, against one process (both
    modes on 14.1, batch-invariant on 14.2), then timed. The ranks ran as
    jobs of phase 13's torchruns (`launched`). Returns launch counts by path
    and the numbers."""
    t_phase = time.perf_counter()
    one = spatial_references(torch)
    summary, paths = {"references_seconds": time.perf_counter() - t_phase}, {}
    witness = grid_gaps(torch, "phase 14 witness", one["exact"],
                        {k: one["exact_split"][k] for k in ("params", "proto")},
                        one["exact_split"]["logs"])
    summary["witness"] = witness
    print(f"phase 14 witness: one process at b2 with its {SP_CONVS} convolutions in a spatial "
          f"axis's 2 row blocks (the grid's GEMMs, no collective), batch-invariant, against one "
          f"process after a bootstrap and one step: "
          + ", ".join(f"{k} {v:.3e}" for k, v in witness.items()))
    n_bn = SP_BN
    where = {"14.1": (launched["dirs"]["sp14.1"], launched["job_seconds"][3]),
             "14.2": (launched["sp14.2"]["dir"], launched["sp14.2"]["seconds"])}
    for sub, ((d, s), steps, modes) in SP_GRIDS.items():
        world = d * s
        sp_dir, seconds = where[sub]
        backend, _ = tp_layout(torch, world)
        layout = (f"{d} data x {s} spatial, {world} ranks, " + (
            f"one card each (cards 0-{world - 1})" if backend == "nccl" else
            f"all on card 0: gloo, card tensors through the card's memory (CUDA IPC)"))
        ranks = []
        for r in range(world):
            with open(os.path.join(sp_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        r0 = ranks[0]
        check(all(x["world"] == world and x["backend"] == backend
                  and x["position"] == [x["rank"] // s, x["rank"] % s] and x["grid"] == [d, s]
                  for x in ranks),
              f"phase {sub}: ranks report "
              f"{[(x['world'], x['backend'], x['position']) for x in ranks]}")
        gaps = {}
        for mode in modes:
            differ = sorted(k for x in ranks for k, v in x[mode]["digests"].items()
                            if v != r0[mode]["digests"][k])
            check(not differ, f"phase {sub} {mode}: the ranks' states differ: {differ[:6]}")
            check(all(x[mode]["logs"] == r0[mode]["logs"] for x in ranks),
                  f"phase {sub} {mode}: the ranks' logs differ")
            got = torch.load(os.path.join(sp_dir, f"rank0_{mode}.pt"), weights_only=False)
            for ref in (mode, "exact_split") if mode == "exact" else (mode,):
                gaps[ref] = grid_gaps(torch, f"phase {sub} {ref}", one[ref], got,
                                      r0[mode]["logs"])
                want_abs = one[ref]["abs_params"]
                gaps[ref]["abs_params"] = abs(r0[mode]["abs_params"] - want_abs) / want_abs
                against = ("the witness (one process at b2, every convolution in the row "
                           "blocks)" if ref == "exact_split" else "one process at b2")
                print(f"phase {sub} {ref}: hybrid_switch.yml in memory, b2 1024x512 ({layout}), "
                      f"{against} against the grid after a bootstrap and one step (TF32 off): "
                      + ", ".join(f"{k} {v:.3e} (bound "
                                  f"{SP_BOUNDS[ref].get(k, SP_ABS_PARAMS_RTOL):.0e})"
                                  for k, v in gaps[ref].items())
                      + f"; the ranks' {len(r0[mode]['digests'])} state tensors equal bit for "
                        f"bit")
        check_gaps(f"phase {sub}", {m: {k: v for k, v in g.items() if k != "abs_params"}
                                    for m, g in gaps.items()}, SP_BOUNDS)
        for mode, g in gaps.items():
            check(g["abs_params"] <= SP_ABS_PARAMS_RTOL,
                  f"phase {sub} {mode}: Σ|params| gap {g['abs_params']:.3e} > "
                  f"{SP_ABS_PARAMS_RTOL}")
        fired = r0["dynamic_fired"]
        want_coll = {"data": 0, "model": 0, "world": 5 * n_bn + 6,
                     "spatial": ((4 * steps + fired) * (SP_HALO + SP_SUMS)
                                 + 2 * steps * (SP_HALO - 1 + SP_SUMS)) / steps}
        for x in ranks:
            check(x["finite"], f"phase {sub} rank {x['rank']}: a non-finite loss")
            check(x["launches"] == {"pseudo_labels_kernel": 2 * steps,
                                    "bn_stats_kernel": 3 * n_bn * steps},
                  f"phase {sub} rank {x['rank']}: launches {x['launches']}, expected K1 2 and K2 "
                  f"{3 * n_bn} a step")
            per_step = {g: c["collectives"] / steps for g, c in x["collectives"].items()}
            check(per_step == want_coll, f"phase {sub} rank {x['rank']}: collectives a step "
                                         f"{per_step}, expected {want_coll}")
            k1_fed = {tuple(v) for v in x["k1_shapes"]} - {tuple(v) for v in checked["k1"]}
            k2_fed = {tuple(v[0]) for v in x["k2_shapes"]} - {tuple(v) for v in checked["k2"]}
            check(not k1_fed and not k2_fed, f"phase {sub} rank {x['rank']} fed unchecked "
                                             f"shapes: K1 {sorted(k1_fed)}, K2 {sorted(k2_fed)}")
            paths[f"spatial_{sub}_rank{x['rank']}"] = x["launches"]
        # the median after the first timed step (which warms up), where there are more
        step_ms = [statistics.median(x["step_ms"][1:] or x["step_ms"]) for x in ranks]
        mb = {g: c["bytes"] / steps / 1e6 for g, c in r0["collectives"].items()}
        summary[sub] = {"layout": layout, "backend": backend, "step_ms": step_ms,
                        "step_ms_all": [x["step_ms"] for x in ranks],
                        "peak_gib": [x["peak_gib"] for x in ranks], "gaps": gaps,
                        "collectives_per_step": want_coll, "mb_per_step": mb,
                        "debug_syncs": r0["debug_syncs"], "card_waits": r0["card_waits"] / steps,
                        "k1_shapes": sorted({tuple(v) for x in ranks for v in x["k1_shapes"]}),
                        "k2_row_shapes": len({tuple(v[0]) for x in ranks for v in x["k2_shapes"]}),
                        "seconds": seconds}
        print(f"phase {sub} timed ({steps} step(s) after the compared ones, TF32 on, {layout}): "
              f"median step ms per rank (after the first, where there are more) "
              + ", ".join(f"{v:.3f}" for v in step_ms)
              + " (steps: " + "; ".join(", ".join(f"{v:.3f}" for v in x["step_ms"])
                                        for x in ranks)
              + f"); per rank and step K1 {r0['launches']['pseudo_labels_kernel'] // steps} on "
              f"its pixels (P " + ", ".join(str(v[0]) for v in summary[sub]["k1_shapes"])
              + f"), K2 {r0['launches']['bn_stats_kernel'] // steps} on its rows "
              f"({summary[sub]['k2_row_shapes']} shapes); collectives a step by group "
              + ", ".join(f"{g} {want_coll[g]:.0f} of {mb[g]:.3f} MB" for g in want_coll)
              + f" (the spatial group's: halo rows and GroupNorm/SE sums); host syncs the CUDA "
              f"sync debug mode counts in one step: {r0['debug_syncs']}, the card channel's "
              f"stream waits {r0['card_waits'] / steps:.0f} a step; peak memory per rank "
              + ", ".join(f"{x['peak_gib']:.3f} GiB" for x in ranks)
              + f"; the ranks' job {seconds:.3f} s")
    summary["seconds"] = time.perf_counter() - t_phase
    print(f"phase 14 checks: {summary['seconds']:.3f} s (one-process references "
          f"{summary['references_seconds']:.3f} s)")
    return paths, summary


# ---------------------------------------------------------------------------
# phase 15: the GPU quality run (python -m onda_torch.quality_run), cut in depth
# ---------------------------------------------------------------------------

# the tool's knobs for phase 15: its 1024x512 and bf16, b4, 8 train and 4 val
# frames a domain, 2 pretraining epochs and 1 adaptation epoch
QUALITY_KNOBS = {"ONDA_QUALITY_BATCH": "4", "ONDA_QUALITY_NTRAIN": "8", "ONDA_QUALITY_NVAL": "4",
                 "ONDA_QUALITY_PRETRAIN_EPOCHS": "2", "ONDA_QUALITY_UDA_EPOCHS": "1",
                 "ONDA_QUALITY_PRECISION": "bf16"}
QUALITY_KEYS = ["precision", "src_miou_pretrained", "source_pre", "heavy_pre", "heavy_post",
                "source_post", "recovered", "steps", "wall_s"]
FIRST_STEP_DEADLINE = 300  # seconds a fresh CLI run may take to its first adapted step


@contextlib.contextmanager
def timed_calls(torch, owner, name, times, wrap_result=False):
    """owner.name timed on the host clock between device syncs, each call's
    ms appended to `times`; with `wrap_result` the function it returns is
    timed instead (the step that `step_fn` makes)."""
    orig = getattr(owner, name)

    def timed(fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t))
            return out
        return call

    if wrap_result:
        setattr(owner, name, lambda *a, **kw: timed(orig(*a, **kw)))
    else:
        setattr(owner, name, timed(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def first_step_seconds(cfg, work, log_path):
    """A fresh `python -m onda_torch.train_ouda --cfg` process on `cfg` (a
    dict): the seconds from its launch to its first adapted step's record in
    metrics.jsonl, and that record; the process is stopped there."""
    import yaml

    snap = os.path.join(work, "fresh_cli")
    cfg = {**cfg, "OTHERS": {**cfg["OTHERS"], "SNAPSHOT_DIR": snap}}
    path = os.path.join(work, "fresh_cli.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    metrics = os.path.join(snap, "metrics.jsonl")
    with open(log_path, "w") as log:
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "onda_torch.train_ouda", "--cfg", path],
                                cwd=HERE, stdout=log, stderr=subprocess.STDOUT)
        try:
            while True:
                check(proc.poll() is None, f"the fresh CLI run exited ({proc.returncode}) "
                                           f"before its first step; its output: {log_path}")
                check(time.perf_counter() - t0 < FIRST_STEP_DEADLINE,
                      f"no adapted step within {FIRST_STEP_DEADLINE} s of the fresh CLI run")
                if os.path.exists(metrics):
                    with open(metrics) as f:
                        steps = [json.loads(line) for line in f if line.endswith("\n")
                                 and "Total target loss" in line]
                    if steps:
                        return time.perf_counter() - t0, steps[0]
                time.sleep(0.05)
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def quality_path(torch, K, card, work, out_dir, checked, build_s):
    """Phase 15: `onda_torch.quality_run.run` on the card with QUALITY_KNOBS
    (pretraining, then the CLI over the storm), its launches counted by part
    and every K1/K2 shape it feeds recorded; then the time from the launch of
    a fresh CLI process on the run's config to its first adapted step."""
    import yaml

    from onda_torch import quality_run, registry
    from onda_torch.methods.proto_online import ProtoOnlineAdapter

    release(torch)
    root = os.path.join(work, "quality")
    env = {**QUALITY_KNOBS, "ONDA_QUALITY_DIR": root}
    knobs = quality_run.knobs(env)
    marks, pre_ms, step_ms, boot = {}, [], [], []
    pretrain, calculate = quality_run.pretrain_adam, ProtoOnlineAdapter.calculate_prototypes

    def pretrain_counted(*args, **kwargs):
        out = pretrain(*args, **kwargs)
        marks["pretrain"] = dict(K.launches)
        return out

    def calculate_counted(self, loader):
        before = dict(K.launches)
        calculate(self, loader)
        boot.append((len(loader), {k: K.launches[k] - before[k] for k in before}))

    log_path = os.path.join(out_dir, "quality_run.txt")
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    with contextlib.ExitStack() as stack:
        stack.enter_context(timed_calls(torch, quality_run, "adam_step", pre_ms))
        stack.enter_context(timed_calls(torch, ProtoOnlineAdapter, "step_fn", step_ms,
                                        wrap_result=True))
        quality_run.pretrain_adam = pretrain_counted
        ProtoOnlineAdapter.calculate_prototypes = calculate_counted
        stack.callback(setattr, quality_run, "pretrain_adam", pretrain)
        stack.callback(setattr, ProtoOnlineAdapter, "calculate_prototypes", calculate)
        shapes = stack.enter_context(KernelShapes(K))
        log = stack.enter_context(open(log_path, "w"))
        stack.enter_context(contextlib.redirect_stdout(log))
        t = time.perf_counter()
        result = quality_run.run("cuda", env=env)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
    total = dict(K.launches)
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 15 result: {json.dumps(result)}")

    check(list(result) == QUALITY_KEYS, f"quality run keys {list(result)}")
    for key in QUALITY_KEYS[1:]:
        value = result[key]
        check(isinstance(value, bool) or (value is not None and math.isfinite(value)),
              f"quality run: {key} = {value}")
    with open(knobs["out"]) as f:
        check(json.load(f) == result, "the written result differs from the printed one")
    pth = os.path.join(root, "source_bf16.pth")
    model = quality_run.build_model(registry.LAYERS["DeepLabv2-Resnet50"], "bf16")
    model.load_state_dict(registry.load_state_dict(pth), strict=True)
    del model
    per_epoch = knobs["n_train"] // knobs["batch"]
    steps = 2 * knobs["uda_epochs"] * per_epoch  # the storm's two target domains
    check(result["steps"] == steps, f"quality run: {result['steps']} steps, expected {steps}")
    n_pre = knobs["pretrain_epochs"] * per_epoch
    check(len(pre_ms) == n_pre and len(step_ms) == steps,
          f"timed {len(pre_ms)} pretraining and {len(step_ms)} adaptation steps, expected "
          f"{n_pre} and {steps}")
    pre = marks["pretrain"]
    check(pre == {"pseudo_labels_kernel": 0, "bn_stats_kernel": 53 * n_pre},
          f"pretraining launched {pre}, expected K2 53 a step")
    check(len(boot) == 1 and boot[0][1] == {"pseudo_labels_kernel": 0,
                                            "bn_stats_kernel": 53 * boot[0][0]},
          f"bootstrap launches {boot}, expected K2 53 a batch (one bootstrap)")
    with open(os.path.join(root, "cfg_bf16.yml")) as f:
        cfg = yaml.safe_load(f)  # the config the run drove the CLI with
    spec = cfg["METHOD"]["ADAPTATION"][cfg["METHOD"]["ADAPTATION"]["NAME"]]
    # K1 once a validation batch when evaluation scores the prototypes (3
    # sets, one evaluation before adaptation and one an epoch of each domain)
    val_batches = 3 * (1 + 2 * knobs["uda_epochs"]) * -(-knobs["n_val"] // knobs["batch"])
    proto_val = 0 if spec.get("SKIP_PROTO_EVAL") else val_batches
    cli = {k: total[k] - pre[k] for k in total}
    want = {"pseudo_labels_kernel": 2 * steps + proto_val,
            "bn_stats_kernel": 53 * boot[0][0] + 159 * steps}
    check(cli == want, f"the CLI run launched {cli}, expected {want} (K1 2 and K2 159 a step, "
                       f"K2 53 a bootstrap batch, K1 1 a validation batch with prototypes)")
    k1_fed = shapes.k1 - {tuple(c) for c in checked["k1"]}
    k2_fed = {s for s, _ in shapes.k2} - {tuple(c) for c in checked["k2"]}
    check(not k1_fed and not k2_fed, f"phase 15 fed unchecked shapes: K1 {k1_fed}, K2 {k2_fed}")
    print(f"phase 15 launches: pretraining {pre} ({n_pre} steps), the CLI {cli} ({steps} steps, "
          f"{boot[0][0]} bootstrap batches, {proto_val} validation batches with prototypes); "
          f"{len(shapes.k1)} K1 and {len(shapes.k2)} K2 shape/type pairs fed, all among those "
          f"phases 3-4 checked")

    first_s, first = first_step_seconds(cfg, work, os.path.join(out_dir, "fresh_cli.txt"))
    pre_med = statistics.median(pre_ms[per_epoch:]) if n_pre > per_epoch else pre_ms[-1]
    step_med = statistics.median(step_ms[1:])
    numbers = {"result": result, "seconds": seconds, "peak_gib": peak / 2**30,
               "pretrain_step_ms": pre_med, "adapt_step_ms": step_med,
               "pretrain_ms": pre_ms, "adapt_ms": step_ms, "first_step_s": first_s,
               "first_step_compile_run_s": first.get("Step compile+run seconds"),
               "kernel_build_s": build_s}
    print(f"phase 15, the quality run at b{knobs['batch']} {quality_run.W}x{quality_run.H} bf16, "
          f"{knobs['n_train']}/{knobs['n_val']} frames a domain, {knobs['pretrain_epochs']} + "
          f"{knobs['uda_epochs']} epochs [{card}]: {seconds:.3f} s; pretraining step "
          f"{pre_med:.3f} ms (median after its first epoch; all "
          f"{', '.join(f'{t:.3f}' for t in pre_ms)}), adaptation step {step_med:.3f} ms "
          f"(median after the first; all {', '.join(f'{t:.3f}' for t in step_ms)}), peak memory "
          f"{peak / 2**30:.3f} GiB (max_memory_allocated)")
    print(f"phase 15 cold start: a fresh CLI process (`python -m onda_torch.train_ouda`) on the "
          f"run's config reached its first adapted step {first_s:.3f} s after its launch, with "
          f"the kernel build directory warm (its step 0 took "
          f"{first.get('Step compile+run seconds', float('nan')):.3f} s); the cold build of "
          f"phases 1-2 took {build_s:.3f} s [{card}]")
    return {"quality_pretrain": pre, "quality_cli": cli}, numbers


# ---------------------------------------------------------------------------
# phase 16: the DeepLab-v3 zoo
# ---------------------------------------------------------------------------

V3_SMALL = (("resnet50", True, 16), ("mobilenetv2", False, 16), ("mobilenetv2", True, 8))
V3_SMALL_INPUT = (2, (64, 64))   # 16.1's batch and (H, W)
V3_FULL = (("resnet50", True, 16), ("mobilenetv2", False, 16))  # 16.2, b4 at MAIN_HW
V3_TIMED = 3  # 16.2's timed calls of each, after one
# 16.1's bounds on max|card − CPU| / max|CPU| of an output, and of a running
# mean in units of its BatchNorm's largest running std (a variance: of its
# largest running variance; a channel's mean may be ≈0, as behind a linear
# bottleneck): eval mode runs the same f32 arithmetic in another order;
# train mode normalises by batch statistics over 32 values a channel in an
# OS16 stage (2 in the pooling branch), K2 folding them in f64 where the
# plain version sums in f32
V3_BOUNDS = {"eval": 1e-4, "train": 2e-3, "stats": 2e-3}


def v3_tag(backbone, plus, os_):
    return f"{backbone} v3{'+' if plus else ''} OS{os_}"


def v3_bn_shapes(torch, backbone, plus, os_, batch, hw):
    """Input shape of every BatchNorm call of one DeepLab-v3 forward (meta tensors)."""
    from onda_torch.models.deeplabv3 import build_deeplab_v3

    with torch.device("meta"):
        model = build_deeplab_v3(19, backbone, plus, os_)
    return forward_bn_shapes(torch, model, batch, hw)


def seeded_v3(torch, config, seed):
    from onda_torch.models.deeplabv3 import build_deeplab_v3

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build_deeplab_v3(19, *config)


def rel_gap(torch, got, want) -> float:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    check(got.shape == want.shape and torch.isfinite(got).all(), "non-finite or misshapen")
    return ((got - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()


def v3_path(torch, K, card, checked):
    """Phase 16: 16.1 (`v3_small`) and 16.2 (`v3_full`), every K1/K2 shape
    they feed recorded and held to phase 4's checked ones."""
    release(torch)
    with KernelShapes(K) as shapes:
        small = v3_small(torch, card)
        paths, numbers = v3_full(torch, K, card)
    numbers["small_input_gaps"] = small
    unchecked = {s for s, _ in shapes.k2} - {tuple(c) for c in checked["k2"]}
    check(not shapes.k1 and not unchecked, f"phase 16 fed K1 {shapes.k1} and K2 shapes that "
                                           f"phase 4 did not check: {unchecked}")
    print(f"phase 16: {len(shapes.k2)} K2 shape/type pairs fed (16.1 on the card and the CPU, "
          f"16.2), all among those phase 4 checked")
    return paths, numbers


def v3_small(torch, card):
    """16.1: each V3_SMALL model on the card against the same on the CPU
    (plain K2) at V3_SMALL_INPUT, eval and train mode, TF32 off; returns
    the gaps by model."""
    from torch.func import functional_call

    batch, hw = V3_SMALL_INPUT
    g = torch.Generator().manual_seed(16)
    x = torch.randn(batch, 3, *hw, generator=g)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for config in V3_SMALL:
            runs = {}
            for device in ("cpu", "cuda"):
                model = seeded_v3(torch, config, 3).to(device)
                xd = x.to(device)
                with torch.no_grad():
                    ev = model(xd)[1]
                    buffers = {k: v.clone() for k, v in model.named_buffers()}
                    tr = functional_call(model, {**dict(model.named_parameters()), **buffers},
                                         (xd,), {"train": True, "update_stats": True})[1]
                runs[device] = ev, tr, buffers
            (ev_c, tr_c, st_c), (ev_g, tr_g, st_g) = runs["cpu"], runs["cuda"]
            stats = {}
            for k in st_c:  # each running statistic in units of its channels' spread
                if k.endswith("running_mean") or k.endswith("running_var"):
                    spread = st_c[k.rsplit(".", 1)[0] + ".running_var"].max()
                    unit = spread.sqrt() if k.endswith("running_mean") else spread
                    stats[k] = ((st_g[k].cpu() - st_c[k]).abs().max() / unit).item()
            worst = max(stats, key=stats.get)
            gaps = {"eval": max(rel_gap(torch, ev_g[k], ev_c[k]) for k in ("out", "feat")),
                    "train": max(rel_gap(torch, tr_g[k], tr_c[k]) for k in ("out", "feat")),
                    "stats": stats[worst]}
            tag = f"16.1 {v3_tag(*config)}"
            for key, gap in gaps.items():
                check(gap <= V3_BOUNDS[key],
                      f"{tag}: {key} card vs CPU {gap:.3e} > {V3_BOUNDS[key]} (statistics: the "
                      f"worst {worst}, max|CPU| {st_c[worst].abs().max().item():.6e}, max|card| "
                      f"{st_g[worst].abs().max().item():.6e}, max gap "
                      f"{(st_g[worst].cpu() - st_c[worst]).abs().max().item():.6e}; "
                      f"{sum(v > V3_BOUNDS['stats'] for v in stats.values())} of {len(stats)} "
                      f"tensors over the bound: "
                      f"{sorted(k for k, v in stats.items() if v > V3_BOUNDS['stats'])[:12]})")
            print(f"phase {tag}, b{batch} {hw[1]}x{hw[0]}, card vs CPU (plain K2), max gap / "
                  f"max|CPU|: eval {gaps['eval']:.3e}, train {gaps['train']:.3e}, running "
                  f"statistics {gaps['stats']:.3e} (bounds {V3_BOUNDS}) [{card}]")
            out[v3_tag(*config)] = gaps
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return out


def v3_full(torch, K, card):
    """16.2: each V3_FULL model at b4 1024x512 f32, a train-mode forward and
    the backward of a CE loss (K2 once per BatchNorm) timed, and an eval
    forward timed. Returns (launches by path, numbers)."""
    from onda_torch.models.layers import TorchBatchNorm
    from onda_torch.ops import losses as L

    paths, numbers = {}, {}
    for config in V3_FULL:
        tag = v3_tag(*config)
        base = release(torch)
        model = seeded_v3(torch, config, 4).cuda()
        n_bn = sum(isinstance(m, TorchBatchNorm) for m in model.modules())
        g = torch.Generator(device="cuda").manual_seed(17)
        xb = torch.randn(4, 3, *MAIN_HW, device="cuda", generator=g)
        labels = torch.randint(0, 19, (4, *MAIN_HW), device="cuda", generator=g)
        params = [p for p in model.parameters()]
        losses = []

        def train_step():
            out = model(xb, train=True, update_stats=True)[1]["out"]
            loss = L.cross_entropy_2d(out, labels)
            grads = torch.autograd.grad(loss, params)
            losses.append(loss.detach())
            return out, grads

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        out, grads = train_step()
        check(torch.isfinite(out).all() and all(torch.isfinite(gr).all() for gr in grads),
              f"16.2 {tag}: non-finite logits or gradients")
        del out, grads
        fwd_bwd = timed_ms(torch, train_step, warmup=0, n=V3_TIMED)
        launches = dict(K.launches)
        peak = torch.cuda.max_memory_allocated()
        check(all(math.isfinite(v.item()) for v in losses), f"16.2 {tag}: non-finite loss")
        want = {"pseudo_labels_kernel": 0, "bn_stats_kernel": n_bn * (1 + V3_TIMED)}
        check(launches == want, f"16.2 {tag}: launched {launches}, expected K2 {n_bn} a forward")
        with torch.no_grad():
            K.reset_launches()
            eval_ms = timed_ms(torch, lambda: model(xb)[1]["out"], warmup=1, n=V3_TIMED)
            check(K.launches["bn_stats_kernel"] == 0, f"16.2 {tag}: eval mode launched K2")
        name = f"v3_{config[0]}{'_plus' if config[1] else ''}_os{config[2]}"
        paths[name] = launches
        numbers[tag] = {"bn_calls": n_bn, "fwd_bwd_ms": statistics.median(fwd_bwd),
                        "eval_ms": statistics.median(eval_ms), "peak_gib": peak / 2**30,
                        "loss": losses[-1].item()}
        print(f"phase 16.2 {tag}, b4 {MAIN_HW[1]}x{MAIN_HW[0]} f32, seeded weights [{card}]: "
              f"train-mode forward + backward of a CE loss "
              f"{', '.join(f'{t:.3f}' for t in fwd_bwd)} ms (median "
              f"{numbers[tag]['fwd_bwd_ms']:.3f}), eval forward "
              f"{', '.join(f'{t:.3f}' for t in eval_ms)} ms (median "
              f"{numbers[tag]['eval_ms']:.3f}); peak memory {peak / 2**30:.3f} GiB "
              f"({base / 2**30:.3f} GiB allocated before); K2 {n_bn} a forward; loss "
              f"{losses[-1].item():.6f}")
        del model, params, xb, labels, losses
    return paths, numbers


def main() -> int:
    if sys.argv[1:2] == ["--rank-jobs"]:  # a rank of phase 12 or 13, under torch.distributed.run
        import faulthandler

        # a rank still running shortly before the deadline prints where it waits
        faulthandler.dump_traceback_later(JOBS_DEADLINE - 30, exit=False)
        return rank_jobs(sys.argv[2:])
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--skip-main", action="store_true", help="kernel phases only")
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--compare", metavar="DIR",
                        help="time the K1 and K2 of the onda_torch package in DIR against this tree's")
    parser.add_argument("--aux-cost", action="store_true",
                        help="also time phase 8.2's step with the aux head computed, in turns")
    parser.add_argument("--parallel-only", action="store_true",
                        help="phases 1-4, phase 7's dataset and phases 12-13 only")
    parser.add_argument("--quality-only", action="store_true",
                        help="phases 1-4, 15 (the quality run) and 16 (DeepLab-v3) only")
    parser.add_argument("--out-dir", default=os.path.join(HERE, "build", "chip_smoke"),
                        help="where the per-shape K2 table, the profile and the comparison go")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this script needs a CUDA card")
    check(os.path.isdir(os.path.join(HERE, "onda_torch")),
          "the onda_torch package is not beside chip_smoke.py")
    sys.path.insert(0, HERE)
    from onda_torch import native
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

    t_script = time.perf_counter()
    with phase_clock("1-2 (builds)"):
        prep = threading.Thread(target=lambda: prep_build.append(native.build()))
        prep_build = []
        prep.start()  # g++ of the host prep runs beside nvcc
        build.build_all(verbose=True)
        print(f"kernel build: {time.perf_counter() - t_script:.3f} s into {build.BUILD_DIR}")
        prep.join()
        check(prep_build, "the C++ host prep did not build (its error is above)")
        print(f"C++ host prep build: {time.perf_counter() - t_script:.3f} s into {prep_build[0]}")

    with phase_clock("3"):
        k1 = check_k1(torch, K, P)
    with phase_clock("4"):
        k2 = check_k2(torch, K, layers, args.out_dir)
        bn = check_bn_passes(torch, K, args.out_dir)
    if not (args.parallel_only or args.quality_only):
        with phase_clock("5"):
            small_input_check(torch)
    if args.compare:
        compare_earlier(torch, K, args.compare, args.out_dir)
    paths, summary = {}, {}
    if not args.skip_main:
        torch.backends.cudnn.allow_tf32 = True
        print("main path: cudnn.allow_tf32=True (PyTorch's default: convolutions in TF32), "
              "cuda.matmul.allow_tf32=False")
        checked = {"k1": k1["checked_shapes"], "k2": k2["checked_shapes"]}
        if not (args.parallel_only or args.quality_only):
            with phase_clock("6"):
                paths["in_memory"], summary = main_path(torch, K, args.profile, args.out_dir)
        work = tempfile.mkdtemp(prefix="onda_cli_")
        try:
            if not args.quality_only:
                root = os.path.join(work, "weather_cityscapes") + "/"
                with phase_clock("7 (dataset)"):
                    rows, img_bytes = write_dataset(root, seed=7)
                print(f"phase 7 dataset: {len(rows)} frames of {FRAME_HW[1]}x{FRAME_HW[0]} "
                      f"(intensities {CLI_INTENSITIES}, {CLI_FRAMES} per intensity), mean image "
                      f"PNG {img_bytes / len(rows) / 1e6:.3f} MB")
            if not (args.parallel_only or args.quality_only):
                with phase_clock("7"):
                    (paths["cli"], paths["cli_resumed"]), summary["cli"] = cli_path(
                        torch, K, args.out_dir, summary["frames_per_s"], work, root, rows)
                with phase_clock("8"):
                    workflow, summary["workflow"], pth = workflow_path(
                        torch, K, args.out_dir, work, root, rows, aux_cost=args.aux_cost)
                paths.update(workflow)
                with phase_clock("9"):
                    adversarial, summary["adversarial"] = adversarial_path(
                        torch, K, args.out_dir, work, root, pth, args.profile)
                paths.update(adversarial)
                with phase_clock("10"):
                    options, summary["model_options"] = model_options_path(
                        torch, K, card, work, args.out_dir, args.profile)
                paths.update(options)
                with phase_clock("11"):
                    shipped, summary["shipped_configs"] = shipped_configs_path(
                        torch, K, args.out_dir, work, root, rows, checked)
                paths.update(shipped)
            if not args.quality_only:
                with phase_clock("12"):
                    one = one_process_references(torch)  # of 12.1 and 13.1-13.2
                    refs = family_references(torch)  # of 12.3 and 13.4
                    launched = data_parallel_ranks(torch, args.out_dir, work, root, rows)
                    parallel, summary["data_parallel"] = data_parallel_path(
                        torch, K, args.out_dir, work, root, rows, one, launched)
                    paths.update(parallel)
                    families, summary["data_parallel_families"] = data_parallel_families_path(
                        torch, K, args.out_dir, work, root, rows, refs, launched)
                    paths.update(families)
                with phase_clock("13"):
                    launched = tensor_parallel_ranks(torch, args.out_dir, work, root, rows)
                    grid, summary["tensor_parallel"] = tensor_parallel_path(
                        torch, K, args.out_dir, work, root, rows, one, launched)
                    paths.update(grid)
                    del one
                    grid, summary["tensor_parallel_families"] = tensor_parallel_families_path(
                        torch, K, args.out_dir, work, root, rows, refs, checked, launched)
                    paths.update(grid)
                    del refs
                with phase_clock("14"):
                    spatial, summary["spatial"] = spatial_path(torch, K, launched, checked)
                    paths.update(spatial)
                    del launched
            if not args.parallel_only:
                with phase_clock("15"):
                    quality, summary["quality_run"] = quality_path(
                        torch, K, card, work, args.out_dir, checked, PHASE_SECONDS["1-2 (builds)"])
                    paths.update(quality)
                with phase_clock("16"):
                    zoo, summary["deeplab_v3"] = v3_path(torch, K, card, checked)
                    paths.update(zoo)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    for k in (k1, k2):
        k["launches_by_path"] = {p: c.get(k["name"], 0) for p, c in paths.items()}
        k["launches"] = sum(k["launches_by_path"].values())
    summary["phase_seconds_by_phase"] = PHASE_SECONDS
    print(f"main path summary: {json.dumps(summary)}")
    print(f"chip_smoke total seconds: {time.perf_counter() - t_script:.3f} (phases "
          + ", ".join(f"{k} {v:.3f}" for k, v in PHASE_SECONDS.items()) + ")")
    print(card)
    print(json.dumps({"kernels": [k1, k2, bn]}))
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
