"""OTHERS.DATA_PARALLEL for SEGMENT training and EVALUATION mode across
ranks, on the CPU with 2 gloo processes (tests/torch_parallel_worker.py).

SEGMENT: two ranks run `SegmentTrainer.train` for one epoch of two steps at
global batch 4 (b2 a rank), 32×64, training_fog.yml's multi-level R50 at
layers (1, 1, 1, 1), dropout off, weights converted from the JAX package's,
then its evaluation of 8 validation frames with full-image labels (two whole
global batches a set: the entropy is then the global batches' own). Rank 1's
labels are mostly 255. Held against JAX's `SegmentTrainer` with
OTHERS.DATA_PARALLEL 2 on the conftest's virtual CPU devices, against the
port's one process on the global batches, and rank against rank.

EVALUATION: validation_offline_fog.yml's runner on a directory of three
`.pth` snapshots, rank 1 failing to read the newest (an injected read
error): both ranks skip it and load the same older one, and the sweep skips
it on both and finishes. Its evaluation, the sweep's per-checkpoint results,
the prediction dumps (the global batch in rank-major order) and their
confidence are held against one process on the same files.
"""

import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onda_tpu.config import cfg_from_file as jax_cfg_from_file
from onda_tpu.config import default_config
from onda_tpu.methods.segmentation import SegmentTrainer as JaxTrainer
from onda_tpu.models import build_deeplab_v2 as jax_build
from onda_tpu.models.import_torch import flax_to_torch_state_dict
from onda_torch.models.convert import flax_to_state_dict
from onda_torch.ops import kernels as K
from onda_torch.parallel import distributed

from .test_torch_advent import GRAD_ENVELOPE
from .test_torch_parallel import _card_bn_stats
from .torch_parallel_worker import (Recorder, finish_ranks, run_evaluation, run_segment,
                                    start_ranks, thin)

B, H, W, C = 4, 32, 64, 19
RAW_HW = (2 * H, 2 * W)
STEPS, WORLD = 2, 2
LR = 2e-2  # training_fog.yml's 2.5e-4 moves random weights too little to compare
DEADLINE = 300  # seconds for the pair of ranks; a hang fails the tests
N_VAL, N_FRAMES = 8, 8
CHECKPOINTS = ("model_train_a.pth", "model_train_b.pth", "model_train_c.pth")  # oldest first
FAILS_ON_RANK1 = "model_train_c.pth"
# the ranks against one process on the global batch (its BatchNorm variance
# in f64 as the ranks take it): the loss relative (measured 8e-8), each
# parameter's update against its largest entry (measured 1.0e-4); ≈10x
ONE_RTOL, ONE_UPDATE = 2e-6, 1e-3


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _batch(rng, n, raw=False):
    out = {"image": rng.normal(size=(n, H, W, 3)).astype(np.float32),
           "label": rng.integers(0, C, size=(n, H, W)).astype(np.int32)}
    if raw:
        out["label_raw"] = rng.integers(0, C, size=(n, *RAW_HW)).astype(np.int32)
    return out


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def jax_segment(variables, batches, val, snap, others=None):
    """JAX's SegmentTrainer with OTHERS.DATA_PARALLEL 2 (or the OTHERS
    overrides `others`): its train() over the same epoch, each step's LR,
    loss and state recorded."""
    cfg = jax_cfg_from_file("configs/training_fog.yml", default_config())
    cfg.SCHEME.RESOLUTION = [W, H]
    cfg.SCHEME.ORIGINAL_RES = [RAW_HW[1], RAW_HW[0]]
    cfg.OTHERS.SNAPSHOT_DIR = snap
    for key, value in (others or {"DATA_PARALLEL": WORLD}).items():
        cfg.OTHERS[key] = value
    cfg.TRAINING.BATCH_SIZE = B
    cfg.METHOD.PRETRAIN.SEGMENT.LEARNING_RATE = LR
    cfg.METHOD.PRETRAIN.SEGMENT.EPOCHS = 1
    model = jax_build(num_classes=C, layers=(1, 1, 1, 1), droprate=0.0, multi_level=True)
    tr = JaxTrainer(model, variables, cfg, cfg.METHOD.PRETRAIN.SEGMENT, C, logger=Recorder())
    assert tr.mesh is not None and tr.mesh.size == (WORLD if others is None else 8)
    out = {"lr": [], "loss": [], "values": []}
    tr._step = tr._build_step()
    step = tr._step

    def recorded(*args):
        res = step(*args)
        out["lr"].append(float(args[-1]))
        out["loss"].append(float(res[-1]))
        sd = flax_to_torch_state_dict({"params": jax.tree.map(np.asarray, res[0]),
                                       "batch_stats": jax.tree.map(np.asarray, res[1])})
        out["values"].append({k: thin(np.asarray(v)) for k, v in sd.items()})
        return res

    tr._step = recorded
    tr.save_model = lambda: None
    tr.train({"src": batches}, {"v": val})
    out["records"] = tr.logger.records
    return out


def _write_checkpoints(state_dict, ckpt_dir):
    """Three student `.pth` files, each further from the start, oldest first."""
    os.makedirs(ckpt_dir)
    g = torch.Generator().manual_seed(3)
    for i, name in enumerate(CHECKPOINTS):
        sd = {k: v + 0.02 * i * torch.randn(v.shape, generator=g) if v.is_floating_point()
              and "running" not in k else v for k, v in state_dict.items()}
        path = os.path.join(ckpt_dir, name)
        torch.save(sd, path)
        os.utime(path, (1000 + i, 1000 + i))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("segment_eval")
    rng = np.random.default_rng(1)
    batches = [_batch(rng, B) for _ in range(STEPS)]
    for b in batches:
        b["label"][B // WORLD:][rng.random((B // WORLD, H, W)) < 0.8] = 255
    val = [_batch(rng, B, raw=True) for _ in range(N_VAL // B)]
    variables = {}
    for name, multi in (("segment", True), ("evaluation", False)):
        model = jax_build(num_classes=C, layers=(1, 1, 1, 1), droprate=0.0, multi_level=multi)
        variables[name] = jax.tree.map(np.asarray, dict(
            model.init(jax.random.key(0), jnp.zeros((1, H, W, 3)), train=False)))
    state_dicts = {n: flax_to_state_dict(v) for n, v in variables.items()}
    ckpt_dir = str(tmp / "checkpoints")
    _write_checkpoints(state_dicts["evaluation"], ckpt_dir)
    eval_val = _batch(rng, N_VAL)
    scenarios = {
        "segment": {"kind": "segment", "model": "segment", "hw": (H, W), "raw_hw": RAW_HW,
                    "batch": B, "lr": LR, "steps": batches, "val": val},
        "evaluation": {"kind": "evaluation", "model": "evaluation", "hw": (H, W), "batch": B,
                       "ckpt_dir": ckpt_dir, "fail_on_ranks": {1: [FAILS_ON_RANK1]},
                       "val": eval_val, "frames": _batch(rng, N_FRAMES)["image"],
                       "pred_dir": str(tmp / "pred_ranks")}}
    started = start_ranks(tmp, {"scenarios": scenarios, "state_dicts": state_dicts},
                          world=WORLD)
    try:
        jax_out = jax_segment(variables["segment"], batches, val, str(tmp / "jax"))
        single = _single(scenarios, state_dicts, tmp)
    finally:
        rcs, outs, timed_out = finish_ranks(started, DEADLINE)
    assert not timed_out, f"ranks still running after {DEADLINE} s (a collective deadlock?)"
    for r, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"rank {r} failed (rc {rc}):\n{out[-4000:]}"
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    dumps = {who: {name: torch.load(os.path.join(d, "_".join("(25,)"), name))
                   for name in sorted(os.listdir(os.path.join(d, "_".join("(25,)"))))}
             for who, d in (("ranks", tmp / "pred_ranks0"), ("single", tmp / "pred_single0"))}
    rank1_dumps = os.path.exists(tmp / "pred_ranks1")
    out = {"ranks": ranks, "jax": jax_out, "single": single, "dumps": dumps,
           "rank1_dumps": rank1_dumps, "start": state_dicts["segment"]}
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def _single(scenarios, state_dicts, tmp):
    """Both scenarios on one process on the global batches, its BatchNorm
    variance taken as the ranks take it; any collective raises. Its one rank
    fails to read the file rank 1 cannot, so that it loads the same one."""
    def refuse(*args, **kwargs):
        raise AssertionError("a collective at world size 1")

    distributed.reset_counts()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(K, "bn_stats_plain", _card_bn_stats)
        mp.setattr(torch.distributed, "all_reduce", refuse)
        mp.setattr(torch.distributed, "broadcast", refuse)
        out = {"segment": run_segment(scenarios["segment"], state_dicts["segment"], 0, 1,
                                      str(tmp / "single_segment")),
               "evaluation": run_evaluation(
                   {**scenarios["evaluation"], "pred_dir": str(tmp / "pred_single"),
                    "fail_on_ranks": {0: [FAILS_ON_RANK1]}},
                   state_dicts["evaluation"], 0, 1, str(tmp / "single_evaluation"))}
    out["collectives"] = distributed.counts()
    return out


def _scenario(runs, name, rank=0):
    return runs["ranks"][rank]["scenarios"][name]


# ---------------------------------------------------------------------------
# SEGMENT
# ---------------------------------------------------------------------------

def test_segment_ranks_end_every_step_with_the_same_bits(runs):
    """Parameters, BN buffers and momentum equal bit for bit on both ranks
    after every step; the same LRs and records (the logged loss and the
    evaluation are global) on both."""
    r0, r1 = _scenario(runs, "segment", 0), _scenario(runs, "segment", 1)
    for i in range(STEPS):
        differ = [k for k, v in r0["digests"][i].items() if r1["digests"][i][k] != v]
        assert not differ, (i, differ[:5])
    assert r0["lr"] == r1["lr"] and r0["records"] == r1["records"]
    assert runs["single"]["collectives"] == {"collectives": 0, "bytes": 0}


def test_segment_loss_lr_and_updates_match_one_process(runs):
    """The ranks' shares sum to one process's loss; the LR sequence and the
    logged records' keys are one process's; each parameter's update is one
    process's within ONE_UPDATE of its largest entry, the BN buffers to 1e-6."""
    ranks = [_scenario(runs, "segment", r) for r in range(WORLD)]
    one = runs["single"]["segment"]
    assert ranks[0]["lr"] == one["lr"]
    for i in range(STEPS):
        total = sum(r["loss"][i] for r in ranks)
        assert total == pytest.approx(one["loss"][i], rel=ONE_RTOL), i
        for key, want in one["values"][i].items():
            got = ranks[0]["values"][i][key]
            if key.startswith("params."):
                start = thin(runs["start"][key[len("params."):]])
                gap = np.abs(_np(got) - _np(want)).max() / max(
                    np.abs(_np(want) - _np(start)).max(), 1e-30)
                assert gap <= ONE_UPDATE, (i, key, gap)
            elif _np(want).dtype.kind == "f":
                np.testing.assert_allclose(_np(got), _np(want), rtol=ONE_RTOL, atol=1e-6,
                                           err_msg=f"{i} {key}")
    assert [set(r) for r in ranks[0]["records"]] == [set(r) for r in one["records"]]
    assert ranks[0]["records"][0]["Segmentation loss"] == pytest.approx(
        one["records"][0]["Segmentation loss"], rel=ONE_RTOL)


def test_segment_evaluation_matches_one_process(runs):
    """Per-class IoU at the input and at the full-image size from the summed
    confusion matrices, and the entropy as the mean of the ranks' batch
    means: one process's, but for the trained weights' own gap (above),
    which moves a few pixels' argmax (measured: mIoU 1.2e-4 relative,
    entropy 1.1e-7)."""
    got = _scenario(runs, "segment")["records"][-1]
    want = runs["single"]["segment"]["records"][-1]
    assert set(got) == set(want) and {"Val mIoU full image of v", "val entropy of v"} <= set(got)
    for key, value in want.items():
        rel = 1e-6 if key == "val entropy of v" else 1e-3
        assert got[key] == pytest.approx(value, rel=rel), key


def test_segment_matches_jax_data_parallel(runs):
    """Against JAX's SegmentTrainer on a 2-device `data` mesh, at
    tests/test_torch_segment.py's tolerances: the LRs (f32), the loss rtol
    1e-4 and the state rtol 1e-4 / atol 1e-5 at step 0, rtol 1e-3 / atol
    6e-4 after; the records' keys, and the evaluation's mIoU and entropy at
    rel 2e-3, abs 1e-4. At step 0 the backbone's update, which passes the
    BatchNorms whose variance JAX takes in one pass (tests/test_torch_advent.py),
    is held within GRAD_ENVELOPE of its largest entry instead (measured
    0.75%; 2.3x that atol in layer1.0.conv2.weight)."""
    ranks = [_scenario(runs, "segment", r) for r in range(WORLD)]
    check_segment_against_jax([sum(r["loss"][i] for r in ranks) for i in range(STEPS)],
                              ranks[0], runs["jax"], runs["start"])


def check_segment_against_jax(losses, got, jax_out, start_sd):
    """The global batch's `losses` and rank 0's run `got` (LRs, whole values,
    records) against `jax_out` (`jax_segment`), at the tolerances above;
    start_sd: the weights before the steps."""
    assert np.float32(got["lr"]).tolist() == jax_out["lr"]
    for i in range(STEPS):
        np.testing.assert_allclose(losses[i], jax_out["loss"][i], rtol=1e-4 if i == 0 else 1e-3)
        tol = dict(rtol=1e-4, atol=1e-5) if i == 0 else dict(rtol=1e-3, atol=6e-4)
        values = got["values"][i]
        for key, want in jax_out["values"][i].items():
            g = values.get(f"params.{key}", values.get(f"batch_stats.{key}"))
            if key.endswith("num_batches_tracked"):
                continue
            if i == 0 and f"params.{key}" in values and not key.startswith("layer6."):
                start = thin(start_sd[key])
                gap = np.abs(_np(g) - want).max() / max(np.abs(want - _np(start)).max(), 1e-30)
                assert gap <= GRAD_ENVELOPE, (key, gap)
                continue
            np.testing.assert_allclose(_np(g), want, err_msg=f"{i} {key}", **tol)
    got, want = got["records"], jax_out["records"]
    assert [set(r) for r in got] == [set(r) for r in want]
    assert got[0]["Segmentation loss"] == pytest.approx(want[0]["Segmentation loss"], rel=1e-4)
    for key in ("Val mIoU of v", "Val std IoU of v", "val entropy of v",
                "Val mIoU full image of v"):
        assert got[-1][key] == pytest.approx(want[-1][key], rel=2e-3, abs=1e-4), key


def test_segment_collectives_and_one_writer(runs):
    """Per rank and step: one all-reduce per BatchNorm forward and backward
    (17 each), one for the valid count and one gradient bucket; rank 0
    alone wrote `model_train_[[0]].pth`, with no temporary left."""
    for counts in _scenario(runs, "segment")["collectives"]:
        assert counts["collectives"] == 2 * 17 + 2, counts
    assert _scenario(runs, "segment", 0)["files"] == ["model_train_[[0]].pth"]
    assert _scenario(runs, "segment", 1)["files"] == []


# ---------------------------------------------------------------------------
# EVALUATION
# ---------------------------------------------------------------------------

def test_a_checkpoint_one_rank_cannot_read_is_skipped_on_both(runs):
    """Rank 1 cannot read the newest snapshot: both ranks skip it (each says
    why) and load the next older one, the same file; the sweep skips it on
    both and evaluates the other two, on both ranks alike."""
    for rank in range(WORLD):
        out = _scenario(runs, "evaluation", rank)
        loaded = [line for line in out["load_print"].splitlines()
                  if line.endswith("is being loaded")]
        assert len(loaded) == 1 and loaded[0].endswith(f"{CHECKPOINTS[1]} is being loaded")
        assert f"load skip: {FAILS_ON_RANK1}" in out["load_print"]
        assert f"sweep skip: {FAILS_ON_RANK1}" in out["sweep_print"]
        swept = [r["Swept checkpoint"] for r in out["sweep_records"] if "Swept checkpoint" in r]
        assert swept == list(CHECKPOINTS[:2]), swept
    why = [_scenario(runs, "evaluation", r)["load_print"] for r in range(WORLD)]
    assert "injected read failure" in why[1] and "on another rank" in why[0]
    assert (_scenario(runs, "evaluation", 0)["sweep_records"]
            == _scenario(runs, "evaluation", 1)["sweep_records"])


def _by_checkpoint(records):
    return {r["Swept checkpoint"]: r for r in records if "Swept checkpoint" in r}


def test_evaluation_matches_one_process(runs):
    """The ranks' `evaluate_all` of the file they loaded, and each swept
    checkpoint's results, equal one process's on the same files: mIoU and
    std exactly (summed confusion matrices), ECE to f32 rounding."""
    ranks, single = _scenario(runs, "evaluation"), runs["single"]["evaluation"]
    one = _by_checkpoint(single["sweep_records"])
    assert sorted(one) == sorted(CHECKPOINTS[:2])
    compared = [(ranks["evaluate_all"], single["evaluate_all"])]
    compared += [(got, one[name]) for name, got in _by_checkpoint(ranks["sweep_records"]).items()]
    for got, want in compared:
        keys = [k for k in want if k.startswith(("Val mIoU", "Val std IoU", "ece "))]
        assert keys and set(keys) <= set(got)
        for key in keys:
            if key.startswith("ece "):
                assert got[key] == pytest.approx(want[key], rel=1e-6, abs=1e-9), key
            else:
                assert got[key] == want[key], key


def test_prediction_dumps_are_the_global_batch_in_rank_major_order(runs):
    """Rank 0 alone writes; each dump is the global batch, rank 0's rows and
    then rank 1's (rank r holds every 2nd frame from r: the order of a
    multi-process JAX run), which is one process's batch with its rows
    reordered; the logged confidence is the global batch's mean."""
    ranks, one = runs["dumps"]["ranks"], runs["dumps"]["single"]
    assert sorted(ranks) == sorted(one) == [f"batch-{i}.pt" for i in range(N_FRAMES // B)]
    assert not runs["rank1_dumps"]
    b = B // WORLD
    order = [r + WORLD * j for r in range(WORLD) for j in range(b)]  # [0, 2, 1, 3]
    for name, want in one.items():
        assert ranks[name].shape == want.shape == (B, C, H // 8 + 1, W // 8 + 1)
        torch.testing.assert_close(ranks[name], want[order], rtol=1e-5, atol=1e-6, msg=name)
    got = [r for r in _scenario(runs, "evaluation")["load_records"] if "Prediction confidence" in r]
    want = [r for r in runs["single"]["evaluation"]["load_records"]
            if "Prediction confidence" in r]
    assert len(got) == len(want) == N_FRAMES // B
    for g, w in zip(got, want):
        assert g["Progress"] == w["Progress"]
        assert g["Prediction confidence"] == pytest.approx(w["Prediction confidence"], rel=1e-6)
        assert math.isfinite(g["Prediction confidence"])
