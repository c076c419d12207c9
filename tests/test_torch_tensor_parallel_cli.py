"""OTHERS.TENSOR_PARALLEL through the CLI: `python -m torch.distributed.run
--nproc-per-node 2 -m onda_torch.train_ouda --cfg <cut hybrid_switch.yml>
--device cpu` with OTHERS.TENSOR_PARALLEL 2, a (1 × 2) grid of gloo ranks,
beside the one-process CLI on the same config without it; then an
AUTO_RESUME rerun of the grid; then the grid's `adapt_state.pt` in one
process. Then advent.yml on a (1 × 2) grid and validation_offline_advent.yml
on its snapshot, on the grid beside one process. The R50 of every run is cut
to one bottleneck a stage (the worker's `cli` mode, `registry.LAYERS`)."""

import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch
import yaml

from onda_torch import registry, train_ouda

from .synthetic import make_synthetic_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
PER_DOMAIN, BATCH, TP = 2, 2, 2
DEADLINE = 300
LOSSES = ("ce_loss", "rce_loss", "regularization_loss", "buff_ce_loss", "Total target loss")


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _cfg(path, root, snap, **others):
    """hybrid_switch.yml cut to the synthetic dataset: two domains, one
    epoch, global batch 2, a dynamic replay buffer that the steps insert into."""
    with open(os.path.join(ROOT, "configs", "hybrid_switch.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["SCHEME"].update(PATH=root + "/", RESOLUTION=[64, 32], DOMAIN_ORDER=[[25], [50]])
    cfg["TRAINING"].update(BATCH_SIZE=BATCH, REPLAY_BUFFER=4, BUFFER_DYNAMIC=True,
                           PERC_FILL_PER_DOMAIN=1.0)
    cfg["OTHERS"].update(SNAPSHOT_DIR=snap, NUM_WORKERS=2, **others)
    cfg["MODEL"]["LOAD"] = None
    cfg["METHOD"]["ADAPTATION"]["PROTO_ONLINE_HYBRIDSWITCH"].update(
        EPOCHS=1, LOAD_PROTO=None, PSEUDO_THRESH=0.06)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _torchrun(cfg_path, log_path):
    """The grid's CLI under `python -m torch.distributed.run`; returns the
    process, its output going to log_path."""
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "2"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(TP), WORKER, "cli", "--cfg", cfg_path, "--device", "cpu"]
    log = open(log_path, "w+")
    return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, cwd=ROOT, env=env,
                            start_new_session=True), log


def _finish(proc, log):
    try:
        proc.wait(timeout=DEADLINE)
    except subprocess.TimeoutExpired:
        pytest.fail(f"torchrun still running after {DEADLINE} s (a collective deadlock?)")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
        log.seek(0)
        text = log.read()
        log.close()
    assert proc.returncode == 0, text[-4000:]
    return text


def _records(snap):
    with open(os.path.join(snap, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_cli")
    try:
        yield _cli_runs(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)  # the runs' checkpoints, ≈1 GB each


def _cli_runs(tmp):
    """The grid's CLI and, meanwhile, one process's; then the grid's
    AUTO_RESUME rerun on its snapshot directory."""
    root = str(tmp / "ds")
    make_synthetic_dataset(root, intensities=(0, 25, 50), per_domain=PER_DOMAIN,
                           size_wh=(64, 32))
    snaps = {"grid": str(tmp / "snap_grid"), "one": str(tmp / "snap_one")}
    grid_cfg = _cfg(tmp / "grid.yml", root, snaps["grid"], TENSOR_PARALLEL=TP)
    proc, log = _torchrun(grid_cfg, tmp / "grid.log")
    with contextlib.redirect_stdout(io.StringIO()), pytest.MonkeyPatch.context() as mp:
        mp.setitem(registry.LAYERS, "DeepLabv2-Resnet50", (1, 1, 1, 1))
        one = train_ouda.main(["--cfg", _cfg(tmp / "one.yml", root, snaps["one"]),
                               "--device", "cpu"])
    text = _finish(proc, log)
    runs = {k: {"records": _records(v), "files": sorted(os.listdir(v))}
            for k, v in snaps.items()}
    runs["grid"]["log"] = text
    runs["grid"]["state"] = torch.load(os.path.join(snaps["grid"], "adapt_state.pt"),
                                       weights_only=False)
    runs["one"]["adapter"] = one
    runs["one"]["state"] = torch.load(os.path.join(snaps["one"], "adapt_state.pt"),
                                      weights_only=False)
    shutil.rmtree(snaps["one"], ignore_errors=True)
    resumed = _cfg(tmp / "resume.yml", root, snaps["grid"], TENSOR_PARALLEL=TP,
                   AUTO_RESUME=True)
    runs["resumed_log"] = _finish(*_torchrun(resumed, tmp / "resume.log"))
    runs["resumed_records"] = _records(snaps["grid"])
    return runs


def _steps(records):
    return [r for r in records if "Total target loss" in r]


def test_grid_cli_runs_with_one_writer(cli_runs):
    """Exit 0 under torchrun with OTHERS.TENSOR_PARALLEL 2; every step of both
    domains ran with finite losses, one metrics record a step as one process
    writes them; the files are one process's, written once, no temporary
    left."""
    grid, one = cli_runs["grid"], cli_runs["one"]
    steps = _steps(grid["records"])
    assert len(steps) == len(_steps(one["records"])) == 2 * PER_DOMAIN // BATCH
    assert len(grid["records"]) == len(one["records"])
    for r in steps:
        for key in LOSSES:
            assert math.isfinite(r[key]), key
    assert grid["files"] == one["files"]
    assert {"adapt_state.pt", "metrics.jsonl", "proto_current.pickle", "proto_(25,).pickle",
            "proto_(50,).pickle", "model_train_[[0]]_after_src_training.pth"} <= set(grid["files"])
    assert not [f for f in grid["files"] if f.startswith(".")]
    assert set().union(*grid["records"]) == set().union(*one["records"])


def test_grid_file_is_one_process_layout_and_loads_into_one_process(cli_runs):
    """The grid's `adapt_state.pt` holds the whole tensors, its keys and
    shapes those of one process's file; one process's adapter loads it and
    then holds its tensors bit for bit."""
    saved, want = cli_runs["grid"]["state"], cli_runs["one"]["state"]
    assert set(saved) == set(want)
    for tree, d in want.items():
        if isinstance(d, dict) and tree not in ("proto", "monitor", "switch"):
            assert {k: tuple(v.shape) for k, v in saved[tree].items()} == {
                k: tuple(v.shape) for k, v in d.items()}, tree
    ad = cli_runs["one"]["adapter"]
    ad.load_model(None, {k: (dict(v) if isinstance(v, dict) else v) for k, v in saved.items()})
    for tree in ("params", "batch_stats", "opt_momentum", "ema_params", "static_params",
                 "dynamic_params"):
        for k, v in saved[tree].items():
            assert torch.equal(getattr(ad.state, tree)[k], v), (tree, k)
    assert torch.equal(ad.state.proto.mean, saved["proto"]["mean"])


def test_grid_auto_resume_restores_on_both_ranks(cli_runs):
    """An AUTO_RESUME rerun of the grid restores the grid's own file on both
    ranks (each printed it: ranks may share a line) and runs on."""
    text = cli_runs["resumed_log"]
    assert len(re.findall(r"AUTO_RESUME: restoring \S*adapt_state\.pt", text)) == TP, text[-3000:]
    assert len(_steps(cli_runs["resumed_records"])) == 2 * len(_steps(cli_runs["grid"]["records"]))


# ---------------------------------------------------------------------------
# advent.yml and its EVALUATION on the grid
# ---------------------------------------------------------------------------

def _advent_cfg(path, config, root, snap, **spec):
    """configs/<config>.yml (advent, validation_offline_advent) cut to the
    synthetic dataset as the CLI tests cut it, on a (1 × 2) grid."""
    with open(os.path.join(ROOT, "configs", f"{config}.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["SCHEME"].update(PATH=root + "/", RESOLUTION=[64, 32], DOMAIN_ORDER=[[25], [50]])
    cfg["TRAINING"].update(BATCH_SIZE=BATCH, REPLAY_BUFFER=PER_DOMAIN)
    cfg["OTHERS"].update(SNAPSHOT_DIR=snap, NUM_WORKERS=2, TENSOR_PARALLEL=TP)
    cfg["MODEL"]["LOAD"] = None
    cfg["METHOD"]["ADAPTATION"][cfg["METHOD"]["ADAPTATION"]["NAME"]].update(
        EPOCHS=1, LOAD_PROTO=None, **spec)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


@pytest.fixture(scope="module")
def advent_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_advent_cli")
    try:
        yield _advent_runs(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _advent_runs(tmp):
    """advent.yml on the grid; then validation_offline_advent.yml on its
    snapshot on the grid and, meanwhile, in one process (without the
    option)."""
    root, snap = str(tmp / "ds"), str(tmp / "snap")
    make_synthetic_dataset(root, intensities=(0, 25, 50), per_domain=PER_DOMAIN,
                           size_wh=(64, 32))
    text = _finish(*_torchrun(_advent_cfg(tmp / "advent.yml", "advent", root, snap),
                              tmp / "advent.log"))
    runs = {"log": text, "records": _records(snap), "files": sorted(os.listdir(snap)),
            "state": torch.load(os.path.join(snap, "advent_state.pt"), weights_only=False)}
    n = len(runs["records"])
    proc, log = _torchrun(_advent_cfg(tmp / "eval.yml", "validation_offline_advent", root, snap,
                                      PSEUDO_THRESH=0.06), tmp / "eval.log")
    one_snap = str(tmp / "one_snap")
    shutil.copytree(snap, one_snap, ignore=shutil.ignore_patterns("metrics.jsonl"))
    one_cfg = _advent_cfg(tmp / "one_eval.yml", "validation_offline_advent", root, one_snap,
                          PSEUDO_THRESH=0.06)
    with open(one_cfg) as f:
        cfg = yaml.safe_load(f)
    cfg["OTHERS"].pop("TENSOR_PARALLEL")
    with open(one_cfg, "w") as f:
        yaml.safe_dump(cfg, f)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.MonkeyPatch.context() as mp:
        mp.setitem(registry.LAYERS, "DeepLabv2-Resnet50", (1, 1, 1, 1))
        one = train_ouda.main(["--cfg", one_cfg, "--device", "cpu"])
    runs["eval_log"] = _finish(proc, log)
    runs["eval_records"] = _records(snap)[n:]
    runs["one_eval_log"], runs["one_eval_records"] = out.getvalue(), _records(one_snap)
    runs["one_shapes"] = {k: tuple(v.shape) for k, v in one.state.params.items()}
    return runs


def test_advent_on_the_grid_writes_one_process_files(advent_runs):
    """advent.yml under torchrun with OTHERS.TENSOR_PARALLEL 2: exit 0, every
    step of both domains once in metrics.jsonl with finite losses (one
    writer), the files written once and no temporary left; `advent_state.pt`
    holds the whole tensors (the student's as one process's model, both
    discriminators' sharded convs and Adam moments at full width) and the
    step and Adam counts of every step."""
    steps = [r for r in advent_runs["records"] if "Adversarial loss" in r]
    assert len(steps) == 2 * PER_DOMAIN // BATCH
    for r in steps:
        for key, value in r.items():
            assert "loss" not in key or math.isfinite(value), key
    assert advent_runs["files"] == ["advent_state.pt", "metrics.jsonl",
                                    "model_train_[[0]]_after_src_training.pth", "samples"]
    state = advent_runs["state"]
    assert {k: tuple(v.shape) for k, v in state["params"].items()} == advent_runs["one_shapes"]
    for tree in ("d_main", "d_aux"):
        assert tuple(state[tree]["conv3.weight"].shape) == (512, 256, 4, 4)
        assert tuple(state[f"{tree}_opt"]["nu"]["conv1.weight"].shape) == (128, 64, 4, 4)
        assert state[f"{tree}_opt"]["count"] == len(steps)
    assert state["step"] == len(steps)


def test_advent_evaluation_on_the_grid_matches_one_process(advent_runs):
    """validation_offline_advent.yml on the grid's snapshot, on the grid: both
    ranks load `advent_state.pt` (cut into their shards), and every `Val
    mIoU*` it logs equals one process's EVALUATION of the same file."""
    loaded = re.findall(r"Model \S*advent_state\.pt is being loaded", advent_runs["eval_log"])
    assert len(loaded) == TP, advent_runs["eval_log"][-3000:]
    assert "advent_state.pt is being loaded" in advent_runs["one_eval_log"]

    def miou(records):
        return {k: v for r in records for k, v in r.items() if k.startswith("Val mIoU")}

    got, want = miou(advent_runs["eval_records"]), miou(advent_runs["one_eval_records"])
    assert want and got == want
