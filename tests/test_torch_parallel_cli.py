"""The port's CLI under `python -m torch.distributed.run --nproc-per-node 2`
(tests/torch_parallel_worker.py cli: `onda_torch.train_ouda.main` with the
R50 cut to one bottleneck a stage) for every family beyond PROTO_ONLINE, on
the CPU with gloo, each beside the one-process CLI on the same files:

* advent.yml (ADVENT, multi-level) at the CLI tests' cuts (64×32, global
  batch 2, two target domains of one epoch);
* training_fog.yml with SEGMENT EPOCHS 1 and ORIGINAL_RES, then its
  adaptation, on a fog table;
* validation_offline_fog.yml (EVALUATION) on the one-process SEGMENT run's
  snapshots, the ranks and then one process.

Each run's metrics keys and record count are the one-process run's, rank 0
alone writes (one metrics record each, the files written once, no hidden
temporary left), and the EVALUATION's `Val mIoU*` values are one process's.
"""

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
from .torch_parallel_worker import ROOT

WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
WORLD, BATCH, PER_DOMAIN = 2, 2, 4
DEADLINE = 300  # seconds for a torchrun; a hang fails the test


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _cfg(path, config, root, snap, **over):
    """configs/<config>.yml cut to the synthetic dataset at 64×32."""
    with open(os.path.join(ROOT, "configs", f"{config}.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["SCHEME"].update(PATH=root + "/", RESOLUTION=[64, 32])
    cfg["TRAINING"].update(BATCH_SIZE=BATCH, REPLAY_BUFFER=PER_DOMAIN)
    cfg["OTHERS"].update(SNAPSHOT_DIR=snap, NUM_WORKERS=2)
    cfg["MODEL"]["LOAD"] = None
    spec = cfg["METHOD"]["ADAPTATION"][cfg["METHOD"]["ADAPTATION"]["NAME"]]
    spec.update(EPOCHS=1, LOAD_PROTO=None, PSEUDO_THRESH=0.06)
    for key, value in over.items():
        node = cfg
        *parents, last = key.split(".")
        for name in parents:
            node = node[name]
        node[last] = value
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _torchrun(cfg_path, log_path):
    """The CLI on `cfg_path` under torch.distributed.run, two ranks."""
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "2"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(WORLD), WORKER, "cli", "--cfg", cfg_path, "--device", "cpu"]
    log = open(log_path, "w+")
    return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, cwd=ROOT, env=env,
                            start_new_session=True), log


def _finish(started):
    proc, log = started
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


def _one(cfg_path):
    with contextlib.redirect_stdout(io.StringIO()) as out, pytest.MonkeyPatch.context() as mp:
        mp.setitem(registry.LAYERS, "DeepLabv2-Resnet50", (1, 1, 1, 1))
        train_ouda.main(["--cfg", cfg_path, "--device", "cpu"])
    return out.getvalue()


def _records(snap, skip=0):
    with open(os.path.join(snap, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f][skip:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each family under torchrun, the one-process CLI meanwhile; the
    EVALUATION of the one-process SEGMENT run's snapshots by the ranks, then
    by one process."""
    tmp = tmp_path_factory.mktemp("cli_families")
    root = str(tmp / "ds")
    make_synthetic_dataset(root, intensities=(0, 25, 50), per_domain=PER_DOMAIN,
                           size_wh=(128, 64))
    shutil.copy(os.path.join(root, "metadata.json"), os.path.join(root, "metadata_fog.json"))
    families = {
        "advent": ("advent", {"SCHEME.DOMAIN_ORDER": [[25], [50]]}),
        "segment": ("training_fog", {"SCHEME.DOMAIN_ORDER": [[25]],
                                     "SCHEME.ORIGINAL_RES": [128, 64],
                                     "METHOD.PRETRAIN.SEGMENT.EPOCHS": 1}),
    }
    out = {}
    for name, (config, over) in families.items():
        snaps = {who: str(tmp / f"{name}_{who}") for who in ("ranks", "one")}
        started = _torchrun(_cfg(tmp / f"{name}_ranks.yml", config, root, snaps["ranks"], **over),
                            tmp / f"{name}_ranks.log")
        try:
            _one(_cfg(tmp / f"{name}_one.yml", config, root, snaps["one"], **over))
        finally:
            text = _finish(started)
        out[name] = {who: {"records": _records(snap), "files": sorted(os.listdir(snap))}
                     for who, snap in snaps.items()}
        out[name]["ranks"]["log"] = text
    # EVALUATION of the one-process SEGMENT run's snapshots: the ranks first
    snap = str(tmp / "segment_one")
    n = len(_records(snap))
    cfg_path = _cfg(tmp / "evaluation.yml", "validation_offline_fog", root, snap,
                    **{"SCHEME.DOMAIN_ORDER": [[25]]})
    text = _finish(_torchrun(cfg_path, tmp / "evaluation_ranks.log"))
    m = len(_records(snap))
    one_text = _one(cfg_path)
    out["evaluation"] = {"ranks": {"records": _records(snap, n)[:m - n], "log": text},
                         "one": {"records": _records(snap, m), "log": one_text}}
    yield out
    shutil.rmtree(tmp, ignore_errors=True)  # the runs' checkpoints: several GB


def _keys(records):
    return set().union(*records)


@pytest.mark.parametrize("name", ["advent", "segment"])
def test_two_ranks_run_the_family_with_one_writer(runs, name):
    """The ranks' metrics keys and record count are the one-process run's,
    every loss finite; the same files, written once, no temporary left."""
    ranks, one = runs[name]["ranks"], runs[name]["one"]
    assert _keys(ranks["records"]) == _keys(one["records"])
    assert len(ranks["records"]) == len(one["records"])
    for r in ranks["records"]:
        for key, value in r.items():
            assert "loss" not in key or math.isfinite(value), (name, key)
    assert ranks["files"] == one["files"]
    assert not [f for f in ranks["files"] if f.startswith(".")]
    if name == "advent":
        assert {"advent_state.pt", "metrics.jsonl", "samples",
                "model_train_[[0]]_after_src_training.pth"} == set(ranks["files"])
        steps = [r for r in ranks["records"] if "Adversarial loss" in r]
        assert len(steps) == 2 * PER_DOMAIN // BATCH
    else:
        assert {"model_train_[[0]].pth", "model_train_[[0]]_after_src_training.pth",
                "adapt_state.pt"} <= set(ranks["files"])
        assert len([r for r in ranks["records"] if "Segmentation loss" in r]) == 1
        epoch = [r for r in ranks["records"] if "epoch" in r]
        assert len(epoch) == 1 and "Val mIoU full image of (0,)" in epoch[0]


def test_two_rank_evaluation_is_one_process_evaluation(runs):
    """EVALUATION under two ranks loads the same snapshot (both ranks say
    so) and logs one process's `Val mIoU*` values on the same files."""
    ranks, one = runs["evaluation"]["ranks"], runs["evaluation"]["one"]
    # the ranks' lines may share a line of the joined output: matched, not split
    loaded = re.findall(r"Model (\S+) is being loaded", ranks["log"])
    want = re.findall(r"Model (\S+) is being loaded", one["log"])
    assert len(want) == 1 and loaded == want * WORLD
    got = {k: v for r in ranks["records"] for k, v in r.items() if k.startswith("Val mIoU")}
    expected = {k: v for r in one["records"] for k, v in r.items() if k.startswith("Val mIoU")}
    assert got and got == expected
    assert _keys(ranks["records"]) == _keys(one["records"])
