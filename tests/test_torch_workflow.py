"""The port's CLI through the workflow of the fog configs on the CPU:
training_fog.yml (SEGMENT pretraining, then adaptation), then EVALUATION of
its snapshots (validation_offline_fog.yml), a sweep over them
(OTHERS.EVAL_SWEEP) and PREDICTION_SAVE dumps (validation.yml), on a
synthetic fog dataset (`tests/synthetic.py`) at 64x32."""

import math
import os
import shutil

import pytest
import torch
import yaml

from onda_torch.models import build_deeplab_v2

from .synthetic import make_synthetic_dataset
from .test_torch_cli import BATCH, PER_DOMAIN, STEPS, _main, _records, _steps


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Torch on two threads in this file: the test run's workers share the
    host's cores, and one torch thread per core in each oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """The `.pt`, `.pth` and prototype pickles a test writes (up to 1.2 GB
    each) go when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


WORKFLOW_SETS = ("(0,)", "(25,)")


def _workflow_cfg(path, config, root, snap, **over):
    """`config` cut to the synthetic fog dataset at 64x32 (files at 128x64)."""
    with open(config) as f:
        cfg = yaml.safe_load(f)
    cfg["SCHEME"].update(PATH=root + "/", RESOLUTION=[64, 32], DOMAIN_ORDER=[[25]])
    cfg["TRAINING"].update(BATCH_SIZE=BATCH, REPLAY_BUFFER=4)
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


@pytest.fixture(scope="module")
def workflow(tmp_path_factory):
    """training_fog.yml (SEGMENT for one epoch, then adaptation) with
    ORIGINAL_RES, then validation_offline_fog.yml (EVALUATION), the same with
    OTHERS.EVAL_SWEEP, and validation.yml (PREDICTION_SAVE) on its snapshots."""
    tmp = tmp_path_factory.mktemp("workflow")
    root, snap = str(tmp / "ds"), str(tmp / "snaps")
    make_synthetic_dataset(root, intensities=(0, 25), per_domain=PER_DOMAIN, size_wh=(128, 64))
    os.rename(os.path.join(root, "metadata.json"), os.path.join(root, "metadata_fog.json"))
    out = {"snap": snap, "preds": str(tmp / "preds")}
    runs = [
        ("segment", "configs/training_fog.yml",
         {"METHOD.PRETRAIN.SEGMENT.EPOCHS": 1, "SCHEME.ORIGINAL_RES": [128, 64]}),
        ("evaluation", "configs/validation_offline_fog.yml", {}),
        ("sweep", "configs/validation_offline_fog.yml", {"OTHERS.EVAL_SWEEP": True}),
        ("predictions", "configs/validation.yml",
         {"METHOD.PRETRAIN.EVALUATION.PREDICTION_SAVE": out["preds"]}),
    ]
    n = 0
    for name, config, over in runs:
        result, text = _main(_workflow_cfg(tmp / f"{name}.yml", config, root, snap, **over))
        records = _records(snap)
        out[name] = {"result": result, "out": text, "records": records[n:]}
        n = len(records)
    yield out
    shutil.rmtree(tmp, ignore_errors=True)  # the runs' checkpoints: over 1 GB


def _keys(records):
    return set().union(*records) - {"_step", "_t"}


def test_segment_run_logs_the_jax_cli_keys(workflow):
    records = workflow["segment"]["records"]
    seg = [r for r in records if "Segmentation loss" in r]
    assert len(seg) == 1 and math.isfinite(seg[0]["Segmentation loss"])  # step 0 of 2
    assert set(seg[0]) - {"_step", "_t"} == {"Segmentation loss", "learning_rate"}
    epoch = [r for r in records if "epoch" in r]
    want = {"epoch"} | {f"{k} of {s}" for s in WORKFLOW_SETS for k in (
        "Val mIoU", "Val std IoU", "val entropy", "Val mIoU full image")}
    assert len(epoch) == 1 and set(epoch[0]) - {"_step", "_t"} == want
    assert all(math.isfinite(v) for k, v in epoch[0].items() if k.startswith(("Val", "val")))
    # then the adaptation ran from the trained weights
    steps = _steps(records)
    assert len(steps) == STEPS and all(math.isfinite(r["Total target loss"]) for r in steps)


def test_segment_weights_are_saved_and_adapted_from(workflow):
    snap = workflow["snap"]
    trained = torch.load(os.path.join(snap, "model_train_[[0]].pth"))
    after = torch.load(os.path.join(snap, "model_train_[[0]]_after_src_training.pth"))
    adapter = workflow["segment"]["result"]
    assert list(after) == list(adapter.model.state_dict())
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        fresh = build_deeplab_v2(19, (3, 4, 6, 3), "ProDA", multi_level=True)
    key = "layer6.head.1.weight"
    assert not torch.equal(after[key], fresh.state_dict()[key])  # SEGMENT moved it
    for k, value in after.items():
        torch.testing.assert_close(trained[k], value, rtol=0, atol=0, msg=k)
        # the static teacher is the adaptation's starting point
        start = adapter.state.static_params.get(k, adapter.state.static_batch_stats.get(k))
        torch.testing.assert_close(start, value, rtol=0, atol=0, msg=k)


def test_evaluation_loads_the_adaptation_snapshot(workflow):
    run = workflow["evaluation"]
    assert f"Model {os.path.join(workflow['snap'], 'adapt_state.pt')} is being loaded" in run["out"]
    assert run["result"].state.step == STEPS
    want = {f"Val {k} {p} of {s}" for s in WORKFLOW_SETS for k in ("mIoU", "std IoU")
            for p in ("model", "proto")}
    assert _keys(run["records"]) == want
    assert all(math.isfinite(v) for r in run["records"] for k, v in r.items() if k in want)


def test_eval_sweep_evaluates_every_compatible_file(workflow):
    run = workflow["sweep"]
    names = ["model_train_[[0]].pth", "model_train_[[0]]_after_src_training.pth", "adapt_state.pt"]
    # oldest first; the JSONL sink keeps numbers only, so the names are read
    # from the output
    swept = [line.split()[1] for line in run["out"].splitlines() if line.startswith("sweep: ")]
    assert swept == names
    assert len([r for r in run["records"] if "Swept mIoU" in r]) == len(names)
    best = [line for line in run["out"].splitlines() if line.startswith("best: ")]
    assert len(best) == 1 and best[0].split()[1] in names
    assert set(run["records"][-1]) - {"_step", "_t"} == {"Best mIoU"}


def test_prediction_save_dumps_every_target_batch(workflow):
    run = workflow["predictions"]
    base = os.path.join(workflow["preds"], "_".join(str((25,))))
    assert sorted(os.listdir(base)) == [f"batch-{i}.pt" for i in range(STEPS)]
    for i in range(STEPS):
        logits = torch.load(os.path.join(base, f"batch-{i}.pt"))
        assert logits.shape == (BATCH, 19, 32 // 8 + 1, 64 // 8 + 1)
        assert torch.isfinite(logits).all()
    assert _keys(run["records"]) == {"Prediction confidence", "Progress"}
    assert [r["Progress"] for r in run["records"]] == [100.0 * i / STEPS for i in range(STEPS)]


@pytest.mark.slow
def test_workflow_keys_match_the_jax_cli(tmp_path, monkeypatch, workflow):
    """The JAX CLI on the same four runs and dataset: each run logs the same
    metrics keys as the port's. Slow: XLA:CPU compiles the JAX steps."""
    import sys

    root = str(tmp_path / "ds")
    make_synthetic_dataset(root, intensities=(0, 25), per_domain=PER_DOMAIN, size_wh=(128, 64))
    os.rename(os.path.join(root, "metadata.json"), os.path.join(root, "metadata_fog.json"))
    snap = str(tmp_path / "snaps")
    runs = [
        ("segment", "configs/training_fog.yml",
         {"METHOD.PRETRAIN.SEGMENT.EPOCHS": 1, "SCHEME.ORIGINAL_RES": [128, 64]}),
        ("evaluation", "configs/validation_offline_fog.yml", {}),
        ("sweep", "configs/validation_offline_fog.yml", {"OTHERS.EVAL_SWEEP": True}),
        ("predictions", "configs/validation.yml",
         {"METHOD.PRETRAIN.EVALUATION.PREDICTION_SAVE": str(tmp_path / "preds")}),
    ]
    sys.path.insert(0, os.getcwd())
    import train_ouda as jax_cli

    n = 0
    for name, config, over in runs:
        cfg = _workflow_cfg(tmp_path / f"{name}.yml", config, root, snap,
                            **{"OTHERS.DATA_PARALLEL": False}, **over)
        monkeypatch.setattr(sys, "argv", ["train_ouda.py", f"--cfg={cfg}"])
        jax_cli.main()
        records = _records(snap)
        assert _keys(records[n:]) == _keys(workflow[name]["records"]), name
        n = len(records)
    base = os.path.join(str(tmp_path / "preds"), "_".join(str((25,))))
    assert sorted(os.listdir(base)) == [f"batch-{i}.pt" for i in range(STEPS)]
