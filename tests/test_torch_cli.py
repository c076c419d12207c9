"""The port's CLI, `python -m onda_torch.train_ouda`, end to end on the CPU: the
flagship config on a 64x32 synthetic dataset (`tests/synthetic.py`) with two
target domains, the second with a DOMAIN_OPTIONS override, then an
AUTO_RESUME rerun with a dynamic replay buffer; and the adversarial configs,
advent.yml and proto_advent.yml."""

import contextlib
import io
import json
import math
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from onda_torch import train_ouda
from onda_torch.config import cfg_from_file
from onda_torch.methods.proto_online import ProtoOnlineAdapter
from onda_torch.models import build_deeplab_v2
from onda_torch.registry import variables_of

from .synthetic import make_synthetic_dataset

PER_DOMAIN, BATCH = 4, 2
STEPS = PER_DOMAIN // BATCH  # per domain, one epoch


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """The `.pt`, `.pth` and prototype pickles a test writes (up to 1.2 GB
    each) go when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _write_cfg(path, root, snap, **over):
    with open("configs/hybrid_switch.yml") as f:
        cfg = yaml.safe_load(f)
    cfg["SCHEME"].update(PATH=root + "/", RESOLUTION=[64, 32], DOMAIN_ORDER=[[25], [50]])
    cfg["TRAINING"].update(BATCH_SIZE=BATCH)
    cfg["OTHERS"].update(SNAPSHOT_DIR=snap, NUM_WORKERS=2, SCHEDULE=True)
    cfg["MODEL"]["LOAD"] = None
    spec = cfg["METHOD"]["ADAPTATION"]["PROTO_ONLINE_HYBRIDSWITCH"]
    spec.update(EPOCHS=1, LOAD_PROTO=None, PSEUDO_THRESH=0.06)  # random weights: keep some labels
    for key, value in over.items():
        section, name = key.split(".")
        cfg[section][name] = value
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _main(cfg_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        adapter = train_ouda.main(["--cfg", cfg_path, "--device", "cpu"])
    return adapter, out.getvalue()


def _records(snap):
    with open(os.path.join(snap, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    root, snap = str(tmp / "ds"), str(tmp / "snaps")
    make_synthetic_dataset(root, intensities=(0, 25, 50), per_domain=PER_DOMAIN, size_wh=(64, 32))
    # the second domain: no pixel reaches a threshold above 1, and twice the LR
    options = {"(50,)": {"PSEUDO_THRESH": 1.01, "LEARNING_RATE": 2e-5}}
    first, out1 = _main(_write_cfg(tmp / "run1.yml", root, snap, **{"SCHEME.DOMAIN_OPTIONS": options}))
    n1 = len(_records(snap))
    second, out2 = _main(_write_cfg(
        tmp / "run2.yml", root, snap, **{"SCHEME.DOMAIN_ORDER": [[25]], "OTHERS.AUTO_RESUME": True,
                                         "TRAINING.BUFFER_DYNAMIC": True,
                                         "TRAINING.PERC_FILL_PER_DOMAIN": 1.0}))
    records = _records(snap)
    yield {"snap": snap, "run1": records[:n1], "run2": records[n1:], "out1": out1, "out2": out2,
           "first": first, "second": second}
    shutil.rmtree(tmp, ignore_errors=True)  # the runs' checkpoints: over 1 GB


def _steps(records):
    return [r for r in records if "Total target loss" in r]


def test_step_records_hold_the_step_and_host_keys(runs):
    steps = _steps(runs["run1"])
    assert len(steps) == 2 * STEPS
    want = {"ce_loss", "rce_loss", "sym_loss", "regularization_loss", "Total target loss",
            "buff_ce_loss", "pseudolabel_pixel_num", "encoder_lr", "dynamic forward fired",
            "prior static confidence ma", "dev avg prior static", "Total buffer updates",
            "time/Batch Fetch", "time/Step Dispatch", "time/Host Work", "time/Log Sync",
            "_step", "_t"}
    for r in steps:
        assert want <= set(r), sorted(want - set(r))
    assert "Step compile+run seconds" in steps[0]
    keys = set().union(*runs["run1"])
    for val_set in ("(0,)", "(25,)", "(50,)"):
        assert f"Val mIoU model of {val_set}" in keys and f"Val std IoU model of {val_set}" in keys
        assert f"Condition {val_set} sample 0" in keys
    assert "Adaptation frames per second" in keys


def test_step0_losses_are_finite(runs):
    step0 = _steps(runs["run1"])[0]
    for key in ("ce_loss", "rce_loss", "regularization_loss", "buff_ce_loss", "Total target loss"):
        assert math.isfinite(step0[key]), key
    assert step0["pseudolabel_pixel_num"] > 0


def test_files_written(runs):
    files = set(os.listdir(runs["snap"]))
    assert {"adapt_state.pt", "metrics.jsonl", "proto_current.pickle", "proto_(25,).pickle",
            "proto_(50,).pickle", "model_train_[[0]]_after_src_training.pth"} <= files
    assert not [f for f in files if f.startswith(".")]  # no checkpoint left half-written
    samples = os.listdir(os.path.join(runs["snap"], "samples"))
    # 4 frames of each validation set at the end of each domain's epoch: 3 sets
    # for the two domains of the first run, 2 (source and 25) for the second
    assert len(samples) == PER_DOMAIN * (3 + 3 + 2)
    sd = torch.load(os.path.join(runs["snap"], "model_train_[[0]]_after_src_training.pth"))
    assert set(sd) == set(runs["first"].model.state_dict())


def test_domain_override_reached_the_step(runs):
    steps = _steps(runs["run1"])
    first, second = steps[:STEPS], steps[STEPS:]
    assert all(r["pseudolabel_pixel_num"] > 0 for r in first)
    assert all(r["pseudolabel_pixel_num"] == 0 for r in second)  # PSEUDO_THRESH 1.01
    for r in first:
        assert r["encoder_lr"] == pytest.approx(80 * 1e-5, rel=1e-6)  # LR_RATIO 80:10
    for r in second:
        assert r["encoder_lr"] == pytest.approx(80 * 2e-5, rel=1e-6)
    assert runs["out1"].count("Computing Prototypes") == 1  # SKIP_CALC |= f_domain


def test_resumed_run_inserts_into_the_buffer(runs):
    assert "AUTO_RESUME: restoring" in runs["out2"]
    assert "Computing Prototypes" not in runs["out2"]
    assert "Buffer size:" in runs["out2"]
    steps = _steps(runs["run2"])
    assert len(steps) == STEPS
    assert sum(r["Total buffer updates"] for r in steps) == STEPS * BATCH  # probability > 1
    assert all(math.isfinite(r["Total target loss"]) for r in steps)
    # the resumed state went on from the first run's last step
    assert runs["second"].state.step == 3 * STEPS


def test_steps_record_the_loop_and_stage_spans(runs):
    """Under OTHERS.SCHEDULE every step of the first run holds the loop's
    phases and the hybrid step's stages, each under its parent, and two host
    reads (the gate's decision, the packed logs); the resumed run's steps
    insert both frames into the replay buffer, three reads more. On the CPU
    no stage has a device time."""
    parents = {"fetch": "step", "dispatch": "step", "host_work": "step", "log_sync": "step",
               "log": "step", "teachers": "dispatch", "ema_forward": "teachers",
               "static_forward": "teachers", "gate": "teachers", "k1_prototypes": "teachers",
               "student": "dispatch", "update": "dispatch"}
    steps = runs["first"].spans.steps()
    assert [step[0].step for step in steps] == [0, 1] * 2  # each domain's loop counts from 0
    for step in steps:
        assert step[0].name == "step" and step[0].parent is None
        assert {s.name: s.parent.name for s in step[1:] if s.name != "sync"} == parents
        assert [s.parent.name for s in step if s.name == "sync"] == ["gate", "log_sync"]
        assert all(s.device_ms is None for s in step)
    for r in _steps(runs["run1"]):
        assert r["host reads"] == 2 and not [k for k in r if k.endswith(" device")]
    assert [r["host reads"] for r in _steps(runs["run2"])] == [2 + 3] * STEPS
    resumed = runs["second"].spans.steps()
    assert [[s.parent.name for s in step if s.name == "sync"] for step in resumed] \
        == [["gate", "host_work", "host_work", "host_work", "log_sync"]] * STEPS


def test_cuda_device_without_a_card_stops(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_ouda.main(["--cfg", "configs/hybrid_switch.yml"])


ADVERSARIAL = {"advent": "ADVENT", "proto_advent": "PROTO_ADVENT"}
ADVERSARIAL_SETS = ("(0,)", "(25,)", "(50,)")


def _adversarial_cfg(path, name, root, snap):
    """configs/<name>.yml cut to the synthetic dataset: 64x32, b2, two target
    domains, one epoch each, no checkpoint or prototype files."""
    with open(f"configs/{name}.yml") as f:
        cfg = yaml.safe_load(f)
    cfg["SCHEME"].update(PATH=root + "/", RESOLUTION=[64, 32], DOMAIN_ORDER=[[25], [50]])
    cfg["TRAINING"].update(BATCH_SIZE=BATCH, REPLAY_BUFFER=PER_DOMAIN)
    cfg["OTHERS"].update(SNAPSHOT_DIR=snap, NUM_WORKERS=2)
    cfg["MODEL"]["LOAD"] = None
    cfg["METHOD"]["ADAPTATION"][ADVERSARIAL[name]].update(EPOCHS=1, LOAD_PROTO=None,
                                                          PSEUDO_THRESH=0.06)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def adversarial_keys(name):
    """The metrics.jsonl keys the JAX CLI writes for the cut config: each
    step's logs (advent.py:240-244, proto_advent.py:255-263), the student's
    evaluation of every validation set and its samples, the logger's own."""
    step = {"Discriminator loss", "Segmentation loss", "Adversarial loss"}
    if name == "proto_advent":
        from onda_torch.methods.proto_online import MONITOR_KEYS

        step |= {"ce_loss", "rce_loss", "sym_loss", "regularization_loss", "JS Divergance loss",
                 "Total target loss", "pseudolabel_pixel_num", "mean_prototype_intensity_values",
                 "dev avg prior static"} | {f"{k} confidence ma" for k in MONITOR_KEYS}
    sets = {f"{k} model of {s}" for s in ADVERSARIAL_SETS for k in ("Val mIoU", "Val std IoU")}
    samples = {f"Condition {s} sample {i}" for s in ADVERSARIAL_SETS for i in range(PER_DOMAIN)}
    return step | sets | samples | {"_step", "_t"}


@pytest.mark.parametrize("name", list(ADVERSARIAL))
def test_adversarial_config_runs_through_the_cli(tmp_path, name):
    """advent.yml (multi-level) and proto_advent.yml through the CLI: finite
    losses every step, the JAX CLI's metrics keys, the files written; ADVENT
    checkpoints both discriminators and their Adam states, PROTO_ADVENT only
    its AdaptState."""
    root, snap = str(tmp_path / "ds"), str(tmp_path / "snaps")
    make_synthetic_dataset(root, intensities=(0, 25, 50), per_domain=PER_DOMAIN, size_wh=(64, 32))
    adapter, out = _main(_adversarial_cfg(tmp_path / "cfg.yml", name, root, snap))
    records = _records(snap)
    steps = [r for r in records if "Adversarial loss" in r]
    assert len(steps) == 2 * STEPS
    for r in steps:
        for key, value in r.items():
            assert "loss" not in key or math.isfinite(value), (r["_step"], key)
    assert set().union(*records) == adversarial_keys(name)
    files = set(os.listdir(snap))
    assert not [f for f in files if f.startswith(".")]
    assert {"metrics.jsonl", "model_train_[[0]]_after_src_training.pth", "samples"} <= files
    if name == "advent":
        assert adapter.cfg.MODEL.MULTI_LEVEL
        assert files == {"advent_state.pt", "metrics.jsonl", "samples",
                         "model_train_[[0]]_after_src_training.pth"}
        state = torch.load(os.path.join(snap, "advent_state.pt"), weights_only=False)
        assert {"params", "batch_stats", "opt_momentum", "d_aux", "d_main", "generator",
                "step"} <= set(state)
        assert state["step"] == 2 * STEPS
        assert state["d_main_opt"]["count"] == state["d_aux_opt"]["count"] == 2 * STEPS
    else:
        assert out.count("Computing Prototypes") == 1
        assert {"adapt_state.pt", "proto_current.pickle", "proto_(25,).pickle",
                "proto_(50,).pickle"} <= files
        assert "d_main" not in torch.load(os.path.join(snap, "adapt_state.pt"), weights_only=False)
        assert adapter.d_state["main_opt"]["count"] == 2 * STEPS
        assert all(r["pseudolabel_pixel_num"] > 0 for r in steps)
    shutil.rmtree(tmp_path, ignore_errors=True)  # the checkpoints: about 1 GB


def test_update_cfg_spec_drops_built_steps_only_when_the_step_changes(tmp_path):
    cfg = cfg_from_file("configs/hybrid_switch.yml")
    cfg.OTHERS.SNAPSHOT_DIR = str(tmp_path)
    spec = cfg.METHOD.ADAPTATION.PROTO_ONLINE_HYBRIDSWITCH
    spec.LOAD_PROTO = None
    model = build_deeplab_v2(19, (1, 1, 1, 1), "ProDA", droprate=0.0)
    ad = ProtoOnlineAdapter(model, variables_of(model), cfg, spec, 19, device="cpu")
    step = ad.step_fn(True, 1, False)
    spec.set_, spec.SKIP_CALC, spec.EPOCHS = (25,), True, 7  # host-only keys
    ad.update_cfg_spec(spec)
    assert ad.step_fn(True, 1, False) is step
    spec.PSEUDO_THRESH = 0.9
    ad.update_cfg_spec(spec)
    assert ad.step_fn(True, 1, False) is not step
    np.testing.assert_equal(ad._applied_spec["PSEUDO_THRESH"], 0.9)


@pytest.mark.slow
def test_cli_step0_matches_the_jax_cli(tmp_path, monkeypatch):
    """Both CLIs on the same dataset, from the same weights (a .pth of the
    port's model, which the JAX package imports), with the ProDA head's
    Dropout2d off on both sides: step-0 losses and pseudo-label counts within
    rtol 1e-4, and the same metrics keys. Slow: XLA:CPU compiles the JAX step."""
    import functools
    import sys

    import onda_tpu.models
    import onda_torch.models

    root = str(tmp_path / "ds")
    make_synthetic_dataset(root, intensities=(0, 25), per_domain=PER_DOMAIN, size_wh=(64, 32))
    for pkg in (onda_tpu.models, onda_torch.models):
        monkeypatch.setattr(pkg, "build_deeplab_v2",
                            functools.partial(pkg.build_deeplab_v2, droprate=0.0))
    model = onda_torch.models.build_deeplab_v2(19, (3, 4, 6, 3), "ProDA")
    pth = str(tmp_path / "weights.pth")
    torch.save(model.state_dict(), pth)
    records = {}
    for name in ("jax", "torch"):
        snap = str(tmp_path / f"snaps_{name}")
        cfg = _write_cfg(tmp_path / f"{name}.yml", root, snap, **{"SCHEME.DOMAIN_ORDER": [[25]]})
        with open(cfg) as f:
            data = yaml.safe_load(f)
        data["MODEL"]["LOAD"] = pth
        data["OTHERS"]["SCHEDULE"] = False
        with open(cfg, "w") as f:
            yaml.safe_dump(data, f)
        if name == "jax":
            sys.path.insert(0, os.getcwd())
            import train_ouda as jax_cli

            monkeypatch.setattr(sys, "argv", ["train_ouda.py", f"--cfg={cfg}"])
            jax_cli.main()
        else:
            _main(cfg)
        records[name] = _records(snap)
    jsteps, tsteps = _steps(records["jax"]), _steps(records["torch"])
    assert len(jsteps) == len(tsteps) == STEPS
    for key in ("ce_loss", "rce_loss", "regularization_loss", "buff_ce_loss", "Total target loss",
                "pseudolabel_pixel_num"):
        np.testing.assert_allclose(tsteps[0][key], jsteps[0][key], rtol=1e-4, err_msg=key)
    assert jsteps[0]["pseudolabel_pixel_num"] > 0
    assert set().union(*records["torch"]) == set().union(*records["jax"])


@pytest.mark.slow
@pytest.mark.parametrize("name", list(ADVERSARIAL))
def test_adversarial_cli_keys_are_the_jax_clis(tmp_path, monkeypatch, name):
    """The JAX CLI on the cut adversarial configs writes exactly the keys
    `adversarial_keys` lists (the fast test holds the port's CLI to them).
    Slow: XLA:CPU compiles the JAX steps."""
    import sys

    root, snap = str(tmp_path / "ds"), str(tmp_path / "snaps")
    make_synthetic_dataset(root, intensities=(0, 25, 50), per_domain=PER_DOMAIN, size_wh=(64, 32))
    cfg = _adversarial_cfg(tmp_path / "cfg.yml", name, root, snap)
    sys.path.insert(0, os.getcwd())
    import train_ouda as jax_cli

    monkeypatch.setattr(sys, "argv", ["train_ouda.py", f"--cfg={cfg}"])
    jax_cli.main()
    assert set().union(*_records(snap)) == adversarial_keys(name)
    shutil.rmtree(tmp_path, ignore_errors=True)

