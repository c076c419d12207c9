"""The six shipped prototype configs no other port test drives, each through
the port's CLI (`python -m onda_torch.train_ouda`) on the CPU: static_model.yml
and dynamic_model.yml (PROTO_ONLINE, the `base` policy), confidence_switch.yml
(HSWITCH), confidence_der_switch.yml (VSWITCH), hybrid_switch_fog.yml (the fog
table) and external_video.yml (a label-less `video` stream with no validation
sets). Each is cut to 64x32, b2, its first two domains, EPOCHS 1 and
REPLAY_BUFFER 4, without checkpoint or prototype files, on one bottleneck a
stage; its metrics keys are held to the JAX CLI's, which a slow test confirms
on the same cut configs. Then `tools/summarize_run.py` reads a port run."""

import math
import os
import shutil
import subprocess
import sys

import pytest
import torch
import yaml

from onda_torch import registry
from onda_torch.methods.proto_online import MONITOR_KEYS

from .synthetic import make_bern_dataset, make_synthetic_dataset
from .test_torch_cli import _main, _records

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PER_DOMAIN, BATCH = 4, 2
TINY = (1, 1, 1, 1)
CONFIGS = {  # config → its METHOD.ADAPTATION.NAME
    "static_model": "PROTO_ONLINE",
    "dynamic_model": "PROTO_ONLINE",
    "confidence_switch": "PROTO_ONLINE_HSWITCH",
    "confidence_der_switch": "PROTO_ONLINE_VSWITCH",
    "hybrid_switch_fog": "PROTO_ONLINE_HYBRIDSWITCH",
    "external_video": "PROTO_ONLINE_HYBRIDSWITCH",
}


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
    """The `.pt`, `.pth` and prototype pickles a test writes go when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def cut_config(name, tmp):
    """configs/<name>.yml and its dataset under tmp, cut as the module says;
    returns (config path, snapshot directory, validation sets in order)."""
    with open(os.path.join(REPO, "configs", f"{name}.yml")) as f:
        cfg = yaml.safe_load(f)
    root, snap = str(tmp / "ds"), str(tmp / "snaps")
    order = cfg["SCHEME"]["DOMAIN_ORDER"][:2]
    if name == "external_video":
        make_bern_dataset(root, n_clear=PER_DOMAIN, n_video=PER_DOMAIN, size_wh=(64, 32))
    else:
        intensities = [d[0] for d in cfg["SCHEME"]["SOURCE"] + order]
        make_synthetic_dataset(root, intensities=intensities, per_domain=PER_DOMAIN,
                               size_wh=(64, 32))
        if cfg["SCHEME"]["DATASET"] == "fog_cityscapes":
            os.rename(os.path.join(root, "metadata.json"), os.path.join(root, "metadata_fog.json"))
    cfg["SCHEME"].update(PATH=root + "/", RESOLUTION=[64, 32], DOMAIN_ORDER=order)
    cfg["TRAINING"].update(BATCH_SIZE=BATCH, REPLAY_BUFFER=4)
    cfg["OTHERS"].update(SNAPSHOT_DIR=snap, NUM_WORKERS=2)
    cfg["MODEL"]["LOAD"] = None
    cfg["METHOD"]["ADAPTATION"][CONFIGS[name]].update(EPOCHS=1, LOAD_PROTO=None)
    path = str(tmp / f"{name}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    sets = [] if cfg["OTHERS"]["VALIDATION"] == "none" else [
        str(tuple(d)) for d in cfg["SCHEME"]["SOURCE"] + order]
    return path, snap, sets


def jax_cli_keys(sets):
    """The metrics.jsonl keys the JAX CLI writes for a cut prototype config:
    each step's logs (onda_tpu/methods/proto_online.py:455-485), the host
    loop's, the student's evaluation of every validation set with its samples
    (SKIP_PROTO_EVAL and ECE_SKIP are on in all six), the logger's own."""
    step = {"ce_loss", "rce_loss", "sym_loss", "regularization_loss", "JS Divergance loss",
            "Total target loss", "model regularization", "buff_ce_loss", "buff_rce_loss",
            "buff_loss", "pseudolabel_pixel_num", "output & prototype agreement",
            "mean_prototype_intensity_values", "encoder_lr", "dynamic forward fired",
            "dev avg prior static"}
    step |= {f"{k} {ma} ma" for k in MONITOR_KEYS for ma in ("confidence", "exp confidence")}
    host = {"Total buffer updates", "Step compile+run seconds", "Adaptation frames per second"}
    vals = {f"{k} model of {s}" for s in sets for k in ("Val mIoU", "Val std IoU")}
    samples = {f"Condition {s} sample {i}" for s in sets for i in range(PER_DOMAIN)}
    return step | host | vals | samples | {"_step", "_t"}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """`run(name)`: the port's CLI on the cut config, once per module; the
    checkpoints go right after the run, metrics.jsonl stays."""
    runs = {}

    def run(name):
        if name not in runs:
            tmp = tmp_path_factory.mktemp(name)
            cfg, snap, sets = cut_config(name, tmp)
            with pytest.MonkeyPatch.context() as mp:
                for model in registry.LAYERS:
                    mp.setitem(registry.LAYERS, model, TINY)
                adapter, out = _main(cfg)
            files = sorted(os.listdir(snap))
            state = torch.load(os.path.join(snap, "adapt_state.pt"), weights_only=False)
            runs[name] = {"records": _records(snap), "files": files, "out": out, "snap": snap,
                          "sets": sets, "step": int(state["step"]), "tmp": tmp,
                          "policy": adapter.policy}
            del adapter, state
            for f in files:
                if f.endswith((".pt", ".pth", ".pickle")):
                    os.remove(os.path.join(snap, f))
        return runs[name]

    yield run
    for r in runs.values():
        shutil.rmtree(r["tmp"], ignore_errors=True)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_shipped_config_runs_through_the_cli(cli_runs, name):
    run = cli_runs(name)
    records = run["records"]
    steps = [r for r in records if "Total target loss" in r]
    domains = 1 if name == "external_video" else 2
    assert len(steps) == domains * PER_DOMAIN // BATCH == run["step"]
    for r in steps:
        for key, value in r.items():
            assert "loss" not in key or math.isfinite(value), (name, r["_step"], key)
    assert set().union(*records) == jax_cli_keys(run["sets"])
    assert run["policy"] == {"PROTO_ONLINE": "base", "PROTO_ONLINE_HSWITCH": "hswitch",
                             "PROTO_ONLINE_VSWITCH": "vswitch",
                             "PROTO_ONLINE_HYBRIDSWITCH": "hybrid"}[CONFIGS[name]]
    fired = [r["dynamic forward fired"] for r in steps]
    if name == "static_model":  # DYNAMIC_LAMBDA 0: no dynamic teacher at all
        assert fired == [0.0] * len(steps)
    if name == "dynamic_model":  # SWITCH_PRIOR_THRESH 0: the dynamic teacher every step
        assert fired == [1.0] * len(steps)
    files = set(run["files"])
    source = "[['clear']]" if name == "external_video" else "[[0]]"
    want = {"adapt_state.pt", "metrics.jsonl", "proto_current.pickle",
            f"model_train_{source}_after_src_training.pth"}
    want |= {f"proto_{s}.pickle" for s in (run["sets"][1:] or ["('video',)"])}
    assert want <= files
    assert not [f for f in files if f.startswith(".")]
    assert ("samples" in files) == bool(run["sets"])
    if not run["sets"]:  # a train-only stream: nothing is evaluated
        assert not any(k.startswith(("Val ", "Condition ")) for r in records for k in r)
        assert run["out"].count("Model evaluation") == 2  # the loop's, with no set to score


def test_summarize_run_reads_a_port_run(cli_runs):
    """tools/summarize_run.py on the confidence_switch run's metrics.jsonl:
    one column per validation set in SOURCE + DOMAIN_ORDER order, then the
    mean and the harmonic mean; a row per evaluation pass (before the first
    domain and after each)."""
    run = cli_runs("confidence_switch")
    out = subprocess.run([sys.executable, os.path.join(REPO, "tools", "summarize_run.py"),
                          run["snap"], "--fn", "model"], capture_output=True, text=True,
                         check=True).stdout
    lines = out.splitlines()
    header = next(line for line in lines if line.lstrip().startswith("eval"))
    assert header.split() == ["eval", "step", "(0,)", "(25,)", "(50,)", "mean", "h-mean"]
    rows = lines[lines.index(header) + 2:lines.index(header) + 5]
    assert [r.split()[0] for r in rows] == ["0", "1", "2"]
    assert all(len(r.split()) == 7 for r in rows)


@pytest.mark.slow
@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_keys_are_the_jax_clis(tmp_path, monkeypatch, name):
    """The JAX CLI on the same cut config writes exactly the keys
    `jax_cli_keys` lists (the fast test holds the port's CLI to them). Slow:
    XLA:CPU compiles the JAX steps."""
    cfg, snap, sets = cut_config(name, tmp_path)
    sys.path.insert(0, REPO)
    import train_ouda as jax_cli

    monkeypatch.setattr(sys, "argv", ["train_ouda.py", f"--cfg={cfg}"])
    jax_cli.main()
    assert set().union(*_records(snap)) == jax_cli_keys(sets)
