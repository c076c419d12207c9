"""EVALUATION mode against the JAX package: `EvaluationRunner` loading the
newest loadable checkpoint, `evaluate_all` (model and prototype predictions)
on a `.pth` both packages load, the snapshot sweeper's order, best pick and
polling, and the PREDICTION_SAVE dumps. Weights are a multi-level model's
with Dropout2d off, written as a reference-layout `.pth` by the port."""

import os
import shutil

import numpy as np
import pytest
import jax
import torch

from onda_tpu.config import cfg_from_file as jax_cfg_from_file
from onda_tpu.config import default_config
from onda_tpu.methods.evaluation import EvaluationRunner as JaxRunner
from onda_tpu.models import build_deeplab_v2 as jax_build
from onda_torch import registry
from onda_torch.config import cfg_from_file
from onda_torch.methods.evaluation import EvaluationRunner
from onda_torch.models import build_deeplab_v2
from onda_torch.utils.checkpoint import save_atomic

B, H, W, C = 2, 32, 64, 19
HR, WR = H // 8 + 1, W // 8 + 1
CONFIG = "configs/validation_offline_fog.yml"  # EVALUATION, prototype evaluation on


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
    """Each test writes 0.2-0.7 GB of `.pth` files; none is needed after it."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


class Recorder:
    def __init__(self):
        self.records = []

    def log(self, metrics):
        self.records.append(dict(metrics))


def _torch_model(seed=0):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build_deeplab_v2(C, (1, 1, 1, 1), "ProDA", multi_level=True, droprate=0.0)


def write_pth(path, seed, mtime):
    save_atomic(_torch_model(seed).state_dict(), str(path))
    os.utime(path, (mtime, mtime))


def _spec(cfg):
    """The EVALUATION spec as the CLI makes it: the adaptation block overlaid
    by the evaluation block."""
    merged = cfg.METHOD.ADAPTATION[cfg.METHOD.ADAPTATION.NAME].copy()
    merged.update(cfg.METHOD.PRETRAIN.EVALUATION)
    return merged


def make_runners(snap, **spec_over):
    """(JAX runner, port runner), both made on SNAPSHOT_DIR `snap`."""
    runners = []
    for pkg in ("jax", "torch"):
        cfg = (jax_cfg_from_file(CONFIG, default_config()) if pkg == "jax"
               else cfg_from_file(CONFIG))
        cfg.SCHEME.RESOLUTION = [W, H]
        cfg.OTHERS.SNAPSHOT_DIR = str(snap)
        cfg.OTHERS.DATA_PARALLEL = False
        spec = _spec(cfg)
        spec.set_ = (25,)
        for key, value in spec_over.items():
            spec[key] = value
        if pkg == "jax":
            model = jax_build(num_classes=C, layers=(1, 1, 1, 1), droprate=0.0, multi_level=True)
            variables = jax.tree.map(np.asarray, dict(model.init(
                jax.random.key(1), np.zeros((1, H, W, 3), np.float32), train=False)))
            runners.append(JaxRunner(model, variables, cfg, spec, C, logger=Recorder()))
        else:
            model = _torch_model(1)
            runners.append(EvaluationRunner(model, registry.variables_of(model), cfg, spec, C,
                                            logger=Recorder(), device="cpu"))
    return runners


def _batches(seed, n=2, pad_last=True):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        batch = {"image": rng.normal(size=(B, H, W, 3)).astype(np.float32),
                 "label": rng.integers(0, C, size=(B, H, W)).astype(np.int32)}
        if pad_last and i == n - 1:
            batch["valid"] = 1  # a padded final batch
        out.append(batch)
    return out


def _nchw(batches):
    return [{k: np.ascontiguousarray(v.transpose(0, 3, 1, 2)) if k == "image" else v
             for k, v in b.items()} for b in batches]


def test_runner_loads_the_newest_loadable_checkpoint(tmp_path, capsys):
    """Newest first, past a file that does not load; hidden temporaries and
    other files are never considered."""
    ref = _torch_model(7)
    write_pth(tmp_path / "old.pth", 3, 100)
    save_atomic(ref.state_dict(), str(tmp_path / "model_train_[[0]].pth"))
    os.utime(tmp_path / "model_train_[[0]].pth", (200, 200))
    (tmp_path / "broken.pth").write_bytes(b"not a checkpoint")
    os.utime(tmp_path / "broken.pth", (300, 300))
    (tmp_path / ".adapt_state.pt.x.tmp").write_bytes(b"partial")
    (tmp_path / "proto_current.pickle").write_bytes(b"")
    _, runner = make_runners(tmp_path)
    out = capsys.readouterr().out
    assert "load skip: broken.pth" in out
    assert f"Model {tmp_path / 'model_train_[[0]].pth'} is being loaded" in out
    for key, value in ref.state_dict().items():
        tensor = runner.state.params.get(key, runner.state.batch_stats.get(key))
        torch.testing.assert_close(tensor, value, rtol=0, atol=0, msg=key)


def test_evaluate_all_on_a_pth_matches_jax(tmp_path):
    """Both runners load the same `.pth` and evaluate it with the prototype
    evaluation on (the prototypes are the initial zeros: validation YAMLs
    load none, as in the JAX package)."""
    write_pth(tmp_path / "model.pth", 2, 100)
    jr, tr = make_runners(tmp_path)
    batches = _batches(3)
    want = jr.evaluate_all({"v": batches})
    got = tr.evaluate_all({"v": _nchw(batches)})
    assert set(got) == set(want) == {"Val mIoU model of v", "Val std IoU model of v",
                                     "Val mIoU proto of v", "Val std IoU proto of v"}
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=1e-4, abs=1e-6), key


def test_sweeper_order_and_best_pick_match_jax(tmp_path, capsys):
    for i, seed in enumerate((11, 12, 13)):
        write_pth(tmp_path / f"ckpt_{i}.pth", seed, 100 + i)
    (tmp_path / "broken.pth").write_bytes(b"garbage")
    os.utime(tmp_path / "broken.pth", (99, 99))
    jr, tr = make_runners(tmp_path, SKIP_PROTO_EVAL=True)
    batches = _batches(4, n=1, pad_last=False)
    capsys.readouterr()
    jbest = jr.sweep_checkpoints({"v": batches})
    tbest = tr.sweep_checkpoints({"v": _nchw(batches)})
    out = capsys.readouterr().out
    assert out.count("sweep skip: broken.pth") == 2
    jswept = [(r["Swept checkpoint"], r["Swept mIoU"]) for r in jr.logger.records
              if "Swept checkpoint" in r]
    tswept = [(r["Swept checkpoint"], r["Swept mIoU"]) for r in tr.logger.records
              if "Swept checkpoint" in r]
    assert [n for n, _ in tswept] == [n for n, _ in jswept] == ["ckpt_0.pth", "ckpt_1.pth",
                                                                "ckpt_2.pth"]
    for (_, t), (_, j) in zip(tswept, jswept):
        assert t == pytest.approx(j, rel=1e-4, abs=1e-6)
    assert len({m for _, m in tswept}) == 3  # distinct models, so the pick means something
    assert tbest["checkpoint"] == jbest["checkpoint"] == max(tswept, key=lambda x: x[1])[0]
    assert tr.logger.records[-1] == {"Best checkpoint": tbest["checkpoint"],
                                     "Best mIoU": tbest["miou"]}


def test_prediction_save_dumps_match_jax(tmp_path):
    """run_predictions: one NCHW `batch-{i}.pt` per batch under
    PREDICTION_SAVE/<set>, the padded final batch dumped whole, and the
    confidence and progress logs."""
    write_pth(tmp_path / "model.pth", 5, 100)
    jr, tr = make_runners(tmp_path)
    batches = _batches(6, n=3)
    for runner, name in ((jr, "jax"), (tr, "torch")):
        runner.cfg_spec.PREDICTION_SAVE = str(tmp_path / f"pred_{name}")
    jr.run_predictions(batches)
    tr.run_predictions(_nchw(batches))
    jdir, tdir = tmp_path / "pred_jax" / "(_2_5_,_)", tmp_path / "pred_torch" / "(_2_5_,_)"
    names = ["batch-0.pt", "batch-1.pt", "batch-2.pt"]
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == names
    for name in names:
        got, want = torch.load(tdir / name), torch.load(jdir / name)
        assert got.shape == want.shape == (B, C, HR, WR) and got.dtype == want.dtype
        # the eval forward's envelope (tests/test_torch_model.py)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3, atol=2e-4, err_msg=name)
    trec, jrec = tr.logger.records, jr.logger.records
    assert [r["Progress"] for r in trec] == [r["Progress"] for r in jrec] == [0.0, 100 / 3, 200 / 3]
    for t, j in zip(trec, jrec):
        assert t["Prediction confidence"] == pytest.approx(j["Prediction confidence"], rel=1e-4)


def test_sweeper_polls_for_checkpoints_that_come_later(tmp_path, monkeypatch):
    """wait_seconds: the sweeper polls every 5 s, a checkpoint written while it
    waits is swept too, and the sweep ends once none has come for
    wait_seconds. The clock is a fake that only the sweeper's sleeps advance,
    so the sleeps are exact whatever the machine's load."""
    from onda_torch.methods import evaluation

    write_pth(tmp_path / "first.pth", 21, 100)
    _, tr = make_runners(tmp_path, SKIP_PROTO_EVAL=True)
    sleeps = []

    class Clock:
        now = 0.0

        @staticmethod
        def monotonic():
            return Clock.now

        @staticmethod
        def sleep(seconds):
            sleeps.append(seconds)
            Clock.now += seconds
            if len(sleeps) == 1:  # a checkpoint comes during the first wait
                write_pth(tmp_path / "later.pth", 22, 200)

    monkeypatch.setattr(evaluation, "time", Clock)
    best = tr.sweep_checkpoints({"v": _nchw(_batches(8, n=1, pad_last=False))}, wait_seconds=12.0)
    swept = [r["Swept checkpoint"] for r in tr.logger.records if "Swept checkpoint" in r]
    assert swept == ["first.pth", "later.pth"]
    assert best["checkpoint"] in swept
    # a wait after each new file (from 0 and 5 s), then quiet waits from 10
    # and 15 s; at 20 s, 12 s have passed since later.pth was swept at 5 s
    assert sleeps == [5.0] * 4
