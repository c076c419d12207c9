"""SEGMENT pretraining against the JAX package: `SegmentTrainer`'s steps (CE
of the main and aux heads, SGD with the head at 10× and the poly LR off by
one), its evaluation (mIoU, the reference's mean entropy, the full-image IoU
through `label_raw`) and the data layer's `label_raw`. Both trainers start
from the same multi-level weights (carried across by
onda_torch.models.convert) with Dropout2d off on both sides."""

import os
import shutil

import numpy as np
import pandas as pd
import pytest
import jax
import jax.numpy as jnp
import torch

from onda_tpu.config import cfg_from_file as jax_cfg_from_file
from onda_tpu.config import default_config
from onda_tpu.data.segmentation import SegmentationDataset as JaxDataset
from onda_tpu.methods.segmentation import SegmentTrainer as JaxTrainer
from onda_tpu.models import build_deeplab_v2 as jax_build
from onda_tpu.models.import_torch import flax_to_torch_state_dict
from onda_tpu.ops import metrics as jax_metrics
from onda_torch import native
from onda_torch.config import cfg_from_file
from onda_torch.data.metadata import load_dataset_info, load_table
from onda_torch.data.segmentation import SegmentationDataset
from onda_torch.methods.segmentation import SegmentTrainer
from onda_torch.models import build_deeplab_v2
from onda_torch.models.convert import flax_to_state_dict
from onda_torch.ops import metrics

from .synthetic import make_synthetic_dataset

B, H, W, C = 2, 32, 64, 19
STEPS = 3
LR = 2e-2  # training_fog.yml's 2.5e-4 moves random weights too little to compare
CONFIG = "configs/training_fog.yml"  # SEGMENT, MULTI_LEVEL, POWER 0.9


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """The `.pt`, `.pth` and prototype pickles a test writes (up to 1.2 GB
    each) go when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Torch on two threads in this file: the test run's workers share the
    host's cores, and one torch thread per core in each oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


class Recorder:
    def __init__(self):
        self.records = []

    def log(self, metrics):
        self.records.append(dict(metrics))


def _batch(rng, raw_hw=None):
    batch = {"image": rng.normal(size=(B, H, W, 3)).astype(np.float32),
             "label": rng.integers(0, C, size=(B, H, W)).astype(np.int32)}
    batch["label"][0, :4] = 255  # ignored pixels
    if raw_hw:
        batch["label_raw"] = rng.integers(0, C, size=(B, *raw_hw)).astype(np.int32)
    return batch


def _nchw(batch):
    return {k: np.ascontiguousarray(v.transpose(0, 3, 1, 2)) if k == "image" else v
            for k, v in batch.items()}


def make_trainers(tmp, **cfg_over):
    jcfg = jax_cfg_from_file(CONFIG, default_config())
    tcfg = cfg_from_file(CONFIG)
    for cfg, name in ((jcfg, "jax"), (tcfg, "torch")):
        cfg.SCHEME.RESOLUTION = [W, H]
        cfg.OTHERS.SNAPSHOT_DIR = str(tmp / name)
        cfg.OTHERS.DATA_PARALLEL = False
        cfg.METHOD.PRETRAIN.SEGMENT.LEARNING_RATE = LR
        cfg.METHOD.PRETRAIN.SEGMENT.EPOCHS = 1
        for key, value in cfg_over.items():
            section, field = key.split(".")
            cfg[section][field] = value
    jmodel = jax_build(num_classes=C, layers=(1, 1, 1, 1), droprate=0.0, multi_level=True)
    variables = jmodel.init(jax.random.key(0), jnp.zeros((1, H, W, 3)), train=False)
    variables = jax.tree.map(np.asarray, dict(variables))
    jtr = JaxTrainer(jmodel, variables, jcfg, jcfg.METHOD.PRETRAIN.SEGMENT, C, logger=Recorder())
    tmodel = build_deeplab_v2(C, (1, 1, 1, 1), "ProDA", multi_level=True, droprate=0.0)
    tmodel.load_state_dict(flax_to_state_dict(variables), strict=True)
    from onda_torch.registry import variables_of

    ttr = SegmentTrainer(tmodel, variables_of(tmodel), tcfg, tcfg.METHOD.PRETRAIN.SEGMENT, C,
                         logger=Recorder(), device="cpu")
    return jtr, ttr


def _jax_sd(params, stats):
    return flax_to_torch_state_dict({"params": jax.tree.map(np.asarray, params),
                                     "batch_stats": jax.tree.map(np.asarray, stats)})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both trainers' `train` over one epoch of 3 batches, each step's LR,
    loss and (after steps 1 and 3) state recorded."""
    tmp = tmp_path_factory.mktemp("segment")
    jtr, ttr = make_trainers(tmp)
    rng = np.random.default_rng(0)
    batches = [_batch(rng) for _ in range(STEPS)]
    val = [_batch(rng)]
    out = {"jax": {"lr": [], "loss": [], "state": []}, "torch": {"lr": [], "loss": [], "state": []}}
    jtr._step = jtr._build_step()
    jax_step = jtr._step

    def jstep(*args):
        res = jax_step(*args)
        out["jax"]["lr"].append(float(args[-1]))
        out["jax"]["loss"].append(float(res[-1]))
        out["jax"]["state"].append(_jax_sd(res[0], res[1]))
        return res

    jtr._step = jstep
    torch_step = ttr.step

    def tstep(images, labels, lr):
        loss = torch_step(images, labels, lr)
        out["torch"]["lr"].append(lr)
        out["torch"]["loss"].append(float(loss))
        out["torch"]["state"].append({k: v.detach().clone().numpy()
                                      for k, v in {**ttr.params, **ttr.batch_stats}.items()})
        return loss

    ttr.step = tstep
    jtr.save_model = lambda: None  # the port's file is the one tested
    jtr.train({"src": batches}, {"v": val})
    ttr.train({"src": [_nchw(b) for b in batches]}, {"v": [_nchw(b) for b in val]})
    out["jax"]["records"], out["torch"]["records"] = jtr.logger.records, ttr.logger.records
    out["snap"] = tmp / "torch"
    out["trainer"] = ttr
    yield out
    shutil.rmtree(tmp, ignore_errors=True)  # 0.2 GB of checkpoints


def test_lr_sequence_is_the_reference_off_by_one(runs):
    # step i trains at lr(i-1), step 0 at the base rate; total = 3 steps
    want = [LR, LR * (1 - 0 / 3) ** 0.9, LR * (1 - 1 / 3) ** 0.9]
    assert runs["torch"]["lr"] == pytest.approx(want, rel=1e-12)
    assert np.float32(runs["torch"]["lr"]).tolist() == runs["jax"]["lr"]


def test_step0_loss_and_state_match_jax(runs):
    np.testing.assert_allclose(runs["torch"]["loss"][0], runs["jax"]["loss"][0], rtol=1e-4)
    jstate, tstate = runs["jax"]["state"][0], runs["torch"]["state"][0]
    assert set(jstate) <= set(tstate)
    for key, want in jstate.items():
        # rtol as the step tests'; atol 1e-5 since the backbone's three
        # chained sub-updates at LR 2e-2 carry the gradients' rounding
        # (measured: at most 2.6e-6 absolute, in layer1.0.conv1.weight)
        np.testing.assert_allclose(tstate[key], want, rtol=1e-4, atol=1e-5, err_msg=key)


def test_three_steps_stay_close(runs):
    np.testing.assert_allclose(runs["torch"]["loss"], runs["jax"]["loss"], rtol=1e-3)
    jstate, tstate = runs["jax"]["state"][-1], runs["torch"]["state"][-1]
    for key, want in jstate.items():
        np.testing.assert_allclose(tstate[key], want, rtol=1e-3, atol=6e-4, err_msg=key)
    # the aux head learned (multi_level): a loss reaches it in SEGMENT
    key = "layer5.head.1.weight"
    assert not np.allclose(tstate[key], runs["torch"]["state"][0][key])


def test_logged_records_match_jax(runs):
    jrec, trec = runs["jax"]["records"], runs["torch"]["records"]
    assert [set(r) for r in trec] == [set(r) for r in jrec]
    assert trec[0]["Segmentation loss"] == pytest.approx(jrec[0]["Segmentation loss"], rel=1e-4)
    assert trec[0]["learning_rate"] == pytest.approx(jrec[0]["learning_rate"], rel=1e-7)
    for key in ("Val mIoU of v", "Val std IoU of v", "val entropy of v"):
        assert trec[1][key] == pytest.approx(jrec[1][key], rel=2e-3, abs=1e-4), key


def test_model_saved_in_the_reference_layout(runs):
    sd = torch.load(runs["snap"] / "model_train_[[0]].pth")
    ttr = runs["trainer"]
    assert list(sd) == list(ttr.model.state_dict())
    torch.testing.assert_close(sd["layer6.head.1.weight"], ttr.params["layer6.head.1.weight"])
    assert not [f for f in os.listdir(runs["snap"]) if f.startswith(".")]


def test_evaluate_with_full_image_labels_matches_jax(tmp_path):
    """evaluate() on a padded final batch, with ORIGINAL_RES and label_raw:
    per-class IoU at the input size and at the original size, mean entropy."""
    raw_hw = (H * 2, W * 2)
    jtr, ttr = make_trainers(tmp_path, **{"SCHEME.ORIGINAL_RES": [raw_hw[1], raw_hw[0]]})
    rng = np.random.default_rng(5)
    batches = [_batch(rng, raw_hw), dict(_batch(rng, raw_hw), valid=1)]
    want = jtr.evaluate(batches, original_res=True)
    got = ttr.evaluate([_nchw(b) for b in batches], original_res=True)
    assert len(got) == len(want) == 3
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-9)
    assert got[1] == pytest.approx(want[1], rel=1e-5)
    # without label_raw in the batches there is no full-image score
    plain = [{k: v for k, v in b.items() if k != "label_raw"} for b in batches]
    assert len(ttr.evaluate([_nchw(b) for b in plain], original_res=True)) == 2


@pytest.mark.parametrize("case", ["random", "uniform", "onehot"])
def test_mean_entropy_matches_jax(rng, case):
    if case == "random":
        logits = rng.normal(size=(2, 5, 7, C)).astype(np.float32) * 3
        probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    elif case == "uniform":
        probs = np.full((2, 5, 7, C), 1.0 / C, np.float32)
    else:
        probs = np.eye(C, dtype=np.float32)[rng.integers(0, C, (2, 5, 7))]
    want = float(jax_metrics.mean_entropy(jnp.asarray(probs)))
    got = float(metrics.mean_entropy(torch.tensor(probs.transpose(0, 3, 1, 2))))
    # f32 means of a few thousand values, summed in another order
    assert got == pytest.approx(want, rel=1e-5, abs=1e-9)
    if case == "uniform":
        assert got == pytest.approx(1.0 / C, rel=1e-5)  # the reference's quirk: 1/C, not 1


def test_label_raw_matches_jax(tmp_path):
    """`original_label`: label_raw at the files' own size exactly as the JAX
    package's (PIL decode through the LUT); label and label_res at an
    integral scale (128x64 files to 64x32), where the native rule and PIL's
    NEAREST agree."""
    root = str(tmp_path / "ds")
    make_synthetic_dataset(root, intensities=(0,), per_domain=3, size_wh=(128, 64))
    info = load_dataset_info()
    label2train = dict(tuple(p) for p in info["label2train"])
    mean, std = np.asarray(info["mean"]), np.asarray(info["std"])
    jds = JaxDataset(root, pd.read_json(os.path.join(root, "metadata.json")), label2train,
                     (W, H), mean=mean, std=std, original_label=True)
    tds = SegmentationDataset(root, load_table(os.path.join(root, "metadata.json")), label2train,
                              (W, H), mean=mean, std=std, original_label=True,
                              executor=native.BatchExecutor(1))
    rows = [0, 2, 1]
    got = tds.prepare_batch(rows)
    assert got["label_raw"].shape == (3, 64, 128) and got["label_raw"].dtype == np.int32
    for j, i in enumerate(rows):
        want = jds[i]
        np.testing.assert_array_equal(got["label_raw"][j], want["label_raw"])
        np.testing.assert_array_equal(got["label"][j], want["label"])
        np.testing.assert_array_equal(got["label_res"][j], want["label_res"])
    assert (got["label_raw"] == 255).any() and (got["label_raw"] < C).any()
