"""The GPU quality run (`python -m onda_torch.quality_run`) against the JAX
tool `tools/tpu_quality_run.py`: its dataset byte for byte against
`tests/synthetic.py`, one Adam pretraining step against a replica of the
tool's step built from `onda_tpu`'s public pieces, the `.pth` it writes, the
config edits and the result computation exactly, and one tiny run end to end
on the CPU (R50 cut to one block a stage, 64x32, b2)."""

import contextlib
import io
import json
import math
import os
import shutil

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import yaml

from onda_tpu.methods import optim as jopt
from onda_tpu.models import build_deeplab_v2 as jax_build
from onda_tpu.models.import_torch import flax_to_torch_state_dict
from onda_tpu.ops import losses as JL
from onda_tpu.ops.interp import upsample_bilinear_ac as jax_upsample
from onda_torch import quality_run, registry
from onda_torch.config import cfg_from_file
from onda_torch.data.synthetic import make_shift_dataset
from onda_torch.methods import optim
from onda_torch.models.convert import flax_to_state_dict

from .synthetic import make_shift_dataset as jax_make_shift_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, W = 2, 32, 64
TINY = (1, 1, 1, 1)
# the JAX tool's JSON keys (tools/tpu_quality_run.py:196-209)
RESULT_KEYS = ["precision", "src_miou_pretrained", "source_pre", "heavy_pre", "heavy_post",
               "source_post", "recovered", "steps", "wall_s"]
# one pretraining step, port against JAX (the worst seen in brackets), the
# JAX side compiled with XLA:CPU's backend optimisation off (XLA_FAST), whose
# reduction order the port's arithmetic follows: the loss [1.7e-07], every
# gradient [9.2e-06 of its tensor's largest entry] and the running
# statistics [1e-06]. The backbone's gradients pass BatchNorms whose variance
# both packages take in one pass in f32 over 90 values a channel in layer4:
# JAX's own move by up to 17% of a tensor's largest entry when the image is
# scaled by 1 + NUDGE, and the port must sit closer to JAX than that
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
NUDGE = 1e-7
STATS_TOL = dict(rtol=1e-4, atol=1e-6)
# Adam (on the same gradients held to JAX's in tests/test_torch_advent.py):
# from each package's own gradients, the first step moves a weight by
# lr·g/(|g| + eps), ±lr wherever |g| ≫ eps, so a gradient within rounding of
# 0 may move it the other way. At most this share of a tensor's weights may
# differ by more than two f32 ulps of a weight below 2 (ADAM_ATOL), the
# head's [0.02%] and the backbone's [0.2%]
ADAM_ATOL = 2.5e-7
HEAD_MOVED_APART = 0.002
BACKBONE_MOVED_APART = 0.02
# XLA:CPU's backend optimisation off for the JAX side: a shorter compile
XLA_FAST = {"xla_backend_optimization_level": 0}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Torch on two threads in this file: the test run's workers share the
    host's cores, and one torch thread per core in each oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny_layers():
    """registry.LAYERS with R50 cut to one block a stage, for this module."""
    mp = pytest.MonkeyPatch()
    mp.setitem(registry.LAYERS, "DeepLabv2-Resnet50", TINY)
    yield TINY
    mp.undo()


def _files(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("size_wh,n_train,n_val,shift,seed", [
    ((64, 32), 2, 1, 0.0, 0), ((64, 32), 2, 1, 0.6, 1),
    ((64, 32), 1, 2, 0.3, 2), ((1024, 512), 1, 0, 0.3, 2)])
def test_dataset_matches_the_tests_helper(tmp_path, size_wh, n_train, n_val, shift, seed):
    """The same seed writes the same PNG bytes at the same paths, and the same table."""
    table = make_shift_dataset(str(tmp_path / "port"), n_train, n_val, size_wh, shift, seed)
    want = jax_make_shift_dataset(str(tmp_path / "jax"), n_train, n_val, size_wh, shift, seed)
    assert table.rows == want.to_dict("records")
    assert table.columns == list(want.columns)
    got, ref = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert set(got) == set(ref) and len(got) == 2 * (n_train + n_val)
    for rel, data in ref.items():
        assert got[rel] == data, rel


def test_storm_table_is_the_three_domains(tmp_path):
    table = quality_run.make_storm(str(tmp_path), 2, 1, (W, H))
    assert [r["intensity"] for r in table.rows] == [0] * 3 + [60] * 3 + [30] * 3
    from onda_torch.data.metadata import load_table

    assert load_table(str(tmp_path / "metadata.json")).rows == table.rows


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=XLA_FAST)


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def test_pretraining_step_matches_jax():
    """One Adam pretraining step at 64x32, b2, f32, dropout off: the port's
    `adam_step` against the JAX tool's step (tpu_quality_run.py:83-96) built
    from onda_tpu's pieces; the JAX model's initial weights cross over through flax_to_state_dict."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    labels = rng.integers(0, 4, size=(B, H, W)).astype(np.int32)
    labels[:, :3] = 255
    jmodel = jax_build(num_classes=19, layers=TINY, classifier="ProDA", droprate=0.0)
    variables = jax.tree.map(np.asarray, dict(jax.jit(
        lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, H, W, 3)), train=False))()))

    def step(params, stats, opt, images, labels):
        def loss_fn(p):
            (_, main), mut = jmodel.apply({"params": p, "batch_stats": stats}, images, train=True,
                                          update_stats=True, dropout_rng=None,
                                          mutable=["batch_stats"])
            out = main["out"] if isinstance(main, dict) else main
            return JL.cross_entropy_2d(jax_upsample(out, (H, W)), labels), mut["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        new_params, new_opt = jopt.adam_update(params, grads, opt, 1e-3)
        return new_params, new_stats, new_opt, loss, grads

    params = variables["params"]
    args = (params, variables["batch_stats"], jopt.adam_init(params), jnp.asarray(x),
            jnp.asarray(labels))
    compiled = _compiled(step, *args)
    new_params, new_stats, _, loss, grads = jax.tree.map(np.asarray, compiled(*args))
    nudged = flax_to_torch_state_dict({"params": jax.tree.map(np.asarray, compiled(
        *args[:3], jnp.asarray(x * np.float32(1 + NUDGE)), args[4])[4])})

    model = quality_run.build_model(TINY, "f32", droprate=0.0)
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    tparams = dict(model.named_parameters())
    opt = optim.adam_init(tparams)
    tloss, tgrads = quality_run.adam_step(
        model, tparams, opt, torch.tensor(x.transpose(0, 3, 1, 2)), torch.tensor(labels).long(),
        None, quality_run.unused_params(model))
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=LOSS_RTOL)
    assert opt["count"] == 1

    want_g = flax_to_torch_state_dict({"params": grads})
    assert set(want_g) == set(tgrads)
    gap = self_gap = 0.0
    for key, g in want_g.items():
        err = _rel(tgrads[key].numpy(), g)
        assert err <= GRAD_REL, f"gradient {key}: {err:.3e} > {GRAD_REL}"
        gap, self_gap = max(gap, err), max(self_gap, _rel(nudged[key], g))
    assert gap < self_gap, (gap, self_gap)

    want_p = flax_to_torch_state_dict({"params": new_params})
    assert set(want_p) == set(tparams)
    for key, value in want_p.items():
        apart = (np.abs(tparams[key].detach().numpy() - value) > ADAM_ATOL).mean()
        share = HEAD_MOVED_APART if key.startswith(("layer5.", "layer6.")) else BACKBONE_MOVED_APART
        assert apart <= share, f"Adam step {key}: {apart:.3%} of the weights moved apart"

    buffers = dict(model.named_buffers())
    for key, value in flax_to_torch_state_dict({"batch_stats": new_stats}).items():
        np.testing.assert_allclose(buffers[key].numpy(), value, err_msg=key, **STATS_TOL)


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory, tiny_layers):
    """pretrain_adam at 64x32, b2, one epoch, f32, on the CPU."""
    tmp = tmp_path_factory.mktemp("quality_pretrain")
    table = quality_run.make_storm(str(tmp / "ds"), 2, 2, (W, H))
    pth = str(tmp / "source_f32.pth")
    out = quality_run.pretrain_adam(str(tmp / "ds"), table, pth, batch=2, epochs=1,
                                    precision="f32", layers=tiny_layers, size_wh=(W, H),
                                    device="cpu", num_workers=1)
    yield out, pth
    shutil.rmtree(tmp, ignore_errors=True)


def test_pth_loads_strict_through_get_model(pretrained):
    """MODEL.LOAD with the written `.pth` gives a model that computes the
    pretrained model's eval-mode logits."""
    out, pth = pretrained
    assert out["steps_per_epoch"] == 1 and len(out["epoch_seconds"]) == 1
    assert 0.0 <= out["src_miou"] <= 1.0
    cfg = cfg_from_file(str(quality_run.CONFIG))
    cfg.MODEL.LOAD = pth
    cfg.MODEL.MULTI_LEVEL = False
    loaded, _ = registry.get_model(cfg, 19, device="cpu")
    x = torch.tensor(np.random.default_rng(3).normal(size=(1, 3, H, W)).astype(np.float32))
    with torch.no_grad():
        want = out["model"](x, train=False)[1]["out"]
        got = loaded(x, train=False)[1]["out"]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_config_is_hybrid_switch_with_the_tools_edits(tmp_path):
    """The JAX tool's edits (tpu_quality_run.py:164-178), less OTHERS.AOT_CACHE,
    and nothing else; the port's config loader reads the result."""
    with open(os.path.join(ROOT, "configs/hybrid_switch.yml")) as f:
        want = yaml.safe_load(f)
    ds_root, snaps, pth, batch, uda, precision = "/d/ds", "/d/snaps_bf16", "/d/s.pth", 8, 20, "bf16"
    want["SCHEME"].update(PATH=ds_root + "/", RESOLUTION=[1024, 512],
                          SOURCE=[[0]], DOMAIN_ORDER=[[60], [30]])
    want["TRAINING"].update(BATCH_SIZE=batch, REPLAY_BUFFER=16, SHUFFLE=True, RANDOM_SEED=123)
    want["MODEL"].update(NAME="DeepLabv2-Resnet50", LOAD=pth, MULTI_LEVEL=False)
    want["METHOD"]["PRETRAIN"]["SEGMENT"]["EPOCHS"] = 0
    spec = want["METHOD"]["ADAPTATION"][want["METHOD"]["ADAPTATION"]["NAME"]]
    spec.update(EPOCHS=uda, SKIP_CALC=False, LOAD_PROTO=None)
    want["OTHERS"].update(SNAPSHOT_DIR=snaps, NUM_WORKERS=4, PRECISION=precision,
                          GENERATE_SAMPLES_EVERY=0)
    got = quality_run.quality_config(ds_root, snaps, pth, batch=batch, uda_epochs=uda,
                                     precision=precision)
    assert got == want and "AOT_CACHE" not in got["OTHERS"]
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(got))
    cfg = cfg_from_file(str(path))
    assert cfg.SCHEME.DOMAIN_ORDER == [[60], [30]] and cfg.OTHERS.PRECISION == "bf16"


def jax_result(lines, precision, src_pop, uda_epochs, wall_s):
    """tools/tpu_quality_run.py:188-209 on the records `lines` (its code, with
    the wall seconds passed in)."""
    heavy = [r["Val mIoU model of (60,)"] for r in lines if "Val mIoU model of (60,)" in r]
    source = [r["Val mIoU model of (0,)"] for r in lines if "Val mIoU model of (0,)" in r]
    steps = sum(1 for r in lines if "Total target loss" in r)
    heavy_pre = heavy[0]
    heavy_post = max(heavy[1:uda_epochs + 1]) if len(heavy) > 1 else float("nan")
    return {
        "precision": precision,
        "src_miou_pretrained": round(src_pop, 4) if src_pop is not None else None,
        "source_pre": round(source[0], 4),
        "heavy_pre": round(heavy_pre, 4),
        "heavy_post": round(heavy_post, 4),
        "source_post": round(source[uda_epochs], 4) if len(source) > uda_epochs else None,
        "recovered": bool(heavy_post > max(2 * heavy_pre, heavy_pre + 0.01)),
        "steps": steps,
        "wall_s": round(wall_s, 1),
    }


def records(heavy, source, steps_per_epoch):
    """metrics.jsonl of the storm's run: the evaluation before adaptation,
    then each epoch's steps and its evaluation, for [[60]] then [[30]]."""
    out = [{"Val mIoU model of (0,)": source[0], "Val mIoU model of (60,)": heavy[0],
            "Val mIoU model of (30,)": 0.1}]
    for h, s in zip(heavy[1:], source[1:]):
        out += [{"Total target loss": 1.0}] * (steps_per_epoch - 1)
        out.append({"Total target loss": 1.0, "Val mIoU model of (0,)": s,
                    "Val mIoU model of (60,)": h, "Val mIoU model of (30,)": 0.1})
    return out


@pytest.mark.parametrize("heavy,source,src_pop,uda", [
    ([0.0043, 0.01, 0.0195, 0.012, 0.3, 0.3], [0.17, 0.15, 0.12, 0.11, 0.2, 0.2], 0.61234, 3),
    ([0.02, 0.025, 0.021, 0.3, 0.3], [0.17, 0.16, 0.15, 0.2, 0.2], None, 2),
    ([0.02], [0.17], 0.5, 3),
], ids=["recovered", "failed", "no_epochs"])
def test_result_is_the_tools(heavy, source, src_pop, uda):
    lines = records(heavy, source, steps_per_epoch=3)
    got = quality_run.result_of(lines, "bf16", src_pop, uda, 12.345)
    want = jax_result(lines, "bf16", src_pop, uda, 12.345)
    assert list(got) == RESULT_KEYS
    assert json.dumps(got) == json.dumps(want)
    if len(heavy) == 1:
        assert math.isnan(got["heavy_post"]) and got["source_post"] is None


def test_knobs_default_to_the_ports_own_directory():
    k = quality_run.knobs({})
    assert (k["batch"], k["n_train"], k["n_val"], k["pretrain_epochs"], k["uda_epochs"],
            k["precision"], k["reuse_pth"]) == (8, 48, 8, 30, 20, "bf16", True)
    import tempfile

    assert k["root"] == os.path.join(tempfile.gettempdir(), "onda_torch_quality")
    assert k["out"] == os.path.join(k["root"], "quality_bf16.json")
    assert quality_run.knobs({"ONDA_QUALITY_OUT": ""})["out"] == ""


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory, tiny_layers):
    """The whole tool on the CPU: 64x32, b2, two train and two val frames a
    domain, one pretraining and one adaptation epoch, f32."""
    tmp = tmp_path_factory.mktemp("quality_run")
    env = {"ONDA_QUALITY_BATCH": "2", "ONDA_QUALITY_NTRAIN": "2", "ONDA_QUALITY_NVAL": "2",
           "ONDA_QUALITY_PRETRAIN_EPOCHS": "1", "ONDA_QUALITY_UDA_EPOCHS": "1",
           "ONDA_QUALITY_PRECISION": "f32", "ONDA_QUALITY_DIR": str(tmp)}
    with open(os.path.join(ROOT, "QUALITY_r5.json"), "rb") as f:
        committed = f.read()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = quality_run.run("cpu", size_wh=(W, H), env=env)
    written = {name: os.path.getsize(tmp / name) for name in os.listdir(tmp)
               if os.path.isfile(tmp / name)}
    yield result, out.getvalue(), written, committed
    shutil.rmtree(tmp, ignore_errors=True)


def test_tiny_run_prints_the_tools_json_line(tiny_run):
    result, stdout, written, _ = tiny_run
    lines = [json.loads(line) for line in stdout.splitlines() if line.startswith('{"precision"')]
    assert lines == [json.loads(json.dumps(result))]
    assert list(lines[0]) == RESULT_KEYS
    for key in ("src_miou_pretrained", "source_pre", "heavy_pre", "heavy_post", "source_post"):
        assert math.isfinite(result[key]) and 0.0 <= result[key] <= 1.0, key
    assert result["precision"] == "f32" and isinstance(result["recovered"], bool)
    assert result["steps"] == 2 * 1 * 1  # two domains, one epoch, one step of b2


def test_tiny_run_writes_only_its_own_directory(tiny_run):
    result, _, written, committed = tiny_run
    assert {"quality_f32.json", "source_f32.pth", "cfg_f32.yml"} <= set(written)
    with open(os.path.join(ROOT, "QUALITY_r5.json"), "rb") as f:
        assert f.read() == committed
    assert not [f for f in os.listdir(ROOT) if f.startswith("quality_")]


def test_without_a_card_it_stops_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quality_run.main([])
