"""The rest of the online family against the JAX package: the multi-level
model (aux head skipped in the step, zero gradient but weight decay for it),
BN_POLICY double and keep, AUTO_DYNAMIC's refresh cadence and PREDICTION_SAVE
dumps in adaptation. Both adapters start from the same weights (carried
across by onda_torch.models.convert) with Dropout2d off on both sides, and
bootstrap the prototypes from the same source batch."""

import os
import shutil

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from onda_tpu.config import cfg_from_file as jax_cfg_from_file
from onda_tpu.config import default_config
from onda_tpu.methods.proto_online import ProtoOnlineAdapter as JaxAdapter
from onda_tpu.models import build_deeplab_v2 as jax_build
from onda_tpu.models.import_torch import flax_to_torch_state_dict
from onda_torch import registry
from onda_torch.config import cfg_from_file
from onda_torch.methods.proto_online import ProtoOnlineAdapter
from onda_torch.models import build_deeplab_v2
from onda_torch.models.convert import flax_to_state_dict

from .test_auto_dynamic import make_spec, scripted_trace

B, H, W, C = 2, 32, 64, 19
HR, WR = H // 8 + 1, W // 8 + 1
LOSSES = ("ce_loss", "rce_loss", "regularization_loss", "buff_ce_loss", "Total target loss")
# step 0, as tests/test_torch_step.py holds it
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
TREE_TOL = dict(rtol=1e-4, atol=1e-6)


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


def _configure(cfg, spec, snap, **spec_over):
    cfg.SCHEME.RESOLUTION = [W, H]
    cfg.OTHERS.SNAPSHOT_DIR = snap
    cfg.OTHERS.AOT_CACHE = False
    spec.LOAD_PROTO = None
    spec.set_ = "test"
    spec.PSEUDO_THRESH = 0.06  # random weights: keep some pixels above the threshold
    for key, value in spec_over.items():
        spec[key] = value


def _batch(rng):
    return {"image": rng.normal(size=(B, H, W, 3)).astype(np.float32),
            "label": rng.integers(0, C, size=(B, H, W)).astype(np.int32),
            "label_res": rng.integers(0, C, size=(B, HR, WR)).astype(np.int32)}


def _nchw(a):
    return torch.tensor(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def make_pair(tmp, config, multi_level=False, **spec_over):
    """(JAX adapter, port adapter) from the same weights, prototypes bootstrapped."""
    boot = _batch(np.random.default_rng(0))
    jcfg = jax_cfg_from_file(config, default_config())
    jspec = jcfg.METHOD.ADAPTATION[jcfg.METHOD.ADAPTATION.NAME]
    _configure(jcfg, jspec, str(tmp / "jax"), **spec_over)
    jmodel = jax_build(num_classes=C, layers=(1, 1, 1, 1), droprate=0.0, multi_level=multi_level)
    variables = jmodel.init(jax.random.key(0), jnp.zeros((1, H, W, 3)), train=False)
    variables = jax.tree.map(np.asarray, dict(variables))
    jad = JaxAdapter(jmodel, variables, jcfg, jspec, num_classes=C)
    jad.calculate_prototypes([boot])

    tcfg = cfg_from_file(config)
    tspec = tcfg.METHOD.ADAPTATION[tcfg.METHOD.ADAPTATION.NAME]
    _configure(tcfg, tspec, str(tmp / "torch"), **spec_over)
    tmodel = build_deeplab_v2(C, (1, 1, 1, 1), "ProDA", multi_level=multi_level, droprate=0.0)
    tmodel.load_state_dict(flax_to_state_dict(variables), strict=True)
    tad = ProtoOnlineAdapter(tmodel, registry.variables_of(tmodel), tcfg, tspec, C, device="cpu")
    tad.calculate_prototypes([{"image": _nchw(boot["image"]), "label": torch.tensor(boot["label"])}])
    return jad, tad


def _jax_tree(collection, tree):
    return flax_to_torch_state_dict({collection: jax.tree.map(np.asarray, tree)})


def one_step(jad, tad, lr, seed=1):
    """One step of each adapter on the same source and target batch; returns
    (jax logs, port logs)."""
    rng = np.random.default_rng(seed)
    src, trg = _batch(rng), _batch(rng)
    jstep = jad.step_fn(have_src=True, source_repeat=1, want_soft=False)
    jad.state, jlogs = jstep(jad.state, jnp.asarray(trg["image"]), jnp.asarray(src["image"][None]),
                             jnp.asarray(src["label_res"][None]), jnp.asarray(lr, jnp.float32))
    tstep = tad.step_fn(True, 1, False)
    tad.state, tlogs = tstep(tad.state, _nchw(trg["image"]), _nchw(src["image"])[None],
                             torch.tensor(src["label_res"][None]).long(), lr)
    return dict(jlogs.items()), dict(tlogs.items())


def _assert_losses(jlogs, tlogs):
    assert jlogs["pseudolabel_pixel_num"] > 0
    for key in LOSSES:
        np.testing.assert_allclose(tlogs[key], jlogs[key], err_msg=key, **LOSS_TOL)


# ---------------------------------------------------------------------------
# the multi-level model: aux head skipped, zero gradient, weight decay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config", ["configs/offline_fog.yml", "configs/training_fog.yml"])
def test_multi_level_step_matches_jax(tmp_path, config):
    """One step of a multi-level model: the losses as JAX's, and the aux head
    `layer5`, which no loss reaches, moved by the weight decay alone (its
    momentum starts at zero: p ← p·(1 − lr_head·wd)) in both packages, its
    EMA copy with it. A large decay and LR make the decay visible in f32."""
    wd, ema, lr = 0.05, 0.5, 0.1
    jad, tad = make_pair(tmp_path, config, multi_level=True, WEIGHT_DECAY=wd, EMA_UPDATE=ema)
    assert tad.model.multi_level and jad.model.multi_level
    before = {k: v.clone() for k, v in tad.state.params.items() if k.startswith("layer5.")}
    assert before
    jlogs, tlogs = one_step(jad, tad, lr)
    _assert_losses(jlogs, tlogs)
    lr_head = lr * tad.lr_ratios[1]
    jparams, jema = _jax_tree("params", jad.state.params), _jax_tree("params", jad.state.ema_params)
    for key, p0 in before.items():
        want = p0 * (1.0 - lr_head * wd)
        torch.testing.assert_close(tad.state.params[key], want, rtol=1e-6, atol=1e-8, msg=key)
        np.testing.assert_allclose(tad.state.params[key].numpy(), jparams[key], err_msg=key,
                                   **TREE_TOL)
        torch.testing.assert_close(tad.state.ema_params[key], ema * p0 + (1 - ema) * want,
                                   rtol=1e-6, atol=1e-8, msg=key)
        np.testing.assert_allclose(tad.state.ema_params[key].numpy(), jema[key], err_msg=key,
                                   **TREE_TOL)
    # the main head did learn
    key = "layer6.head.1.weight"
    np.testing.assert_allclose(tad.state.params[key].numpy(), jparams[key], rtol=1e-4, atol=1e-5)


def test_aux_head_skipped_in_the_step_and_evaluation(tmp_path, monkeypatch):
    """The step, the bootstrap and evaluation never run the aux head."""
    cfg = cfg_from_file("configs/offline_fog.yml")
    spec = cfg.METHOD.ADAPTATION.PROTO_ONLINE
    _configure(cfg, spec, str(tmp_path))
    model = build_deeplab_v2(C, (1, 1, 1, 1), "ProDA", multi_level=True, droprate=0.0)
    ad = ProtoOnlineAdapter(model, registry.variables_of(model), cfg, spec, C, device="cpu")
    calls = []
    monkeypatch.setattr(model.layer5, "forward", lambda *a, **k: calls.append(1))
    rng = np.random.default_rng(3)
    src, trg = _batch(rng), _batch(rng)
    ad.calculate_prototypes([{"image": _nchw(src["image"]), "label": torch.tensor(src["label"])}])
    ad.state, logs = ad.step_fn(True, 1, False)(
        ad.state, _nchw(trg["image"]), _nchw(src["image"])[None],
        torch.tensor(src["label_res"][None]).long(), 1e-3)
    assert np.isfinite(logs["Total target loss"])
    ad.evaluate_all({"v": [{"image": _nchw(trg["image"]), "label": trg["label"]}]})
    assert not calls


def test_grads_zero_only_for_the_declared_unused():
    """optim.grads gives a zero gradient to a parameter declared unused and
    raises for any other parameter that no loss reaches."""
    from onda_torch.methods import optim

    live = {k: torch.full((2,), v, requires_grad=True) for k, v in (("a", 1.0), ("b", 2.0),
                                                                      ("c", 3.0))}
    loss = (live["a"] * live["a"]).sum()
    got = optim.grads(loss, live, ["a", "b"], unused={"b"})
    assert list(got) == ["a", "b"]
    torch.testing.assert_close(got["a"], torch.full((2,), 2.0))
    torch.testing.assert_close(got["b"], torch.zeros(2))
    loss = (live["a"] * live["a"]).sum()
    with pytest.raises(RuntimeError, match="not have been used in the graph"):
        optim.grads(loss, live, ["a", "c"])


# ---------------------------------------------------------------------------
# BN_POLICY double and keep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bn_policy", ["double", "keep"])
def test_bn_policy_step_matches_jax(tmp_path, bn_policy):
    """double: the source slice starts from alt_batch_stats and its update is
    the new alt set; keep: the source slice updates the main set, which the
    target slice then starts from. Losses, the head kernel, both BN sets."""
    jad, tad = make_pair(tmp_path, "configs/hybrid_switch.yml", BN_POLICY=bn_policy)
    stats0 = {k: v.clone() for k, v in tad.state.batch_stats.items()}
    jlogs, tlogs = one_step(jad, tad, 1e-3)
    _assert_losses(jlogs, tlogs)
    key = "layer6.head.1.weight"
    np.testing.assert_allclose(tad.state.params[key].numpy(),
                               _jax_tree("params", jad.state.params)[key], **TREE_TOL)
    for name, jtree, ttree in (("batch_stats", jad.state.batch_stats, tad.state.batch_stats),
                               ("alt_batch_stats", jad.state.alt_batch_stats,
                                tad.state.alt_batch_stats)):
        want = _jax_tree("batch_stats", jtree)
        for k, value in want.items():
            np.testing.assert_allclose(ttree[k].numpy(), value, err_msg=f"{name} {k}", **TREE_TOL)
    moved = [k for k in stats0 if k.endswith("running_mean")
             and not torch.equal(tad.state.alt_batch_stats[k], stats0[k])]
    assert bool(moved) == (bn_policy == "double")  # keep leaves the alt set alone


# ---------------------------------------------------------------------------
# AUTO_DYNAMIC
# ---------------------------------------------------------------------------

def _port_fired(trace):
    ours = object.__new__(ProtoOnlineAdapter)
    ours.cfg_spec = make_spec()
    ours.dynamic_update_counter = 0
    ours._copy_dynamic = lambda: None
    return [i for i, dev in enumerate(trace) if ours._maybe_update_dynamic(lambda: dev)]


def _jax_fired(trace):
    ours = object.__new__(JaxAdapter)
    ours.cfg_spec = make_spec()
    ours.dynamic_update_counter = 0
    ours.state = object()
    ours._copy_dynamic = lambda s: s
    return [i for i, dev in enumerate(trace) if ours._maybe_update_dynamic(lambda: dev)]


@pytest.mark.parametrize("trace", ["scripted", "noisy"])
def test_auto_dynamic_refresh_steps_match_jax(trace):
    if trace == "scripted":
        values = scripted_trace()
    else:
        values = (np.random.default_rng(11).standard_normal(4000) * 2e-4).tolist()
    fired = _port_fired(values)
    assert fired == _jax_fired(values)
    assert fired and (trace == "noisy" or fired == [503, 1005])


@pytest.mark.parametrize("auto_dynamic", [False, True])
def test_train_copies_the_dynamic_teacher_unless_auto_dynamic(tmp_path, monkeypatch, auto_dynamic):
    cfg = cfg_from_file("configs/hybrid_switch.yml")
    spec = cfg.METHOD.ADAPTATION.PROTO_ONLINE_HYBRIDSWITCH
    _configure(cfg, spec, str(tmp_path), AUTO_DYNAMIC=auto_dynamic, EPOCHS=0, SKIP_CALC=True)
    model = build_deeplab_v2(C, (1, 1, 1, 1), "ProDA", droprate=0.0)
    ad = ProtoOnlineAdapter(model, registry.variables_of(model), cfg, spec, C, device="cpu")
    monkeypatch.setattr(ad, "save_model", lambda: None)  # a 0.8 GB checkpoint, not tested here
    key = "layer6.head.1.weight"
    with torch.no_grad():
        ad.state.params[key].add_(1.0)
    ad.train(None, [_batch(np.random.default_rng(0))], {})
    copied = torch.equal(ad.state.dynamic_params[key], ad.state.params[key])
    assert copied != auto_dynamic


# ---------------------------------------------------------------------------
# PREDICTION_SAVE in adaptation
# ---------------------------------------------------------------------------

def test_prediction_save_dumps_match_jax(tmp_path, monkeypatch):
    """`train` over two target batches with PREDICTION_SAVE: one NCHW
    `batch-{i}.pt` of raw target logits per step under PREDICTION_SAVE/<set>,
    named and counted as JAX's, and equal to them."""
    jad, tad = make_pair(tmp_path, "configs/offline_fog.yml", EPOCHS=1, SKIP_CALC=True)
    rng = np.random.default_rng(4)
    batches = [_batch(rng) for _ in range(2)]
    for ad, name, conv in ((jad, "jax", lambda a: a), (tad, "torch", _nchw)):
        monkeypatch.setattr(ad, "save_model", lambda: None)  # checkpoints are not tested here
        ad.cfg.TRAINING.REPLAY_BUFFER = 0
        ad.cfg.OTHERS.GENERATE_SAMPLES_EVERY = 0
        ad.cfg_spec.PREDICTION_SAVE = str(tmp_path / f"pred_{name}")
        ad.cfg_spec.set_ = (25,)
        ad.update_cfg_spec(ad.cfg_spec)
        ad.train(None, [{"image": conv(b["image"])} for b in batches], {})
    jdir, tdir = tmp_path / "pred_jax" / "(_2_5_,_)", tmp_path / "pred_torch" / "(_2_5_,_)"
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == ["batch-0.pt", "batch-1.pt"]
    assert tad.prediction_counter == {(25,): 2}
    for i, tol in ((0, dict(rtol=1e-3, atol=2e-4)), (1, dict(rtol=1e-3, atol=1e-3))):
        got, want = torch.load(tdir / f"batch-{i}.pt"), torch.load(jdir / f"batch-{i}.pt")
        assert got.shape == want.shape == (B, C, HR, WR) and got.dtype == torch.float32
        # the forward's envelope (tests/test_torch_model.py) at step 0
        np.testing.assert_allclose(got.numpy(), want.numpy(), err_msg=f"batch-{i}", **tol)
