"""Every option of `get_model` against the JAX package: OTHERS.PRECISION bf16,
OTHERS.REMAT, DeepLabv2-Resnet101, Microsoft ProDA's R101 layout (with and
without its bn_clr `bn_pretrain`) and the GroupNorm R50 backbone. Models are
built in both packages at 32x64 with Dropout2d off and the weights carried
across by `onda_torch.models.convert`; inputs come from a numpy seed. Each
tolerance below was measured on the CPU first, then stated."""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from onda_tpu.config import cfg_from_file as jax_cfg_from_file
from onda_tpu.config import default_config
from onda_tpu.methods import optim as jax_optim
from onda_tpu.methods.proto_online import ProtoOnlineAdapter as JaxAdapter
from onda_tpu.models import build_deeplab_v2 as jax_build
from onda_tpu.models.import_torch import (_flax_path_to_torch_key, flax_to_torch_state_dict,
                                          save_torch_checkpoint)
from onda_torch import registry
from onda_torch.config import cfg_from_file
from onda_torch.methods import optim
from onda_torch.methods.proto_online import ProtoOnlineAdapter
from onda_torch.methods.state import clone_tree
from onda_torch.models import build_deeplab_v2
from onda_torch.models.convert import flax_to_state_dict
from onda_torch.models.deeplabv2 import ResLayer
from onda_torch.models.layers import GroupNorm, TorchBatchNorm
from onda_torch.parallel import distributed, mesh

from .synthetic import make_synthetic_dataset
from .test_torch_cli import _main
from .test_torch_workflow import _workflow_cfg

B, H, W, C = 2, 32, 64, 19
HR, WR = H // 8 + 1, W // 8 + 1
TINY = (1, 1, 1, 1)
LOSSES = ("ce_loss", "rce_loss", "regularization_loss", "buff_ce_loss", "Total target loss")
# f32: the tolerances of tests/test_torch_model.py and tests/test_torch_step.py
FWD_TOL = dict(rtol=1e-3, atol=2e-4)
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
TREE_TOL = dict(rtol=1e-4, atol=1e-6)


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
    """The `.pth`, `.pt` and prototype pickles a test writes go when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _nchw(a):
    return torch.tensor(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _batch(rng):
    return {"image": rng.normal(size=(B, H, W, 3)).astype(np.float32),
            "label": rng.integers(0, C, size=(B, H, W)).astype(np.int32),
            "label_res": rng.integers(0, C, size=(B, HR, WR)).astype(np.int32)}


def jax_pair(dtype=None, **kw):
    """(JAX model, its variables as numpy) at TINY depth, Dropout2d off."""
    jmodel = jax_build(num_classes=C, layers=kw.pop("layers", TINY), droprate=0.0,
                       dtype=jnp.bfloat16 if dtype == "bf16" else None, **kw)
    variables = jmodel.init(jax.random.key(0), jnp.zeros((1, H, W, 3)), train=False)
    return jmodel, jax.tree.map(np.asarray, dict(variables))


def port_model(variables, dtype=None, **kw):
    """The port's model of the same build, loaded strictly from `variables`."""
    model = build_deeplab_v2(C, kw.pop("layers", TINY), "ProDA", droprate=0.0,
                             dtype=torch.bfloat16 if dtype == "bf16" else None, **kw)
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return model


def _error(got, want):
    """(max abs error, mean abs error), both over max |want|."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    scale = np.abs(np.asarray(want, np.float64)).max()
    return err.max() / scale, err.mean() / scale


def _configure(cfg, spec, snap, **spec_over):
    cfg.SCHEME.RESOLUTION = [W, H]
    cfg.OTHERS.SNAPSHOT_DIR = snap
    cfg.OTHERS.AOT_CACHE = False
    spec.LOAD_PROTO = None
    spec.set_ = "test"
    spec.PSEUDO_THRESH = 0.06  # random weights: keep some pixels above the threshold
    for key, value in spec_over.items():
        spec[key] = value


def adapters(tmp, jmodel, variables, tmodel, tvariables=None, **spec_over):
    """The hybrid_switch.yml adapters of both packages on the given models,
    prototypes bootstrapped from the same source batch."""
    boot = _batch(np.random.default_rng(0))
    jcfg = jax_cfg_from_file("configs/hybrid_switch.yml", default_config())
    jspec = jcfg.METHOD.ADAPTATION.PROTO_ONLINE_HYBRIDSWITCH
    _configure(jcfg, jspec, str(tmp / "jax"), **spec_over)
    jad = JaxAdapter(jmodel, variables, jcfg, jspec, num_classes=C)
    jad.calculate_prototypes([boot])
    tcfg = cfg_from_file("configs/hybrid_switch.yml")
    tspec = tcfg.METHOD.ADAPTATION.PROTO_ONLINE_HYBRIDSWITCH
    _configure(tcfg, tspec, str(tmp / "torch"), **spec_over)
    tad = ProtoOnlineAdapter(tmodel, tvariables or registry.variables_of(tmodel), tcfg, tspec, C,
                             device="cpu")
    tad.calculate_prototypes([{"image": _nchw(boot["image"]), "label": torch.tensor(boot["label"])}])
    return jad, tad


def one_step(jad, tad, lr=1e-3, seed=1):
    """One step of each adapter on the same batches; returns (jax logs, port logs)."""
    rng = np.random.default_rng(seed)
    src, trg = _batch(rng), _batch(rng)
    jstep = jad.step_fn(have_src=True, source_repeat=1, want_soft=False)
    jad.state, jlogs = jstep(jad.state, jnp.asarray(trg["image"]), jnp.asarray(src["image"][None]),
                             jnp.asarray(src["label_res"][None]), jnp.asarray(lr, jnp.float32))
    tad.state, tlogs = tad.step_fn(True, 1, False)(
        tad.state, _nchw(trg["image"]), _nchw(src["image"])[None],
        torch.tensor(src["label_res"][None]).long(), lr)
    return dict(jlogs.items()), dict(tlogs.items())


def _jax_tree(collection, tree):
    return flax_to_torch_state_dict({collection: jax.tree.map(np.asarray, tree)})


def _assert_f32_state(state):
    for tree in (state.params, state.opt_momentum, state.ema_params, state.static_params):
        assert all(v.dtype == torch.float32 for v in tree.values())
    assert all(v.dtype in (torch.float32, torch.int64) for v in state.batch_stats.values())


# ---------------------------------------------------------------------------
# the key layout of every model name at full depth
# ---------------------------------------------------------------------------

FULL = {"DeepLabv2-Resnet50": dict(layers=(3, 4, 6, 3)),
        "DeepLabv2-Resnet101": dict(layers=(3, 4, 23, 3)),
        "DeepLabv2-Resnet101-ProDA": dict(layers=(3, 4, 23, 3), proda_layout=True),
        "DeepLabv2-Resnet101-ProDA bn_clr": dict(layers=(3, 4, 23, 3), proda_layout=True,
                                                 bn_clr=True),
        "DeepLabv2-Resnet50-GN": dict(layers=(3, 4, 6, 3), group_norm_backbone=True)}


@pytest.mark.parametrize("name", list(FULL))
def test_state_dict_keys_match_jax_at_full_depth(name):
    """The port's state_dict keys are the JAX variables' paths mapped through
    the JAX importer (shapes only: `jax.eval_shape` of `init`, meta tensors
    for the port), plus a `num_batches_tracked` beside every BatchNorm; the GN
    backbone has none of either, and every key maps back through the
    port's `convert`."""
    kw = FULL[name]
    jmodel = jax_build(num_classes=C, classifier="ProDA", **kw)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, H, W, 3)),
                                                train=False))
    paths = [tuple(p.key for p in path) for path, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    want = {_flax_path_to_torch_key(p) for p in paths}
    with torch.device("meta"):
        model = build_deeplab_v2(C, classifier="ProDA", **kw)
    got = set(model.state_dict())
    counters = {k for k in got if k.endswith("num_batches_tracked")}
    assert got - counters == want
    assert counters == {k[: -len("running_mean")] + "num_batches_tracked"
                        for k in got if k.endswith("running_mean")}
    from onda_torch.models.convert import torch_key
    assert {torch_key(p) for p in paths} == want
    n_bn = sum(isinstance(m, TorchBatchNorm) for m in model.modules())
    assert n_bn == {"DeepLabv2-Resnet50": 53, "DeepLabv2-Resnet101": 104,
                    "DeepLabv2-Resnet101-ProDA": 104, "DeepLabv2-Resnet101-ProDA bn_clr": 105,
                    "DeepLabv2-Resnet50-GN": 0}[name]
    assert ("layer6.head.1.weight" in got) == (not kw.get("proda_layout", False))
    assert "layer5.head.1.weight" in got
    assert ("bn_pretrain.running_var" in got) == kw.get("bn_clr", False)


# ---------------------------------------------------------------------------
# get_model: every DeepLab-v2 name (registry.LAYERS) with both options
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [n for n in registry.MODEL_NAMES if n in registry.LAYERS])
def test_get_model_honours_precision_and_remat(name, monkeypatch):
    """Each name in f32 and bf16, REMAT on and off (depth cut to one block a
    stage): PRECISION "bf16"/"bfloat16" sets the compute dtype and nothing
    else does, REMAT only as the boolean true, and the parameters and buffers
    stay f32 either way."""
    monkeypatch.setitem(registry.LAYERS, name, TINY)
    for precision, remat in (("f32", False), ("bf16", True), ("bfloat16", False),
                             ({}, "true"), ("f16", True)):
        cfg = cfg_from_file("configs/hybrid_switch.yml")
        cfg.MODEL.NAME, cfg.MODEL.LOAD = name, None
        cfg.OTHERS.PRECISION, cfg.OTHERS.REMAT = precision, remat
        model, variables = registry.get_model(cfg, C, device="cpu")
        bf16 = precision in ("bf16", "bfloat16")
        assert model.compute_dtype == (torch.bfloat16 if bf16 else None)
        assert all(m.compute_dtype == model.compute_dtype for m in model.modules()
                   if hasattr(m, "compute_dtype"))
        assert {m.remat for m in model.modules() if isinstance(m, ResLayer)} == {remat is True}
        assert all(v.dtype == torch.float32 for v in variables["params"].values())
        proda, gn = name.endswith("-ProDA"), name.endswith("-GN")
        assert model.proda_layout == proda and not hasattr(model, "layer6") == proda
        assert any(isinstance(m, TorchBatchNorm) for m in model.modules()) == (not gn)
        assert gn == all(isinstance(m, GroupNorm) and m.f32_out
                         for m in (model.bn1, model.layer1[0].bn1))
        with torch.no_grad():
            _, main = model(torch.zeros(1, 3, H, W))
        assert main["out"].dtype == (torch.bfloat16 if bf16 else torch.float32)


# ---------------------------------------------------------------------------
# OTHERS.PRECISION: bf16
# ---------------------------------------------------------------------------

# measured on the CPU (R50 at one block a stage, b2 32x64; XLA:CPU's bf16
# convolutions against oneDNN's, both rounding the exact sum): the two bf16
# models agree bit for bit at the stem and drift apart by single-ulp flips
# through the backbone; over max |out|, the largest error is 1.4% in eval
# and 6.3% in train mode (batch statistics renormalise every flip), the mean
# 0.22% and 0.93%; the bounds are about 2x those
BF16_FWD = {False: (3e-2, 5e-3), True: (1.3e-1, 2e-2)}


@pytest.mark.parametrize("train", [False, True])
def test_bf16_forward_matches_jax(train, rng):
    jmodel, variables = jax_pair("bf16")
    tmodel = port_model(variables, "bf16")
    x = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    _, main = jax.jit(lambda v, xx: jmodel.apply(v, xx, train=train, update_stats=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        _, tmain = tmodel(_nchw(x), train=train, update_stats=False)
    max_bound, mean_bound = BF16_FWD[train]
    for key in ("out", "feat"):
        assert tmain[key].dtype == torch.bfloat16 and main[key].dtype == jnp.bfloat16
        worst, mean = _error(tmain[key].float().numpy(), _nchw(main[key].astype(jnp.float32)))
        assert worst < max_bound and mean < mean_bound, (key, worst, mean)
    assert all(v.dtype == torch.float32 for v in tmodel.state_dict().values()
               if v.is_floating_point())


def test_bf16_step_matches_jax(tmp_path):
    """One PROTO_ONLINE_HYBRIDSWITCH step of both packages in bf16: losses,
    pseudo-labels, the head's update and the running statistics; parameters,
    momentum, teachers and buffers stay f32."""
    jmodel, variables = jax_pair("bf16")
    tmodel = port_model(variables, "bf16")
    jad, tad = adapters(tmp_path, jmodel, variables, tmodel)
    before = tad.state.params["layer6.head.1.weight"].clone()
    jlogs, tlogs = one_step(jad, tad)
    _assert_f32_state(tad.state)
    assert jlogs["pseudolabel_pixel_num"] > 0
    # measured on the CPU: the losses differ by at most 0.34% relative (the CE term;
    # the forwards' bf16 drift, see BF16_FWD), the pseudo-labelled pixel
    # counts not at all (90 of 2 x 5 x 9); the head's update (max 2.5e-3) by
    # 4.6e-4 at worst and 2.1e-5 on average, the running statistics by
    # 1.7e-3 absolute and 0.53% of their largest entry at worst; the bounds are
    # 2-3x those (the JAX suite holds its own bf16 schedules at rtol 2e-2)
    for key in LOSSES:
        np.testing.assert_allclose(tlogs[key], jlogs[key], rtol=1e-2, atol=1e-3, err_msg=key)
    assert abs(tlogs["pseudolabel_pixel_num"] - jlogs["pseudolabel_pixel_num"]) <= 9
    jparams = _jax_tree("params", jad.state.params)
    key = "layer6.head.1.weight"
    step, jstep = (tad.state.params[key] - before).numpy(), jparams[key] - before.numpy()
    assert np.abs(step).max() > 1e-3
    assert np.abs(step - jstep).max() < 1e-3 and np.abs(step - jstep).mean() < 5e-5
    jstats = _jax_tree("batch_stats", jad.state.batch_stats)
    for k, v in jstats.items():
        np.testing.assert_allclose(tad.state.batch_stats[k].numpy(), v, rtol=1e-2, atol=5e-3,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# OTHERS.REMAT
# ---------------------------------------------------------------------------

def test_remat_step_is_exact(tmp_path, monkeypatch):
    """One step with REMAT on and off from the same start: losses, every
    gradient and the running statistics equal (rtol 1e-5, as
    tests/test_step.py holds JAX's remat). The state's tensors share no
    storage with the module's, whose own are NaN: a recompute that read them
    would poison the gradients. The running statistics move by one momentum
    update, as without REMAT."""
    _, variables = jax_pair()
    grads = {}
    real_grads = optim.grads

    def recording(loss, live, names, unused=()):
        out = real_grads(loss, live, names, unused)
        grads[len(grads)] = out
        return out

    monkeypatch.setattr(optim, "grads", recording)
    runs = {}
    for remat in (False, True):
        model = port_model(variables, remat=remat)
        cfg = cfg_from_file("configs/hybrid_switch.yml")
        spec = cfg.METHOD.ADAPTATION.PROTO_ONLINE_HYBRIDSWITCH
        _configure(cfg, spec, str(tmp_path / str(remat)))
        ad = ProtoOnlineAdapter(model, registry.variables_of(model), cfg, spec, C, device="cpu")
        boot = _batch(np.random.default_rng(0))
        ad.calculate_prototypes([{"image": _nchw(boot["image"]),
                                  "label": torch.tensor(boot["label"])}])
        s = ad.state
        ad.state = dataclasses.replace(
            s, params=clone_tree(s.params), batch_stats=clone_tree(s.batch_stats),
            ema_params=clone_tree(s.ema_params))
        with torch.no_grad():
            for t in [*model.parameters(), *model.buffers()]:
                if t.is_floating_point():
                    t.fill_(float("nan"))
        start = clone_tree(ad.state.batch_stats)
        rng = np.random.default_rng(1)
        src, trg = _batch(rng), _batch(rng)
        ad.state, logs = ad.step_fn(True, 1, False)(
            ad.state, _nchw(trg["image"]), _nchw(src["image"])[None],
            torch.tensor(src["label_res"][None]).long(), 1e-3)
        runs[remat] = (dict(logs.items()), grads[len(grads) - 1], ad.state.batch_stats, start)
    (l0, g0, s0, start), (l1, g1, s1, _) = runs[False], runs[True]
    for key in LOSSES:
        np.testing.assert_allclose(l1[key], l0[key], rtol=1e-5, atol=1e-7, err_msg=key)
    assert set(g0) == set(g1) and all(torch.isfinite(g).all() for g in g1.values())
    for k, g in g0.items():
        torch.testing.assert_close(g1[k], g, rtol=1e-5, atol=1e-7, msg=k)
    moved = 0
    for k, v in s0.items():
        torch.testing.assert_close(s1[k], v, rtol=1e-5, atol=1e-7, msg=k)
        moved += not torch.equal(v, start[k])
    assert moved > 0


# ---------------------------------------------------------------------------
# DeepLabv2-Resnet101
# ---------------------------------------------------------------------------

def test_r101_forward_matches_jax(rng):
    """At full depth (3, 4, 23, 3): both forwards took 13.6 s on the CPU, JAX's
    compile of 23 blocks most of it. Eval mode holds at the f32 tolerance;
    in train mode the 23 blocks' one-pass batch variances compound the two
    packages' rounding: measured 7.4e-4 of max |out| at most, 1.3e-4 on
    average, bounded at about 2.5x those."""
    jmodel, variables = jax_pair(layers=(3, 4, 23, 3))
    tmodel = port_model(variables, layers=(3, 4, 23, 3))
    x = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    for train in (False, True):
        _, main = jax.jit(lambda v, xx: jmodel.apply(v, xx, train=train, update_stats=False))(
            variables, jnp.asarray(x))
        with torch.no_grad():
            _, tmain = tmodel(_nchw(x), train=train, update_stats=False)
        for key in ("out", "feat"):
            got, want = tmain[key].numpy(), _nchw(main[key]).numpy()
            if train:
                worst, mean = _error(got, want)
                assert worst < 2e-3 and mean < 3e-4, (key, worst, mean)
            else:
                np.testing.assert_allclose(got, want, err_msg=key, **FWD_TOL)


# ---------------------------------------------------------------------------
# DeepLabv2-Resnet101-ProDA, from a checkpoint in Microsoft ProDA's container
# ---------------------------------------------------------------------------

PRODA = "DeepLabv2-Resnet101-ProDA"


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "bn_clr"])
def proda(request, tmp_path_factory):
    """The JAX ProDA-layout model (one block a stage) written as a `.pth` in
    the `{"ResNet101": {"model_state": sd}}` container, loaded by the port's
    `get_model` from MODEL.LOAD of a multi-level config; then one step of
    each package."""
    bn_clr = request.param
    tmp = tmp_path_factory.mktemp("proda")
    jmodel, variables = jax_pair(proda_layout=True, bn_clr=bn_clr)
    bare = str(tmp / "bare.pth")
    save_torch_checkpoint(variables, bare)
    path = str(tmp / "proda_r101.pth")
    torch.save({"ResNet101": {"model_state": torch.load(bare)}, "iteration": 0}, path)
    os.remove(bare)

    cfg = cfg_from_file("configs/hybrid_switch.yml")
    cfg.MODEL.NAME, cfg.MODEL.LOAD, cfg.MODEL.MULTI_LEVEL = PRODA, path, True
    mp = pytest.MonkeyPatch()
    mp.setitem(registry.LAYERS, PRODA, TINY)
    try:
        tmodel, tvariables = registry.get_model(cfg, C, device="cpu")
    finally:
        mp.undo()
    multi_level = cfg.MODEL.MULTI_LEVEL
    loaded = {k: v.clone() for k, v in tmodel.state_dict().items()}
    tmodel.layer5.head[0].rate = 0.0  # Dropout2d off, as in the JAX model
    x = np.random.default_rng(3).normal(size=(B, H, W, 3)).astype(np.float32)
    forwards = {}
    for train in (False, True):
        _, main = jax.jit(lambda v, xx: jmodel.apply(v, xx, train=train, update_stats=False))(
            variables, jnp.asarray(x))
        with torch.no_grad():
            _, tmain = tmodel(_nchw(x), train=train, update_stats=False)
        forwards[train] = ({k: _nchw(v).numpy() for k, v in main.items()},
                           {k: v.numpy() for k, v in tmain.items()})
    jad, tad = adapters(tmp, jmodel, variables, tmodel, tvariables)
    before = clone_tree(tad.state.params)
    jlogs, tlogs = one_step(jad, tad)
    yield {"bn_clr": bn_clr, "model": tmodel, "multi_level": multi_level, "loaded": loaded,
           "forwards": forwards,
           "before": before, "jlogs": jlogs, "tlogs": tlogs, "tad": tad,
           "jparams": _jax_tree("params", jad.state.params), "variables": variables}
    shutil.rmtree(tmp, ignore_errors=True)


def test_proda_checkpoint_loads_through_get_model(proda):
    """bn_clr is read off the checkpoint's `bn_pretrain.` keys, MULTI_LEVEL is
    forced off, the only head is `layer5`, and every tensor came from the
    container's state_dict."""
    model = proda["model"]
    assert proda["multi_level"] is False and not model.multi_level
    assert (model.bn_pretrain is not None) == proda["bn_clr"]
    assert not hasattr(model, "layer6") and model.proda_layout
    want, got = flax_to_state_dict(proda["variables"]), proda["loaded"]
    assert set(got) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("train", [False, True])
def test_proda_forward_matches_jax(proda, train):
    want, got = proda["forwards"][train]
    for key in ("out", "feat"):
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **FWD_TOL)


def test_proda_step_trains_layer5_and_bn_pretrain(proda):
    """`layer5` is the main head and `bn_pretrain` sits in the head's LR group:
    after one step both moved, by JAX's update."""
    jlogs, tlogs, tad = proda["jlogs"], proda["tlogs"], proda["tad"]
    assert jlogs["pseudolabel_pixel_num"] > 0
    for key in LOSSES:
        np.testing.assert_allclose(tlogs[key], jlogs[key], err_msg=key, **LOSS_TOL)
    labels = tad.param_labels
    heads = [k for k in labels if k.startswith(("layer5.", "bn_pretrain."))]
    assert heads and all(labels[k] == optim.HEAD for k in heads)
    assert ("bn_pretrain.weight" in heads) == proda["bn_clr"]
    before, after, jparams = proda["before"], tad.state.params, proda["jparams"]
    for key in ("layer5.head.1.weight", "layer5.bottleneck.1.weight",
                *(["bn_pretrain.weight", "bn_pretrain.bias"] if proda["bn_clr"] else [])):
        assert not torch.equal(after[key], before[key]), key
        np.testing.assert_allclose((after[key] - before[key]).numpy(),
                                   jparams[key] - before[key].numpy(), rtol=2e-3, atol=1e-7,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# DeepLabv2-Resnet50-GN
# ---------------------------------------------------------------------------

# measured on the CPU, bf16 (see BF16_FWD; eager JAX, jitted): 1.4% (2.1%) of max
# |out| at most, 0.28% (0.43%) on average
GN_BF16 = (5e-2, 1e-2)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_gn_forward_matches_jax(precision, rng):
    """The GroupNorm backbone, train and eval (no batch statistics: the same
    forward). In bf16 its GroupNorms return f32, as the JAX model's, and the
    head's return bf16."""
    dtype = precision if precision == "bf16" else None
    jmodel, variables = jax_pair(dtype, group_norm_backbone=True)
    assert "batch_stats" not in variables
    tmodel = port_model(variables, dtype, group_norm_backbone=True)
    assert not any(isinstance(m, TorchBatchNorm) for m in tmodel.modules())
    seen = {}
    for name in ("bn1", "layer1.0.bn3", "layer4.0.downsample.1", "layer6.bottleneck.2"):
        tmodel.get_submodule(name).register_forward_hook(
            lambda m, a, o, name=name: seen.__setitem__(name, o.dtype))
    x = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    (_, main), inter = jmodel.apply(variables, jnp.asarray(x), train=True, update_stats=False,
                                    capture_intermediates=True)
    with torch.no_grad():
        _, tmain = tmodel(_nchw(x), train=True, update_stats=False)
    backbone_gn = inter["intermediates"]["layer1"]["0"]["bn3"]["gn"]["__call__"][0]
    head_gn = inter["intermediates"]["layer6"]["bottleneck_gn"]["gn"]["__call__"][0]
    head_dtype = torch.bfloat16 if dtype else torch.float32
    assert backbone_gn.dtype == jnp.float32
    assert head_gn.dtype == (jnp.bfloat16 if dtype else jnp.float32)
    assert seen == {"bn1": torch.float32, "layer1.0.bn3": torch.float32,
                    "layer4.0.downsample.1": torch.float32, "layer6.bottleneck.2": head_dtype}
    for key in ("out", "feat"):
        assert tmain[key].dtype == head_dtype
        got, want = tmain[key].float().numpy(), _nchw(main[key].astype(jnp.float32)).numpy()
        if dtype:
            worst, mean = _error(got, want)
            assert worst < GN_BF16[0] and mean < GN_BF16[1], (key, worst, mean)
        else:
            np.testing.assert_allclose(got, want, err_msg=key, **FWD_TOL)


def test_gn_step_matches_jax(tmp_path):
    """One hybrid step of the GN model: no BatchNorm buffers anywhere in the
    state, the losses and head update as JAX's, the backbone's GroupNorm
    affines frozen and the head's trained, as JAX labels them."""
    jmodel, variables = jax_pair(group_norm_backbone=True)
    tmodel = port_model(variables, group_norm_backbone=True)
    jad, tad = adapters(tmp_path, jmodel, variables, tmodel)
    s = tad.state
    assert not (s.batch_stats or s.alt_batch_stats or s.static_batch_stats or s.dynamic_batch_stats)
    before = clone_tree(s.params)
    jlogs, tlogs = one_step(jad, tad)
    assert jlogs["pseudolabel_pixel_num"] > 0
    for key in LOSSES:
        np.testing.assert_allclose(tlogs[key], jlogs[key], err_msg=key, **LOSS_TOL)
    jparams = _jax_tree("params", jad.state.params)
    for key in ("layer6.head.1.weight", "layer6.conv2d_list.0.1.weight"):
        np.testing.assert_allclose(tad.state.params[key].numpy(), jparams[key], rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    for key in ("bn1.weight", "layer1.0.bn2.bias", "layer2.0.downsample.1.weight"):
        assert tad.param_labels[key] == optim.FROZEN
        torch.testing.assert_close(tad.state.params[key], before[key], rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["gn", "proda_bn_clr"])
def test_param_labels_match_jax(kind):
    """The optimizer's labels of every parameter as JAX's `label_params`
    gives them: the GN backbone's `bn*` and `downsample.1` affines FROZEN,
    ProDA's `bn_pretrain` in the head group."""
    kw = {"gn": dict(group_norm_backbone=True),
          "proda_bn_clr": dict(proda_layout=True, bn_clr=True)}[kind]
    _, variables = jax_pair(**kw)
    jlabels = jax_optim.label_params(variables["params"], aux_grad=False)
    want = {_flax_path_to_torch_key(("params", *(p.key for p in path))): int(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jlabels)[0]}
    with torch.device("meta"):
        model = build_deeplab_v2(C, TINY, "ProDA", **kw)
    got = optim.label_params(dict(model.named_parameters()), aux_grad=False)
    assert got == want


# ---------------------------------------------------------------------------
# an option the port lacks stops the CLI before SEGMENT trains
# ---------------------------------------------------------------------------

def _segment_cfg(tmp_path, **over):
    """training_fog.yml cut to one SEGMENT epoch on the synthetic fog dataset."""
    root, snap = str(tmp_path / "ds"), str(tmp_path / "snaps")
    make_synthetic_dataset(root, intensities=(0, 25), per_domain=2, size_wh=(128, 64))
    os.rename(os.path.join(root, "metadata.json"), os.path.join(root, "metadata_fog.json"))
    cfg = _workflow_cfg(tmp_path / "seg.yml", "configs/training_fog.yml", root, snap, **{
        "METHOD.PRETRAIN.SEGMENT.EPOCHS": 1, **over})
    return cfg, snap


@pytest.mark.parametrize("option", ["DATA_PARALLEL"])
def test_segment_config_refuses_unported_options_before_training(tmp_path, option):
    """OTHERS.DATA_PARALLEL true in one process is the JAX package's
    one-device path (one device: no mesh), so the same config trains and
    saves; its refusal across ranks is in tests/test_torch_parallel.py.
    OTHERS.TENSOR_PARALLEL is ported too
    (`test_segment_config_resolves_a_grid_under_tensor_parallel`)."""
    cfg, snap = _segment_cfg(tmp_path, **{f"OTHERS.{option}": True})
    _main(cfg)
    assert os.path.isfile(os.path.join(snap, "model_train_[[0]].pth"))


def test_segment_config_resolves_a_grid_under_tensor_parallel(monkeypatch):
    """OTHERS.TENSOR_PARALLEL no longer stops SEGMENT training:
    training_fog.yml with it at 2 on two ranks resolves to a (1 × 2) grid,
    data axis 1, with no I/O (the world set without a process group; the run
    itself is tests/test_torch_tensor_parallel_adversarial.py's), and True
    is refused by JAX's guard before anything trains."""
    monkeypatch.setattr(distributed, "world", lambda: 2)
    cfg = cfg_from_file("configs/training_fog.yml")
    cfg.TRAINING.BATCH_SIZE = 2
    cfg.OTHERS.TENSOR_PARALLEL = 2
    assert int(cfg.METHOD.PRETRAIN.SEGMENT.EPOCHS) > 0
    assert mesh.data_axis(cfg) == 1 and mesh.grid_shape(2, 2) == (1, 2)
    cfg.OTHERS.TENSOR_PARALLEL = True
    with pytest.raises(ValueError, match="integer"):
        mesh.data_axis(cfg)


def test_segment_config_with_async_save_trains_and_saves(tmp_path):
    """OTHERS.ASYNC_SAVE is ported: the same cut SEGMENT config trains, and the
    CLI returns with its `.pth` whole and loadable (no write left in flight)."""
    cfg, snap = _segment_cfg(tmp_path, **{"OTHERS.ASYNC_SAVE": True})
    _main(cfg)
    assert not [f for f in os.listdir(snap) if f.startswith(".")]
    sd = torch.load(os.path.join(snap, "model_train_[[0]].pth"), weights_only=False)
    model = build_deeplab_v2(C, registry.LAYERS["DeepLabv2-Resnet50"], "ProDA", multi_level=True)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
