"""The port's adaptation step against the JAX step: both adapters start from
the same weights (carried across by onda_torch.models.convert), bootstrap the
prototypes from the same source batch and take the same steps on the same
inputs, with Dropout2d off on both sides (build_deeplab_v2(droprate=0.0))."""

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
from onda_torch import registry
from onda_torch.config import cfg_from_file
from onda_torch.methods.proto_online import ProtoOnlineAdapter
from onda_torch.models import build_deeplab_v2
from onda_torch.models.convert import flax_to_state_dict

B, H, W, C = 2, 32, 64, 19
HR, WR = H // 8 + 1, W // 8 + 1
STEPS = 3
LOSSES = ("ce_loss", "rce_loss", "regularization_loss", "buff_ce_loss", "Total target loss")


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """The `.pt`, `.pth` and prototype pickles a test writes (up to 1.2 GB
    each) go when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _configure(cfg, spec, snap):
    cfg.SCHEME.RESOLUTION = [W, H]
    cfg.OTHERS.SNAPSHOT_DIR = snap
    spec.LOAD_PROTO = None
    spec.set_ = "test"
    spec.PSEUDO_THRESH = 0.06  # random weights: keep some pixels above the threshold


def _batch(rng):
    return {"image": rng.normal(size=(B, H, W, 3)).astype(np.float32),
            "label": rng.integers(0, C, size=(B, H, W)).astype(np.int32),
            "label_res": rng.integers(0, C, size=(B, HR, WR)).astype(np.int32)}


def _nchw(a):
    return torch.tensor(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_snap, torch_snap = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("torch")
    rng = np.random.default_rng(0)
    boot = _batch(rng)
    steps = [(_batch(rng), _batch(rng)) for _ in range(STEPS)]

    jcfg = jax_cfg_from_file("configs/hybrid_switch.yml", default_config())
    jspec = jcfg.METHOD.ADAPTATION.PROTO_ONLINE_HYBRIDSWITCH
    _configure(jcfg, jspec, str(jax_snap))
    jmodel = jax_build(num_classes=C, layers=(1, 1, 1, 1), droprate=0.0)
    variables = jmodel.init(jax.random.key(0), jnp.zeros((1, H, W, 3)), train=False)
    variables = jax.tree.map(np.asarray, dict(variables))
    jad = JaxAdapter(jmodel, variables, jcfg, jspec, num_classes=C)
    jad.calculate_prototypes([boot])
    jstep = jad.step_fn(have_src=True, source_repeat=1, want_soft=False)

    tcfg = cfg_from_file("configs/hybrid_switch.yml")
    tspec = tcfg.METHOD.ADAPTATION.PROTO_ONLINE_HYBRIDSWITCH
    _configure(tcfg, tspec, str(torch_snap))
    tmodel = build_deeplab_v2(C, (1, 1, 1, 1), "ProDA", droprate=0.0)
    tmodel.load_state_dict(flax_to_state_dict(variables), strict=True)
    tad = ProtoOnlineAdapter(tmodel, registry.variables_of(tmodel), tcfg, tspec, C, device="cpu")
    tad.calculate_prototypes([{"image": _nchw(boot["image"]), "label": torch.tensor(boot["label"])}])
    tstep = tad.step_fn(True, 1, False)

    out = {"jax": [], "torch": [],
           "boot": (np.asarray(jad.state.proto.mean), tad.state.proto.mean.numpy().copy())}
    for src, trg in steps:
        jad.state, jlogs = jstep(jad.state, jnp.asarray(trg["image"]), jnp.asarray(src["image"][None]),
                                 jnp.asarray(src["label_res"][None]), jnp.asarray(1e-3, jnp.float32))
        out["jax"].append((dict(jlogs.items()), np.asarray(jad.state.proto.mean),
                           np.asarray(jad.state.params["layer6"]["head_conv"]["kernel"])))
        tad.state, tlogs = tstep(tad.state, _nchw(trg["image"]), _nchw(src["image"])[None],
                                 torch.tensor(src["label_res"][None]).long(), 1e-3)
        out["torch"].append((dict(tlogs.items()), tad.state.proto.mean.numpy().copy(),
                             tad.state.params["layer6.head.1.weight"].numpy().copy()))
    yield out
    for snap in (jax_snap, torch_snap):  # the bootstrap's prototype pickles
        shutil.rmtree(snap, ignore_errors=True)


def test_bootstrap_prototypes_match(runs):
    jmean, tmean = runs["boot"]
    np.testing.assert_allclose(tmean, jmean, rtol=1e-4, atol=1e-5)


def test_log_keys_match(runs):
    assert set(runs["torch"][0][0]) == set(runs["jax"][0][0])


def test_step0_matches_tightly(runs):
    jlogs, jmean, jkern = runs["jax"][0]
    tlogs, tmean, tkern = runs["torch"][0]
    assert jlogs["pseudolabel_pixel_num"] > 0  # the hard-label path is exercised
    for key in LOSSES:
        np.testing.assert_allclose(tlogs[key], jlogs[key], rtol=1e-4, atol=1e-6, err_msg=key)
    # pseudo-labels: agreement >= 0.999 of the pixels (ties at the threshold may flip)
    assert abs(tlogs["pseudolabel_pixel_num"] - jlogs["pseudolabel_pixel_num"]) <= 0.001 * B * HR * WR
    assert tlogs["output & prototype agreement"] == pytest.approx(
        jlogs["output & prototype agreement"], abs=0.001 + 1.0 / (B * HR * WR))
    assert tlogs["dynamic forward fired"] == jlogs["dynamic forward fired"]
    np.testing.assert_allclose(tmean, jmean, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tkern, jkern.transpose(3, 2, 0, 1), rtol=1e-4, atol=1e-6)


def test_later_steps_stay_close(runs):
    # the trajectories drift apart chaotically (backbone LR ×80): measured at
    # step 2, losses differ by up to 5.3e-4 relative, the head kernel by
    # 1.6e-4 absolute (of values up to 0.14) and the prototypes by 1.0e-5;
    # the bounds below are about 4× those
    for i in range(1, STEPS):
        jlogs, jmean, jkern = runs["jax"][i]
        tlogs, tmean, tkern = runs["torch"][i]
        for key in LOSSES:
            np.testing.assert_allclose(tlogs[key], jlogs[key], rtol=2e-3, atol=1e-5,
                                       err_msg=f"step {i} {key}")
        np.testing.assert_allclose(tmean, jmean, rtol=0, atol=4e-5)
        np.testing.assert_allclose(tkern, jkern.transpose(3, 2, 0, 1), rtol=0, atol=6e-4)


def test_save_and_load_model_round_trip(tmp_path):
    cfg = cfg_from_file("configs/hybrid_switch.yml")
    spec = cfg.METHOD.ADAPTATION.PROTO_ONLINE_HYBRIDSWITCH
    _configure(cfg, spec, str(tmp_path))
    model = build_deeplab_v2(C, (1, 1, 1, 1), "ProDA", droprate=0.0)
    ad = ProtoOnlineAdapter(model, registry.variables_of(model), cfg, spec, C, device="cpu")
    ad.state.proto.count += 3.0
    ad.save_model()
    assert (tmp_path / "proto_test.pickle").exists()
    key = "layer6.head.1.weight"
    saved = ad.state.params[key].clone()
    gen_draw = torch.rand(3, generator=ad.state.generator)
    with torch.no_grad():
        ad.state.params[key].add_(1.0)
    ad.load_model(str(tmp_path / "adapt_state.pt"))
    torch.testing.assert_close(ad.state.params[key], saved, rtol=0, atol=0)
    torch.testing.assert_close(ad.state.proto.count, torch.full((C,), 3.0), rtol=0, atol=0)
    torch.testing.assert_close(torch.rand(3, generator=ad.state.generator), gen_draw, rtol=0, atol=0)
