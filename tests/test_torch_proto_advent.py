"""PROTO_ADVENT in the port against the JAX package: one step (losses, every
state tree, the logged keys) from the same weights, prototypes and
discriminators, and the method's parity traps: the double-BN exchange
whatever BN_POLICY says, losses at their resolutions, the keys and work it
skips, the end-only checkpoint without the discriminators and a resume that
restarts them. R50 cut to one block a stage, Dropout2d off, b2 at 32x64."""

import contextlib
import io
import shutil

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from onda_tpu.config import cfg_from_file as jax_cfg_from_file
from onda_tpu.config import default_config
from onda_tpu.methods.proto_advent import ProtoAdventAdapter as JaxProtoAdvent
from onda_torch import registry, train_ouda
from onda_torch.config import cfg_from_file
from onda_torch.methods.proto_advent import ProtoAdventAdapter
from onda_torch.methods.proto_online import MONITOR_KEYS
from onda_torch.models.discriminator import seeded_fc_discriminator
from onda_torch.ops import losses as L

from .test_torch_advent import (C, DISC_TOL, LOSS_TOL, TREE_TOL, W, H, _nchw, assert_student,
                                assert_tree, batch, configure, jax_disc, jax_tree, jax_variables,
                                tensors, torch_model)

CONFIG = "configs/proto_advent.yml"
PROTO_TOL = dict(rtol=1e-4, atol=1e-5)
LOSSES = ("Segmentation loss", "Adversarial loss", "Discriminator loss", "ce_loss", "rce_loss",
          "sym_loss", "regularization_loss", "Total target loss")
# proto_advent.py:255-263: PROTO_ONLINE's step logs these too, PROTO_ADVENT's does not
NOT_LOGGED = ("encoder_lr", "output & prototype agreement", "dynamic forward fired",
              "model exp confidence ma", "buff_ce_loss", "model regularization")


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """The `.pt`, `.pth` and prototype pickles a test writes (up to 1.2 GB
    each) go when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def boot_batch():
    return batch(np.random.default_rng(0))


def make_port(tmp, variables=None, **spec_over):
    cfg = cfg_from_file(CONFIG)
    spec = cfg.METHOD.ADAPTATION.PROTO_ADVENT
    configure(cfg, spec, str(tmp), **spec_over)
    if variables is None:
        _, variables = jax_variables(False)
    model = torch_model(variables, False)
    ad = ProtoAdventAdapter(model, registry.variables_of(model), cfg, spec, C, device="cpu")
    boot = boot_batch()
    ad.calculate_prototypes([{"image": _nchw(boot["image"]), "label": torch.tensor(boot["label"])}])
    return ad


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One PROTO_ADVENT step of each package from the same start."""
    tmp = tmp_path_factory.mktemp("proto_advent")
    jcfg = jax_cfg_from_file(CONFIG, default_config())
    jspec = jcfg.METHOD.ADAPTATION.PROTO_ADVENT
    configure(jcfg, jspec, str(tmp / "jax"))
    jmodel, variables = jax_variables(False)
    jad = JaxProtoAdvent(jmodel, variables, jcfg, jspec, num_classes=C)
    jad.calculate_prototypes([boot_batch()])
    tad = make_port(tmp / "torch", variables)
    for name in ("aux", "main"):
        tad.d_state[name] = jax_disc(jad.d_state[name])
    before = {"params": {k: v.clone() for k, v in tad.state.params.items()},
              "alt": {k: v.clone() for k, v in tad.state.alt_batch_stats.items()},
              "d_aux": {k: v.clone() for k, v in tad.d_state["aux"].items()},
              "d_main": {k: v.clone() for k, v in tad.d_state["main"].items()}}
    rng = np.random.default_rng(5)
    src, trg = batch(rng), batch(rng)
    lr, lr_d = 1e-5, 1e-4  # proto_advent.yml's LEARNING_RATE (LR_RATIO 80:10)
    step = jad._build_pa_step()
    jad.state, jad.d_state, jlogs = step(
        jad.state, jad.d_state, jnp.asarray(src["image"]), jnp.asarray(src["label"]),
        jnp.asarray(trg["image"]), jnp.asarray(lr, jnp.float32), jnp.asarray(lr_d, jnp.float32))
    src_img, src_lbl = tensors(src)
    tad.state, tad.d_state, tlogs = tad.pa_step_fn()(tad.state, tad.d_state, src_img, src_lbl,
                                                     _nchw(trg["image"]), lr, lr_d)
    yield {"jad": jad, "tad": tad, "jlogs": dict(jlogs.items()), "tlogs": dict(tlogs.items()),
           "before": before, "src": (src_img, src_lbl), "trg": _nchw(trg["image"])}
    shutil.rmtree(tmp, ignore_errors=True)  # the bootstrap's prototype pickles


def test_step_logs_match_jax(runs):
    """Losses at LOSS_TOL and the exact key set of proto_advent.py:255-263
    (trap 7: none of PROTO_ONLINE's extra keys; no "model" monitor sample, so
    its moving average still reads its initial 1)."""
    jlogs, tlogs = runs["jlogs"], runs["tlogs"]
    assert set(tlogs) == set(jlogs)
    want = set(LOSSES) | {"JS Divergance loss", "pseudolabel_pixel_num",
                          "mean_prototype_intensity_values", "dev avg prior static"} | {
        f"{k} confidence ma" for k in MONITOR_KEYS}
    assert set(tlogs) == want and not set(NOT_LOGGED) & set(tlogs)
    assert jlogs["pseudolabel_pixel_num"] > 0
    for key in LOSSES:
        np.testing.assert_allclose(tlogs[key], jlogs[key], err_msg=key, **LOSS_TOL)
    for key in ("pseudolabel_pixel_num", "mean_prototype_intensity_values"):
        np.testing.assert_allclose(tlogs[key], jlogs[key], rtol=1e-4, err_msg=key)
    assert tlogs["model confidence ma"] == jlogs["model confidence ma"] == 1.0


def test_step_state_matches_jax(runs):
    """Student, momentum, both BN sets, EMA, prototypes, both discriminators
    and their Adam states; without MULTI_LEVEL (proto_advent.yml) the aux
    discriminator and its Adam state are untouched (trap 5)."""
    s, js, tad, jad = runs["tad"].state, runs["jad"].state, runs["tad"], runs["jad"]
    assert s.step == int(js.step) == 1
    assert_student(s.params, s.opt_momentum, js.params, js.opt_momentum)
    for name, tree, jtree in (("batch_stats", s.batch_stats, js.batch_stats),
                              ("alt_batch_stats", s.alt_batch_stats, js.alt_batch_stats)):
        got = {k: v for k, v in tree.items() if not k.endswith("num_batches_tracked")}
        assert_tree(got, jax_tree("batch_stats", jtree), name)
    ema = jax_tree("params", js.ema_params)
    assert_tree(s.ema_params, ema, "ema_params")
    # the prototypes as tests/test_torch_step.py holds step 0's
    for field in ("mean", "sq_mean", "count"):
        np.testing.assert_allclose(getattr(s.proto, field).numpy(),
                                   np.asarray(getattr(js.proto, field)), err_msg=field, **PROTO_TOL)
    np.testing.assert_allclose(float(s.proto.tau), float(js.proto.tau), rtol=1e-7)
    assert_tree(tad.d_state["main"], jax_disc(jad.d_state["main"]), "d_main", **DISC_TOL)
    for name in ("main_opt", "aux_opt"):
        assert tad.d_state[name]["count"] == int(jad.d_state[name]["count"]), name
        for moment in ("mu", "nu"):
            assert_tree(tad.d_state[name][moment], jax_disc(jad.d_state[name][moment]),
                        f"{name} {moment}")
    assert tad.d_state["main_opt"]["count"] == 1 and tad.d_state["aux_opt"]["count"] == 0
    before = runs["before"]["d_aux"]
    assert all(torch.equal(tad.d_state["aux"][k], v) for k, v in before.items())


def test_losses_at_their_resolutions(runs):
    """Trap 3: seg is the CE of the upsampled source logits (the source slice
    on the alt BN set) against the full-resolution label; the target losses
    stay at feature resolution (the MRKLD regularizer of the 5x9 logits)."""
    tad, before = runs["tad"], runs["before"]
    src_img, src_lbl = runs["src"]
    stats = {k: v.clone() for k, v in before["alt"].items()}
    with torch.no_grad():
        _, main = torch.func.functional_call(tad.model, (before["params"], stats), (src_img,), {
            "train": True, "update_stats": False, "with_aux": False})
        up = F.interpolate(main["out"], size=(H, W), mode="bilinear", align_corners=True)
        seg = tad.cfg_spec.LAMBDA_SEG_MAIN * L.cross_entropy_2d(up, src_lbl)
        _, trg_main = torch.func.functional_call(tad.model, (before["params"], stats),
                                                 (runs["trg"],), {"train": True,
                                                                  "update_stats": False,
                                                                  "with_aux": False})
    assert trg_main["out"].shape[2:] == (H // 8 + 1, W // 8 + 1)
    np.testing.assert_allclose(runs["tlogs"]["Segmentation loss"], float(seg), rtol=1e-5)
    np.testing.assert_allclose(runs["tlogs"]["regularization_loss"],
                               float(L.regular_loss("MRKLD", trg_main["out"])), rtol=1e-5)


@pytest.mark.parametrize("bn_policy", ["keep", "double"])
def test_double_bn_exchange_whatever_bn_policy(runs, tmp_path, bn_policy):
    """Trap 2: the source slice runs on alt_batch_stats and its update is the
    new alt set, as under the shipped `BN_POLICY: freeze`; another BN_POLICY
    gives the same step from the same start."""
    tad, before = runs["tad"], runs["before"]
    moved = [k for k, v in before["alt"].items()
             if k.endswith("running_mean") and not torch.equal(tad.state.alt_batch_stats[k], v)]
    assert moved
    other = make_port(tmp_path, BN_POLICY=bn_policy)
    for name in ("aux", "main"):
        other.d_state[name] = {k: v.clone() for k, v in before[f"d_{name}"].items()}
    src_img, src_lbl = runs["src"]
    other.state, other.d_state, logs = other.pa_step_fn()(other.state, other.d_state, src_img,
                                                          src_lbl, runs["trg"], 1e-5, 1e-4)
    for name in ("batch_stats", "alt_batch_stats", "params"):
        for k, v in getattr(tad.state, name).items():
            assert torch.equal(getattr(other.state, name)[k], v), f"{name} {k}"
    assert dict(logs.items()) == runs["tlogs"]


def test_checkpoint_at_the_end_only_and_resume_restarts_the_discriminators(tmp_path, monkeypatch):
    """Trap 6: `train` over two epochs writes `adapt_state.pt` once, at the
    end, without the discriminators; AUTO_RESUME restores the AdaptState and
    the discriminators start again from their seeded init (trap 8's seeds)."""
    ad = make_port(tmp_path, EPOCHS=2, SKIP_CALC=True)
    ad.cfg.OTHERS.GENERATE_SAMPLES_EVERY = 0
    saves = []
    save = ad.save_model
    monkeypatch.setattr(ad, "save_model", lambda: saves.append(ad.state.step) or save())
    rng = np.random.default_rng(6)
    source = [{"image": _nchw(b["image"]), "label": torch.tensor(b["label"])}
              for b in (batch(rng), batch(rng))]
    ad.train(source, [{"image": _nchw(batch(rng)["image"])}], {})
    assert saves == [2] and ad.state.step == 2
    assert ad.d_state["main_opt"]["count"] == 2
    trained = {k: v.clone() for k, v in ad.d_state["main"].items()}
    payload = torch.load(tmp_path / "adapt_state.pt", weights_only=False)
    assert not {"d_main", "d_aux", "d_state"} & set(payload)
    resumed = make_port(tmp_path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cand = train_ouda.resume(resumed, resumed.cfg)
    assert cand.name == "adapt_state.pt" and resumed.skip_proto
    assert resumed.state.step == 2
    for k, v in ad.state.params.items():
        assert torch.equal(resumed.state.params[k], v), k
    for name, seed in (("aux", 1), ("main", 2)):
        want = seeded_fc_discriminator(C, seed)
        assert all(torch.equal(resumed.d_state[name][k], v) for k, v in want.items()), name
        assert resumed.d_state[f"{name}_opt"]["count"] == 0
    assert not all(torch.equal(trained[k], v) for k, v in resumed.d_state["main"].items())
