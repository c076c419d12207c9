"""ADVENT in the port against the JAX package: the entropy map and the
BCE-with-logits (values and gradients), Adam, the discriminators, the
diagonal Fisher, one ADVENT step with and without MULTI_LEVEL (losses, every
state tree, logged keys), the method's parity traps, AUTO_RESUME from
`advent_state.pt` and an EVALUATION runner lifting the student out of it.
Both packages start from the same weights (carried across by
onda_torch.models.convert) with Dropout2d off, R50 cut to one block a stage,
b2 at 32x64."""

import contextlib
import io
import os
import shutil
import time

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from onda_tpu.config import cfg_from_file as jax_cfg_from_file
from onda_tpu.config import default_config
from onda_tpu.models import build_deeplab_v2 as jax_build
from onda_tpu.models.import_torch import flax_to_torch_state_dict
from onda_torch import registry, train_ouda
from onda_torch.config import cfg_from_file
from onda_torch.methods import optim
from onda_torch.methods.advent import AdventAdapter, entropy_map
from onda_torch.models import build_deeplab_v2
from onda_torch.models.convert import flax_disc_to_state_dict, flax_to_state_dict
from onda_torch.models.discriminator import (DCGANDiscriminator, FCDiscriminator,
                                             seeded_fc_discriminator)
from onda_torch.ops import losses as L

B, H, W, C = 2, 32, 64, 19
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
TREE_TOL = dict(rtol=1e-4, atol=1e-6)
ADVENT_LOGS = {"Discriminator loss", "Segmentation loss", "Adversarial loss"}
# The gradient that reaches the backbone and the aux head passes
# normalisations whose variance is taken in one pass in f32 (E[x²] − E[x]²:
# JAX's `_bn_train_math` and flax's GroupNorm; K2 the same way), which loses
# most of its digits in a channel whose mean is far larger than its spread,
# over the 90 values a channel has at this size. There the two packages'
# gradients (the momentum after one step) agree to 5% of each tensor's
# largest entry (the worst seen: layer4.0's downsample in the PROTO_ADVENT
# step, one channel), and the parameters within atol 1e-5 (as
# tests/test_torch_segment.py holds SEGMENT's step); the main head is held
# to TREE_TOL.
WELL_CONDITIONED = ("layer6.",)
GRAD_ENVELOPE = 5e-2
PARAM_ENVELOPE = dict(rtol=1e-4, atol=1e-5)
# Adam's first step moves every weight by lr_d·g/(|g| + eps), ±lr_d where
# |g| >> eps: a gradient within rounding of 0 moves differently in the two
# packages, so the discriminators' weights are held within atol 1e-5 (lr_d
# is 1e-4 here)
DISC_TOL = dict(rtol=1e-4, atol=1e-5)


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


def _nchw(a):
    return torch.tensor(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return jnp.asarray(t.numpy().transpose(0, 2, 3, 1))


def batch(rng):
    return {"image": rng.normal(size=(B, H, W, 3)).astype(np.float32),
            "label": rng.integers(0, C, size=(B, H, W)).astype(np.int32)}


def configure(cfg, spec, snap, **spec_over):
    cfg.SCHEME.RESOLUTION = [W, H]
    cfg.OTHERS.SNAPSHOT_DIR = snap
    cfg.OTHERS.AOT_CACHE = False
    spec.LOAD_PROTO = None
    spec.set_ = "test"
    spec.PSEUDO_THRESH = 0.06  # random weights: keep some pixels above the threshold
    for key, value in spec_over.items():
        spec[key] = value


def jax_variables(multi_level):
    model = jax_build(num_classes=C, layers=(1, 1, 1, 1), droprate=0.0, multi_level=multi_level)
    variables = model.init(jax.random.key(0), jnp.zeros((1, H, W, 3)), train=False)
    return model, jax.tree.map(np.asarray, dict(variables))


def torch_model(variables, multi_level):
    model = build_deeplab_v2(C, (1, 1, 1, 1), "ProDA", multi_level=multi_level, droprate=0.0)
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return model


def jax_tree(collection, tree):
    return flax_to_torch_state_dict({collection: jax.tree.map(np.asarray, tree)})


def jax_disc(tree):
    return flax_disc_to_state_dict({"params": jax.tree.map(np.asarray, tree)})


def assert_tree(got: dict, want: dict, what: str, **tol):
    assert set(got) == set(want), what
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(v), err_msg=f"{what} {k}",
                                   **(tol or TREE_TOL))


def assert_student(params: dict, momentum: dict, jparams, jmomentum):
    """The student's parameters and momentum against JAX's (see WELL_CONDITIONED)."""
    want_p, want_m = jax_tree("params", jparams), jax_tree("params", jmomentum)
    assert set(params) == set(want_p) and set(momentum) == set(want_m)
    for k, v in want_p.items():
        ill = not k.startswith(WELL_CONDITIONED)
        np.testing.assert_allclose(params[k].numpy(), v, err_msg=f"params {k}",
                                   **(PARAM_ENVELOPE if ill else TREE_TOL))
        got = momentum[k].numpy()
        if ill:
            err = np.abs(got - want_m[k]).max() / max(np.abs(want_m[k]).max(), 1e-30)
            assert err <= GRAD_ENVELOPE, f"momentum {k}: {err}"
        else:
            np.testing.assert_allclose(got, want_m[k], err_msg=f"momentum {k}", **TREE_TOL)


def make_advent(tmp, multi_level=True, config="configs/advent.yml", **spec_over):
    cfg = cfg_from_file(config)
    spec = cfg.METHOD.ADAPTATION.ADVENT
    cfg.MODEL.MULTI_LEVEL = multi_level
    configure(cfg, spec, str(tmp), **spec_over)
    _, variables = jax_variables(multi_level)
    model = torch_model(variables, multi_level)
    return AdventAdapter(model, registry.variables_of(model), cfg, spec, C, device="cpu")


def tensors(b):
    return _nchw(b["image"]), torch.tensor(b["label"]).long()


# ---------------------------------------------------------------------------
# the pieces: losses, Adam, discriminators, Fisher
# ---------------------------------------------------------------------------

def test_prob_2_entropy_and_bce_match_jax():
    from onda_tpu.ops import losses as JL

    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 5, 6, C)).astype(np.float32) * 3
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    t = _nchw(probs).requires_grad_(True)
    got = L.prob_2_entropy(t)
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(JL.prob_2_entropy(jnp.asarray(probs))), rtol=1e-5, atol=1e-7)
    (g,) = torch.autograd.grad(got.sum(), t)
    jg = jax.grad(lambda p: JL.prob_2_entropy(p).sum())(jnp.asarray(probs))
    np.testing.assert_allclose(g.numpy().transpose(0, 2, 3, 1), np.asarray(jg), rtol=1e-5, atol=1e-6)
    x = rng.normal(size=(2, 1, 3, 4)).astype(np.float32) * 4
    for label in (0.0, 1.0):
        xt = torch.tensor(x, requires_grad=True)
        loss = L.bce_with_logits(xt, label)
        np.testing.assert_allclose(loss.detach().item(), float(JL.bce_with_logits(jnp.asarray(x), label)),
                                   rtol=1e-5)
        (g,) = torch.autograd.grad(loss, xt)
        jg = jax.grad(lambda v: JL.bce_with_logits(v, label))(jnp.asarray(x))
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-8)
        # torch's own BCE-with-logits is the same function
        want = F.binary_cross_entropy_with_logits(xt, torch.full_like(xt, label))
        torch.testing.assert_close(loss, want, rtol=1e-6, atol=1e-7)


def test_three_adam_updates_match_jax():
    from onda_tpu.methods import optim as jopt

    rng = np.random.default_rng(1)
    shapes = {"conv0.weight": (4, 3, 4, 4), "conv0.bias": (4,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jparams, jstate = params, jopt.adam_init(params)
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    tstate = optim.adam_init(tparams)
    for i in range(3):
        grads = {k: (rng.normal(size=s) * 10.0 ** -i).astype(np.float32) for k, s in shapes.items()}
        jparams, jstate = jopt.adam_update(jparams, grads, jstate, jnp.asarray(1e-3, jnp.float32))
        optim.adam_update(tparams, {k: torch.tensor(v) for k, v in grads.items()}, tstate, 1e-3)
    assert tstate["count"] == int(jstate["count"]) == 3
    for name, got, want in (("params", tparams, jparams), ("mu", tstate["mu"], jstate["mu"]),
                            ("nu", tstate["nu"], jstate["nu"])):
        assert_tree(got, want, name, rtol=1e-6, atol=1e-12)


def test_discriminators_match_jax():
    """FCDiscriminator and DCGANDiscriminator forwards (DCGAN in eval and in
    train mode, where its BatchNorm also updates the running buffers)."""
    from onda_tpu.models import discriminator as JD

    rng = np.random.default_rng(2)
    x = rng.random(size=(2, 64, 64, C)).astype(np.float32)
    fc = JD.FCDiscriminator()
    v = fc.init(jax.random.key(1), jnp.asarray(x))
    tfc = FCDiscriminator(C)
    tfc.load_state_dict(flax_disc_to_state_dict(v), strict=True)
    want = np.asarray(fc.apply(v, jnp.asarray(x)))
    got = tfc(_nchw(x)).detach().numpy().transpose(0, 2, 3, 1)
    assert got.shape == (2, 2, 2, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    dc = JD.DCGANDiscriminator()
    v = jax.tree.map(np.asarray, dict(dc.init(jax.random.key(2), jnp.asarray(x))))
    v["batch_stats"] = jax.tree.map(lambda s: s + rng.random(s.shape).astype(np.float32),
                                    v["batch_stats"])
    tdc = DCGANDiscriminator(C)
    tdc.load_state_dict(flax_disc_to_state_dict(v), strict=True)
    for train in (False, True):
        if train:
            want, mut = dc.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        else:
            want = dc.apply(v, jnp.asarray(x))
        got = tdc(_nchw(x), train=train).detach().numpy().transpose(0, 2, 3, 1)
        assert got.shape == (2, 1, 1, 1)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)
    buffers = {k: v for k, v in tdc.state_dict().items() if "running" in k}
    assert_tree(buffers, {k: v for k, v in flax_disc_to_state_dict(mut).items() if "running" in k},
                "DCGAN running buffers", rtol=1e-4, atol=1e-6)


def test_compute_fisher_and_ewc_match_jax():
    """The diagonal Fisher of a 1x1-conv model with 255 labels ignored, and
    EWC anchoring weighted by it."""
    from onda_tpu.ops import losses as JL

    rng = np.random.default_rng(3)
    images = rng.normal(size=(2, 5, 7, 8)).astype(np.float32)
    labels = rng.integers(0, 4, size=(2, 5, 7)).astype(np.int32)
    labels[0, :2] = 255
    params = {"w": rng.normal(size=(8, 4)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32),
              "unused": np.ones(3, np.float32)}
    want = JL.compute_fisher(lambda p, x: x @ p["w"] + p["b"],
                             {k: jnp.asarray(v) for k, v in params.items()},
                             jnp.asarray(images), jnp.asarray(labels))
    got = L.compute_fisher(
        lambda p, x: torch.einsum("nhwf,fc->nchw", x, p["w"]) + p["b"][None, :, None, None],
        {k: torch.tensor(v) for k, v in params.items()}, torch.tensor(images), torch.tensor(labels))
    assert_tree(got, want, "fisher", rtol=1e-5, atol=1e-9)
    assert float(got["w"].sum()) > 0 and not got["unused"].any()
    anchor = {k: torch.tensor(v) + 0.5 for k, v in params.items()}
    cur = {k: torch.tensor(v) for k, v in params.items()}
    janchor = {k: jnp.asarray(v.numpy()) for k, v in anchor.items()}
    for fishers, jfishers in ((got, want), (None, None)):
        np.testing.assert_allclose(float(L.ewc_loss(0.3, anchor, cur, fishers=fishers)),
                                   float(JL.ewc_loss(0.3, janchor, params, fishers=jfishers)),
                                   rtol=1e-5)
    # relabelling the ignored pixels changes nothing
    labels[0, :2] = 3
    relabelled = L.compute_fisher(
        lambda p, x: torch.einsum("nhwf,fc->nchw", x, p["w"]) + p["b"][None, :, None, None],
        {k: torch.tensor(v) for k, v in params.items()}, torch.tensor(images), torch.tensor(labels))
    assert not torch.allclose(relabelled["w"], got["w"])


# ---------------------------------------------------------------------------
# one ADVENT step against the JAX step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_level", [True, False], ids=["multi_level", "single_level"])
def test_advent_step_matches_jax(tmp_path, multi_level):
    from onda_tpu.methods.advent import AdventAdapter as JaxAdvent

    jcfg = jax_cfg_from_file("configs/advent.yml", default_config())
    jspec = jcfg.METHOD.ADAPTATION.ADVENT
    jcfg.MODEL.MULTI_LEVEL = multi_level
    configure(jcfg, jspec, str(tmp_path / "jax"))
    jmodel, variables = jax_variables(multi_level)
    jad = JaxAdvent(jmodel, variables, jcfg, jspec, num_classes=C)
    tad = make_advent(tmp_path / "torch", multi_level)
    tad.state.d_aux = jax_disc(jad.state.d_aux_params)
    tad.state.d_main = jax_disc(jad.state.d_main_params)
    d_aux0 = {k: v.clone() for k, v in tad.state.d_aux.items()}

    rng = np.random.default_rng(7)
    src, trg = batch(rng), batch(rng)
    lr, lr_d = 1e-3, 1e-4
    jad.state, jlogs = jad.step_fn()(
        jad.state, jnp.asarray(src["image"]), jnp.asarray(src["label"]), jnp.asarray(trg["image"]),
        jnp.asarray(lr, jnp.float32), jnp.asarray(lr_d, jnp.float32))
    src_img, src_lbl = tensors(src)
    tad.state, tlogs = tad.build_step()(tad.state, src_img, src_lbl, _nchw(trg["image"]), lr, lr_d)
    jlogs, tlogs = dict(jlogs.items()), dict(tlogs.items())
    assert set(tlogs) == set(jlogs) == ADVENT_LOGS
    for key in ADVENT_LOGS:
        np.testing.assert_allclose(tlogs[key], jlogs[key], err_msg=key, **LOSS_TOL)

    s, js = tad.state, jad.state
    assert s.step == int(js.step) == 1
    assert_student(s.params, s.opt_momentum, js.params, js.opt_momentum)
    stats = {k: v for k, v in s.batch_stats.items() if not k.endswith("num_batches_tracked")}
    assert_tree(stats, jax_tree("batch_stats", js.batch_stats), "batch_stats")
    for name, tree, opt, jtree, jopt in (("d_main", s.d_main, s.d_main_opt, js.d_main_params,
                                          js.d_main_opt),
                                         ("d_aux", s.d_aux, s.d_aux_opt, js.d_aux_params,
                                          js.d_aux_opt)):
        assert_tree(tree, jax_disc(jtree), name, **DISC_TOL)
        assert_tree(opt["mu"], jax_disc(jopt["mu"]), f"{name} mu")
        assert_tree(opt["nu"], jax_disc(jopt["nu"]), f"{name} nu")
        assert opt["count"] == int(jopt["count"]), name
    # trap 5: without MULTI_LEVEL the aux discriminator and its Adam state are untouched
    assert s.d_aux_opt["count"] == (1 if multi_level else 0)
    untouched = all(torch.equal(s.d_aux[k], d_aux0[k]) for k in d_aux0)
    assert untouched != multi_level
    if not multi_level:
        assert not any(t.any() for t in (*s.d_aux_opt["mu"].values(), *s.d_aux_opt["nu"].values()))


# ---------------------------------------------------------------------------
# parity traps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def advent_run(tmp_path_factory):
    """One multi-level ADVENT step and everything needed to recompute it by
    hand from the state before it."""
    tad = make_advent(tmp_path_factory.mktemp("advent"), True)
    before = {"params": {k: v.clone() for k, v in tad.state.params.items()},
              "stats": {k: v.clone() for k, v in tad.state.batch_stats.items()},
              "d_main": {k: v.clone() for k, v in tad.state.d_main.items()},
              "d_aux": {k: v.clone() for k, v in tad.state.d_aux.items()}}
    rng = np.random.default_rng(8)
    src, trg = tensors(batch(rng)), _nchw(batch(rng)["image"])
    tad.state, logs = tad.build_step()(tad.state, src[0], src[1], trg, 1e-3, 1e-4)
    return tad, before, src, trg, dict(logs.items())


def _forward_up(tad, params, stats, images):
    aux, main = torch.func.functional_call(tad.model, (params, stats), (images,), {
        "train": True, "update_stats": False, "with_aux": True})
    up = lambda o: F.interpolate(o["out"], size=(H, W), mode="bilinear", align_corners=True)  # noqa: E731
    return up(aux), up(main)


def test_advent_losses_are_at_full_resolution_with_pre_step_discriminators(advent_run):
    """Traps 3 and 4: seg is the CE of the upsampled logits against the
    full-resolution label; adv and the discriminator loss use the weights
    from before the step, the latter on the detached maps of the same pass;
    the discriminators' gradient is the discriminator loss's alone (Adam's
    first moment after one step is 0.1 x it) and the student's is seg + adv's
    alone (its momentum after one step is the gradient plus the decay)."""
    tad, before, (src_img, src_lbl), trg, logs = advent_run
    spec = tad.cfg_spec
    params = {k: v.clone().requires_grad_(True) for k, v in before["params"].items()}
    src_aux, src_main = _forward_up(tad, params, dict(before["stats"]), src_img)
    trg_aux, trg_main = _forward_up(tad, params, dict(before["stats"]), trg)
    seg = (spec.LAMBDA_SEG_MAIN * L.cross_entropy_2d(src_main, src_lbl)
           + spec.LAMBDA_SEG_AUX * L.cross_entropy_2d(src_aux, src_lbl))
    np.testing.assert_allclose(logs["Segmentation loss"], float(seg), rtol=1e-5)
    disc = lambda p, x: torch.func.functional_call(tad.disc, p, (x,))  # noqa: E731
    adv = (spec.LAMBDA_ADV_MAIN * L.bce_with_logits(disc(before["d_main"], entropy_map(trg_main)), 0.0)
           + spec.LAMBDA_ADV_AUX * L.bce_with_logits(disc(before["d_aux"], entropy_map(trg_aux)), 0.0))
    np.testing.assert_allclose(logs["Adversarial loss"], float(adv), rtol=1e-5)
    key = "layer6.head.1.weight"
    (g,) = torch.autograd.grad(seg + adv, [params[key]])
    torch.testing.assert_close(tad.state.opt_momentum[key],
                               g + spec.WEIGHT_DECAY * before["params"][key], rtol=1e-5, atol=1e-9)
    d_live = {k: v.clone().requires_grad_(True) for k, v in before["d_main"].items()}
    ent_src, ent_trg = entropy_map(src_main.detach()), entropy_map(trg_main.detach())
    d_main_loss = (L.bce_with_logits(disc(d_live, ent_src), 0.0) / 2
                   + L.bce_with_logits(disc(d_live, ent_trg), 1.0) / 2)
    d_aux_loss = (L.bce_with_logits(disc(before["d_aux"], entropy_map(src_aux.detach())), 0.0) / 2
                  + L.bce_with_logits(disc(before["d_aux"], entropy_map(trg_aux.detach())), 1.0) / 2)
    np.testing.assert_allclose(logs["Discriminator loss"], float(d_main_loss + d_aux_loss), rtol=1e-5)
    grads = torch.autograd.grad(d_main_loss, list(d_live.values()))
    for (k, _), gk in zip(d_live.items(), grads):
        torch.testing.assert_close(tad.state.d_main_opt["mu"][k], 0.1 * gk, rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("bn_policy", ["keep", "freeze", "double"])
def test_advent_ignores_bn_policy(advent_run, tmp_path, bn_policy):
    """Trap 1: the running statistics come from the target slice alone, as a
    train-mode forward of the target batch that updates them would leave
    them, and BN_POLICY (advent.yml says keep) changes nothing."""
    ref, before, (src_img, src_lbl), trg, _ = advent_run
    tad = make_advent(tmp_path, True, BN_POLICY=bn_policy)
    tad.state, _ = tad.build_step()(tad.state, src_img, src_lbl, trg, 1e-3, 1e-4)
    for k, v in ref.state.batch_stats.items():
        assert torch.equal(tad.state.batch_stats[k], v), k
    stats = {k: v.clone() for k, v in before["stats"].items()}
    with torch.no_grad():
        torch.func.functional_call(tad.model, (before["params"], stats), (trg,),
                                   {"train": True, "update_stats": True, "with_aux": False})
    for k, v in stats.items():
        torch.testing.assert_close(tad.state.batch_stats[k], v, rtol=1e-6, atol=1e-7, msg=k)
    moved = [k for k in stats if k.endswith("running_mean") and not torch.equal(stats[k],
                                                                               before["stats"][k])]
    assert moved


def test_discriminator_init_is_seeded(tmp_path):
    """Trap 8: d_aux from seed 1 and d_main from seed 2, the same in every
    adapter (the parity tests carry JAX's own draws across instead)."""
    one, two = make_advent(tmp_path / "a"), make_advent(tmp_path / "b")
    for name, seed in (("d_aux", 1), ("d_main", 2)):
        want = seeded_fc_discriminator(C, seed)
        for ad in (one, two):
            assert set(getattr(ad.state, name)) == set(want)
            assert all(torch.equal(getattr(ad.state, name)[k], v) for k, v in want.items()), name
    assert not torch.equal(one.state.d_aux["conv0.weight"], one.state.d_main["conv0.weight"])
    assert one.state.d_main["conv0.weight"].shape == (64, C, 4, 4)
    assert one.state.d_main["conv4.weight"].shape == (1, 512, 4, 4)


# ---------------------------------------------------------------------------
# checkpoints: AUTO_RESUME and EVALUATION of an ADVENT snapshot
# ---------------------------------------------------------------------------

def test_auto_resume_from_advent_state_is_exact(tmp_path):
    """Two steps, `advent_state.pt`, AUTO_RESUME into a fresh adapter, one
    more step: the same state as three steps in a row. The resume picks the
    ADVENT snapshot, not a newer `adapt_state.pt` of another method."""
    rng = np.random.default_rng(9)
    batches = [(tensors(batch(rng)), _nchw(batch(rng)["image"])) for _ in range(3)]
    lrs = (1e-3, 8e-4, 6e-4)

    def run(ad, which):
        step = ad.build_step()
        for i in which:
            (img, lbl), trg = batches[i]
            ad.state, logs = step(ad.state, img, lbl, trg, lrs[i], 1e-4)
        return dict(logs.items())

    straight = make_advent(tmp_path / "straight")
    want_logs = run(straight, range(3))
    first = make_advent(tmp_path / "snap")
    run(first, range(2))
    first.save_model()
    time.sleep(0.01)
    torch.save({"not": "advent"}, tmp_path / "snap" / "adapt_state.pt")
    resumed = make_advent(tmp_path / "snap")
    resumed.cfg.OTHERS.AUTO_RESUME = True
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cand = train_ouda.resume(resumed, resumed.cfg)
    assert cand.name == "advent_state.pt" and "AUTO_RESUME: restoring" in out.getvalue()
    assert resumed.state.step == 2
    got_logs = run(resumed, [2])
    assert got_logs == want_logs
    s, w = resumed.state, straight.state
    assert s.step == w.step == 3
    for name in ("params", "opt_momentum", "batch_stats", "d_aux", "d_main"):
        for k, v in getattr(w, name).items():
            assert torch.equal(getattr(s, name)[k], v), f"{name} {k}"
    for name in ("d_aux_opt", "d_main_opt"):
        assert getattr(s, name)["count"] == getattr(w, name)["count"] == 3
        for moment in ("mu", "nu"):
            for k, v in getattr(w, name)[moment].items():
                assert torch.equal(getattr(s, name)[moment][k], v), f"{name} {moment} {k}"


def test_evaluation_runner_lifts_the_student_of_an_advent_snapshot(tmp_path, capsys):
    """validation_offline_advent.yml's runner on an ADVENT run's directory:
    it picks `advent_state.pt` (the newest snapshot there) and takes the
    student's params and BN buffers from it; the teachers keep their own."""
    from onda_torch.methods.evaluation import EvaluationRunner

    ad = make_advent(tmp_path)
    with torch.no_grad():
        for v in ad.state.params.values():
            v.add_(1.0)
        for k, v in ad.state.batch_stats.items():
            if "running" in k:
                v.add_(2.0)
    ad.state.step = 5
    torch.save(ad.model.state_dict(), tmp_path / "model_train_[[0]]_after_src_training.pth")
    os.utime(tmp_path / "model_train_[[0]]_after_src_training.pth", (100, 100))
    ad.save_model()
    cfg = cfg_from_file("configs/validation_offline_advent.yml")
    spec = cfg.METHOD.ADAPTATION.PROTO_ONLINE.copy()
    spec.update(cfg.METHOD.PRETRAIN.EVALUATION)
    configure(cfg, spec, str(tmp_path))
    _, variables = jax_variables(True)
    model = torch_model(variables, True)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    capsys.readouterr()
    runner = EvaluationRunner(model, registry.variables_of(model), cfg, spec, C, device="cpu")
    assert f"Model {tmp_path / 'advent_state.pt'} is being loaded" in capsys.readouterr().out
    for k, v in ad.state.params.items():
        assert torch.equal(runner.state.params[k], v), k
        assert torch.equal(runner.state.ema_params[k], init[k]), k
    for k, v in ad.state.batch_stats.items():
        assert torch.equal(runner.state.batch_stats[k], v), k
    assert runner.state.step == 0
