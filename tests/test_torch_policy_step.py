"""The port's adaptation step against the JAX step under the three policies
the hybrid test (tests/test_torch_step.py) does not reach: `base` as
static_model.yml (static teacher only) and dynamic_model.yml (the dynamic
teacher every step), `hswitch` as confidence_switch.yml and `vswitch` as
confidence_der_switch.yml. Built as tests/test_torch_step.py builds the
hybrid pair: one bottleneck a stage, Dropout2d off on both sides, the JAX
weights carried across by onda_torch.models.convert, the same bootstrap batch
and the same step inputs from a numpy seed. The switch decisions must be the
same at every step; the numbers are held at the bounds of the hybrid test."""

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

from .test_torch_step import B, C, H, LOSSES, W, _batch, _configure, _nchw

STEPS = 3  # the steps held to the numeric bounds
CONFIGS = {"static_model": "PROTO_ONLINE", "dynamic_model": "PROTO_ONLINE",
           "confidence_switch": "PROTO_ONLINE_HSWITCH",
           "confidence_der_switch": "PROTO_ONLINE_VSWITCH"}
# case → (config, spec cuts, steps). The derivative of the static confidence
# is 0 until the monitor's window (AVG_MONITOR_SIZE, 200 as shipped) fills, so
# the vswitch never moves in a few steps as shipped; with a window of 2 it
# decides on the derivative from the second step on, and over six steps it
# goes to the dynamic teacher and back
CASES = {name: (name, {}, STEPS) for name in CONFIGS}
CASES["confidence_der_switch_window_2"] = ("confidence_der_switch", {"AVG_MONITOR_SIZE": 2}, 6)
# the monitor readings the policies decide on
POLICY_KEYS = ("prior static confidence ma", "dev avg prior static",
               "percentage_static confidence ma", "prior dynamic confidence ma")


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


def _switch(state):
    return int(np.asarray(state.switch.current)), int(np.asarray(state.switch.current_dev))


def _pair(case, tmp_path_factory):
    """Both adapters of the case's config from the same weights, bootstrapped
    on the same batch, through STEPS steps; returns per step (logs, prototypes,
    head kernel, switch state) of each."""
    name, cuts, n_steps = CASES[case]
    jax_snap, torch_snap = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("torch")
    rng = np.random.default_rng(0)
    boot = _batch(rng)
    steps = [(_batch(rng), _batch(rng)) for _ in range(n_steps)]
    method = CONFIGS[name]

    jcfg = jax_cfg_from_file(f"configs/{name}.yml", default_config())
    jspec = jcfg.METHOD.ADAPTATION[method]
    _configure(jcfg, jspec, str(jax_snap))
    for key, value in cuts.items():
        jspec[key] = value
    jmodel = jax_build(num_classes=C, layers=(1, 1, 1, 1), droprate=0.0)
    variables = jmodel.init(jax.random.key(0), jnp.zeros((1, H, W, 3)), train=False)
    variables = jax.tree.map(np.asarray, dict(variables))
    jad = JaxAdapter(jmodel, variables, jcfg, jspec, num_classes=C)
    jad.calculate_prototypes([boot])
    jstep = jad.step_fn(have_src=True, source_repeat=1, want_soft=False)

    tcfg = cfg_from_file(f"configs/{name}.yml")
    tspec = tcfg.METHOD.ADAPTATION[method]
    _configure(tcfg, tspec, str(torch_snap))
    for key, value in cuts.items():
        tspec[key] = value
    tmodel = build_deeplab_v2(C, (1, 1, 1, 1), "ProDA", droprate=0.0)
    tmodel.load_state_dict(flax_to_state_dict(variables), strict=True)
    tad = ProtoOnlineAdapter(tmodel, registry.variables_of(tmodel), tcfg, tspec, C, device="cpu")
    tad.calculate_prototypes([{"image": _nchw(boot["image"]), "label": torch.tensor(boot["label"])}])
    tstep = tad.step_fn(True, 1, False)

    out = {"jax": [], "torch": [], "policy": (jad.policy, tad.policy)}
    for src, trg in steps:
        jad.state, jlogs = jstep(jad.state, jnp.asarray(trg["image"]), jnp.asarray(src["image"][None]),
                                 jnp.asarray(src["label_res"][None]), jnp.asarray(1e-3, jnp.float32))
        out["jax"].append((dict(jlogs.items()), np.asarray(jad.state.proto.mean),
                           np.asarray(jad.state.params["layer6"]["head_conv"]["kernel"]),
                           _switch(jad.state)))
        tad.state, tlogs = tstep(tad.state, _nchw(trg["image"]), _nchw(src["image"])[None],
                                 torch.tensor(src["label_res"][None]).long(), 1e-3)
        out["torch"].append((dict(tlogs.items()), tad.state.proto.mean.numpy().copy(),
                             tad.state.params["layer6.head.1.weight"].numpy().copy(),
                             _switch(tad.state)))
    for snap in (jax_snap, torch_snap):  # the bootstrap's prototype pickles
        shutil.rmtree(snap, ignore_errors=True)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _pair(name, tmp_path_factory)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(CASES))
def test_policy_step_matches_jax(runs, name):
    out = runs(name)
    assert out["policy"][0] == out["policy"][1]
    jlogs, jmean, jkern, jswitch = out["jax"][0]
    tlogs, tmean, tkern, tswitch = out["torch"][0]
    assert set(tlogs) == set(jlogs)
    assert jlogs["pseudolabel_pixel_num"] > 0  # the hard-label path is exercised
    for key in LOSSES + POLICY_KEYS:
        np.testing.assert_allclose(tlogs[key], jlogs[key], rtol=1e-4, atol=1e-6, err_msg=key)
    # pseudo-labels: agreement >= 0.999 of the pixels (ties at the threshold may flip)
    assert abs(tlogs["pseudolabel_pixel_num"] - jlogs["pseudolabel_pixel_num"]) <= 0.001 * B * (
        H // 8 + 1) * (W // 8 + 1)
    np.testing.assert_allclose(tmean, jmean, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tkern, jkern.transpose(3, 2, 0, 1), rtol=1e-4, atol=1e-6)
    # later steps: test_torch_step.py::test_later_steps_stay_close's bounds
    for i in range(1, STEPS):
        jlogs, jmean, jkern, _ = out["jax"][i]
        tlogs, tmean, tkern, _ = out["torch"][i]
        for key in LOSSES:
            np.testing.assert_allclose(tlogs[key], jlogs[key], rtol=2e-3, atol=1e-5,
                                       err_msg=f"step {i} {key}")
        np.testing.assert_allclose(tmean, jmean, rtol=0, atol=4e-5)
        np.testing.assert_allclose(tkern, jkern.transpose(3, 2, 0, 1), rtol=0, atol=6e-4)


@pytest.mark.parametrize("name", list(CASES))
def test_policy_takes_the_jax_switch_decisions(runs, name):
    """The dynamic teacher ran, and the switch state, at every step as in JAX."""
    out = runs(name)
    jfired = [float(j[0]["dynamic forward fired"]) for j in out["jax"]]
    tfired = [float(t[0]["dynamic forward fired"]) for t in out["torch"]]
    assert tfired == jfired
    assert [t[3] for t in out["torch"]] == [j[3] for j in out["jax"]]
    if name == "static_model":
        assert jfired == [0.0] * STEPS
    if name == "dynamic_model":
        assert jfired == [1.0] * STEPS
    if name == "confidence_der_switch_window_2":  # both teachers were chosen
        assert set(jfired) == {0.0, 1.0}
