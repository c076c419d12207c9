"""The port's switch policies and SGD against the JAX package: the four
policies driven by the scripted confidence traces of tests/test_policies.py,
`label_params` on the model's parameter names, and one SGD update."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from onda_tpu.methods import optim as JO
from onda_tpu.models import build_deeplab_v2 as jax_build
from onda_torch.config import Config
from onda_torch.methods import optim as TO
from onda_torch.methods.prior_policy import compute_prior
from onda_torch.methods.state import init_switch
from onda_torch.models.convert import torch_key
from onda_torch.ops.monitor import Monitor

from .test_policies import B, C, H, KEYS, W, _random_walk, run_policy, spec_for

TRACES = {
    "falling": [0.95, 0.95, 0.95, 0.5, 0.5, 0.5, 0.5],
    "rise_fall": [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.5, 0.4, 0.3, 0.2, 0.1],
    "gray": [0.95, 0.92, 0.89, 0.87, 0.86, 0.85, 0.85],
    "walk0": _random_walk(0),
    "walk1": _random_walk(1),
}


def run_port_policy(policy, spec, trace, dev_window):
    mon = Monitor(KEYS, limit=dev_window)
    prior_ema = torch.zeros((B, C, H, W))
    prior_static = torch.full((B, C, H, W), 1.0 / C)
    dyn_val = torch.full((B, C, H, W), 0.5)
    mstate, sw = mon.init(), init_switch()
    calcs, currents, p0 = [], [], []
    for v in trace:
        mstate = mon.add(mstate, "prior static", v)
        prior, _, calc, sw, _ = compute_prior(policy, spec, mon, mstate, sw, prior_ema,
                                              prior_static, lambda: dyn_val, frozen=False)
        calcs.append(bool(calc))
        currents.append(int(sw.current))
        p0.append(float(prior[0, 0, 0, 0]))
    return np.array(calcs), np.array(currents), np.array(p0)


@pytest.mark.parametrize("trace", sorted(TRACES))
@pytest.mark.parametrize("policy,thresh", [
    ("base", 0.86), ("base", 0.0), ("hswitch", 0.86), ("hswitch_soft", 0.86),
    ("vswitch", 0.003), ("hybrid", None)])
def test_policy_decisions_match_jax(policy, thresh, trace):
    jspec = spec_for(policy)
    if thresh is not None:
        jspec.SWITCH_PRIOR_THRESH = thresh
    tspec = Config(dict(jspec))
    name = "hswitch" if policy == "hswitch_soft" else policy
    want = run_policy(name, jspec, TRACES[trace], dev_window=4)
    got = run_port_policy(name, tspec, TRACES[trace], dev_window=4)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def params():
    model = jax_build(num_classes=19, layers=(1, 1, 1, 1))
    variables = model.init(jax.random.key(0), jnp.zeros((1, 32, 64, 3)), train=False)
    flat = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    return {tuple(p.key for p in path): np.asarray(v) for path, v in flat}


@pytest.mark.parametrize("aux_grad", [False, True])
def test_label_params_match_jax(params, aux_grad):
    jtree = {}
    for path, v in params.items():
        node = jtree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    jlabels = JO.label_params(jtree, aux_grad=aux_grad)
    want = {torch_key(("params",) + tuple(p.key for p in path)): lab
            for path, lab in jax.tree_util.tree_flatten_with_path(jlabels)[0]}
    got = TO.label_params({k: None for k in want}, aux_grad=aux_grad)
    assert got == want
    assert {0, 1, 3, 4, -1} == set(got.values())


def test_sgd_update_matches_jax(params, rng):
    keys = list(params)
    p = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
    g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
    m = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
    nest = lambda flat: {"/".join(k): jnp.asarray(v) for k, v in flat.items()}  # noqa: E731
    labels = TO.label_params({torch_key(("params",) + k): None for k in keys}, aux_grad=False)
    jlabels = {"/".join(k): labels[torch_key(("params",) + k)] for k in keys}
    new_p, new_m = JO.update(nest(p), nest(g), nest(m), jlabels, 8e-3, 1e-3, 0.9, 1e-4)
    tp = {torch_key(("params",) + k): torch.tensor(v) for k, v in p.items()}
    tg = {torch_key(("params",) + k): torch.tensor(v) for k, v in g.items()}
    tm = {torch_key(("params",) + k): torch.tensor(v) for k, v in m.items()}
    TO.update(tp, tg, tm, labels, 8e-3, 1e-3, 0.9, 1e-4)
    for k in keys:
        tk = torch_key(("params",) + k)
        np.testing.assert_allclose(tp[tk].numpy(), np.asarray(new_p["/".join(k)]), rtol=1e-6,
                                   atol=1e-7, err_msg=tk)
        np.testing.assert_allclose(tm[tk].numpy(), np.asarray(new_m["/".join(k)]), rtol=1e-6,
                                   atol=1e-7, err_msg=tk)
    assert TO.lr_poly(1e-3, 5, 10, 0.0) == 1e-3
    assert TO.lr_poly(1e-3, 5, 10, 0.9) == pytest.approx(float(JO.lr_poly(1e-3, 5, 10, 0.9)))
