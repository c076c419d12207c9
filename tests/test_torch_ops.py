"""The port's ops against the JAX package on the same numpy inputs: the
prototype engine (pickles in both formats included), the losses with their
gradients against jax.grad (soft-CE quirk included), the monitor, the resizes
and the metrics. JAX holds maps NHWC, the port NCHW."""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from onda_tpu.ops import interp as JI
from onda_tpu.ops import losses as JL
from onda_tpu.ops import metrics as JM
from onda_tpu.ops import prototypes as JP
from onda_tpu.ops.monitor import Monitor as JMonitor
from onda_torch.ops import interp as TI
from onda_torch.ops import losses as TL
from onda_torch.ops import metrics as TM
from onda_torch.ops import prototypes as TP
from onda_torch.ops.monitor import Monitor as TMonitor

C, F = 19, 32
N, H, W = 2, 5, 9


def _nchw(a):
    return torch.tensor(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _states(rng):
    mean = rng.normal(size=(C, F)).astype(np.float32)
    sq = (mean**2 + rng.random(size=(C, F))).astype(np.float32)
    count = rng.integers(1, 40, size=C).astype(np.float32)
    j = JP.init_state(C, F).replace(mean=jnp.asarray(mean), sq_mean=jnp.asarray(sq),
                                    count=jnp.asarray(count))
    t = TP.init_state(C, F).replace(mean=torch.tensor(mean), sq_mean=torch.tensor(sq),
                                    count=torch.tensor(count))
    return j, t


# --- prototypes ------------------------------------------------------------

def test_prototype_moments_and_updates(rng):
    js, ts = _states(rng)
    feat = rng.normal(size=(300, F)).astype(np.float32)
    scores = rng.normal(size=(300, C)).astype(np.float32)
    j_oh, t_oh = JP.onehot_assign(jnp.asarray(scores)), TP.onehot_assign(torch.tensor(scores))
    np.testing.assert_array_equal(t_oh.numpy(), np.asarray(j_oh))
    j_m = JP.class_moments(jnp.asarray(feat), j_oh)
    t_m = TP.class_moments(torch.tensor(feat), t_oh)
    for a, b in zip(t_m, j_m):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    for jn, tn in ((JP.append(js, *j_m), TP.append(ts, *t_m)),
                   (JP.ma(js, *j_m, 0.99), TP.ma(ts, *t_m, 0.99))):
        for field in ("mean", "sq_mean", "count"):
            np.testing.assert_allclose(getattr(tn, field).numpy(), np.asarray(getattr(jn, field)),
                                       rtol=1e-5, atol=1e-6, err_msg=field)
    np.testing.assert_allclose(TP.global_var(ts).numpy(), np.asarray(JP.global_var(js)), rtol=1e-5)
    np.testing.assert_allclose(TP.prototype_var(ts).numpy(), np.asarray(JP.prototype_var(js)),
                               rtol=1e-5)


@pytest.mark.parametrize("metric", ["euclidean", "mahalanobis"])
def test_prototype_pseudo_labels(rng, metric):
    js, ts = _states(rng)
    feat = rng.normal(size=(300, F)).astype(np.float32)
    prior = rng.random(size=(300, C)).astype(np.float32)
    j_d = JP.distances(jnp.asarray(feat), js, metric)
    t_d = TP.distances(torch.tensor(feat), ts, metric)
    np.testing.assert_allclose(t_d.numpy(), np.asarray(j_d), rtol=1e-4, atol=1e-4)
    j_p, t_p = JP.proto_probs(j_d, 0.7), TP.proto_probs(t_d, 0.7)
    np.testing.assert_allclose(t_p.numpy(), np.asarray(j_p), rtol=1e-4, atol=1e-5)
    j_f, t_f = JP.fuse_prior(j_p, jnp.asarray(prior)), TP.fuse_prior(t_p, torch.tensor(prior))
    np.testing.assert_allclose(t_f.numpy(), np.asarray(j_f), rtol=1e-4, atol=1e-5)
    assert (TP.hard_labels(t_f, 0.2).numpy() == np.asarray(JP.hard_labels(j_f, 0.2))).mean() > 0.99


@pytest.mark.parametrize("fmt", ["port_to_jax", "jax_to_port", "legacy"])
def test_prototype_pickles(rng, tmp_path, fmt):
    import pickle

    js, ts = _states(rng)
    path = str(tmp_path / "proto.pickle")
    if fmt == "port_to_jax":
        TP.save(ts, path)
        got, ok = JP.load(JP.init_state(C, F), path)
        want = ts
    elif fmt == "jax_to_port":
        JP.save(js, path)
        got, ok = TP.load(TP.init_state(C, F), path)
        want = js
    else:  # the reference's 2-tuple (prototypes, counter), torch tensors inside
        with open(path, "wb") as f:
            pickle.dump((torch.tensor(np.asarray(js.mean)), torch.tensor(np.asarray(js.count))), f)
        got, ok = TP.load(TP.init_state(C, F), path)
        jgot, _ = JP.load(JP.init_state(C, F), path)
        np.testing.assert_array_equal(got.sq_mean.numpy(), np.asarray(jgot.sq_mean))
        want = js
    assert ok
    for field in ("mean", "count"):
        np.testing.assert_array_equal(np.asarray(getattr(got, field)), np.asarray(getattr(want, field)))
    missing, ok = TP.load(ts, os.path.join(str(tmp_path), "absent.pickle"))
    assert not ok and missing is ts


# --- losses ----------------------------------------------------------------

def _labels(rng):
    lbl = rng.integers(0, C, size=(N, H, W)).astype(np.int32)
    lbl[0, 0, :4] = 255
    return lbl


LOSS_CASES = ["ce", "ce_soft", "rce", "rce_soft", "js", "MRENT", "MRKLD"]


@pytest.mark.parametrize("case", LOSS_CASES)
def test_loss_values_and_grads(rng, case):
    logits = rng.normal(size=(N, H, W, C)).astype(np.float32)
    hard = _labels(rng)
    soft = rng.random(size=(N, H, W, C)).astype(np.float32)
    soft[0, 0, 0] = 0.0
    soft[0, 0, 0, 3] = 1.0  # an exact 1.0 survives the soft-CE truncation
    soft_n = soft / soft.sum(-1, keepdims=True)
    soft_n[0, 0, 0] = soft[0, 0, 0]
    jfn, tfn = {
        "ce": (lambda x: JL.cross_entropy_2d(x, jnp.asarray(hard)),
               lambda x: TL.cross_entropy_2d(x, torch.tensor(hard))),
        "ce_soft": (lambda x: JL.cross_entropy_2d(x, jnp.asarray(soft_n), soft=True),
                    lambda x: TL.cross_entropy_2d(x, _nchw(soft_n), soft=True)),
        "rce": (lambda x: JL.rce(x, jnp.asarray(hard)), lambda x: TL.rce(x, torch.tensor(hard))),
        "rce_soft": (lambda x: JL.rce(x, jnp.asarray(soft_n), soft=True),
                     lambda x: TL.rce(x, _nchw(soft_n), soft=True)),
        "js": (lambda x: JL.js_divergence(x, jnp.asarray(hard)),
               lambda x: TL.js_divergence(x, torch.tensor(hard))),
        "MRENT": (lambda x: JL.regular_loss("MRENT", x), lambda x: TL.regular_loss("MRENT", x)),
        "MRKLD": (lambda x: JL.regular_loss("MRKLD", x), lambda x: TL.regular_loss("MRKLD", x)),
    }[case]
    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(logits))
    x = _nchw(logits).requires_grad_(True)
    got = tfn(x)
    got.backward()
    if case == "ce_soft":  # the reference quirk: nan value, zero gradient
        assert np.isnan(float(want)) and np.isnan(got.item())
    else:
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6)
    # f32 softmax/log rounding differs between the two libraries
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g).transpose(0, 3, 1, 2),
                               rtol=1e-4, atol=1e-7)


def test_ewc_loss(rng):
    a = {"w": rng.normal(size=(3, 4)).astype(np.float32), "b": rng.normal(size=4).astype(np.float32)}
    b = {k: v + 0.1 * rng.normal(size=v.shape).astype(np.float32) for k, v in a.items()}
    want = JL.ewc_loss(0.5, jax.tree.map(jnp.asarray, a), jax.tree.map(jnp.asarray, b))
    got = TL.ewc_loss(0.5, {k: torch.tensor(v) for k, v in a.items()},
                      {k: torch.tensor(v) for k, v in b.items()})
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


# --- monitor ---------------------------------------------------------------

@pytest.mark.parametrize("dev_func", ["hamming", "mean", "median"])
def test_monitor_matches_jax(rng, dev_func):
    keys = ("a", "b")
    jm, tm = JMonitor(keys, limit=5, exp_const=0.2, dev_func=dev_func), \
        TMonitor(keys, limit=5, exp_const=0.2, dev_func=dev_func)
    js, ts = jm.init(), tm.init()
    for i, v in enumerate(rng.random(12).astype(np.float32)):
        enable = i % 4 != 3
        js = jm.add(js, "a", float(v), enable=enable)
        # a host bool and a device tensor take different paths through add
        ts = tm.add(ts, "a", float(v), enable=enable if i % 2 else torch.tensor(enable))
        for key in keys:  # "b" is never added: avg/exp read 1, dev 0
            for name in ("avg", "exp_avg", "dev_avg"):
                want = float(getattr(jm, name)(js, key))
                got = getattr(tm, name)(ts, key).item()
                assert np.isclose(got, want, rtol=1e-5, atol=1e-7), (i, key, name, got, want)


# --- resizes and metrics ---------------------------------------------------

def test_resizes_match_jax(rng):
    x = rng.normal(size=(N, H, W, C)).astype(np.float32)
    np.testing.assert_allclose(TI.upsample_bilinear_ac(_nchw(x), (32, 64)).numpy(),
                               np.asarray(JI.upsample_bilinear_ac(jnp.asarray(x), (32, 64)))
                               .transpose(0, 3, 1, 2), rtol=1e-5, atol=1e-5)
    lbl = rng.integers(0, C, size=(N, 32, 64)).astype(np.int64)
    want = np.asarray(JI.resize_nearest(jnp.asarray(lbl.astype(np.float32)), (H, W)))
    np.testing.assert_array_equal(TI.resize_nearest(torch.tensor(lbl), (H, W)).numpy(), want)


def test_metrics_match_jax(rng):
    label = rng.integers(0, C + 3, size=(N, 16, 16)).astype(np.int32)
    label[label >= C] = 255
    pred = rng.integers(0, C, size=(N, 16, 16)).astype(np.int32)
    want = np.asarray(JM.fast_hist(jnp.asarray(label), jnp.asarray(pred), C))
    got = TM.fast_hist(torch.tensor(label), torch.tensor(pred), C)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(TM.per_class_iu(got), JM.per_class_iu(want))
    assert TM.miou(got) == pytest.approx(JM.miou(want))
    probs = rng.random(size=(N, 16, 16, C)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    weight = np.array([1.0, 0.0], np.float32)[:, None, None]
    jacc = JM.ece_record(JM.ece_init(10), jnp.asarray(probs), jnp.asarray(label), jnp.asarray(weight))
    tacc = TM.ece_record(TM.ece_init(10), _nchw(probs), torch.tensor(label), torch.tensor(weight))
    np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), rtol=1e-5, atol=1e-5)
    assert TM.ece_value(tacc).item() == pytest.approx(float(JM.ece_value(jacc)), rel=1e-5)


# --- timing ----------------------------------------------------------------

@pytest.mark.parametrize("every,n_target", [(0, 4), (3, 4), (1, 1), (-1, 2)])
def test_samples_due_matches_jax(every, n_target):
    from onda_tpu.methods.timing import samples_due as jax_due
    from onda_torch.methods.timing import samples_due
    from onda_torch.utils.spans import SpanRecorder

    assert [samples_due(every, i, n_target) for i in range(9)] == \
        [jax_due(every, i, n_target) for i in range(9)]
    spans = SpanRecorder("cpu", enabled=True)
    for i in range(3):
        with spans.step(i):
            spans.phase("a")
    assert set(spans.averages({"a": "time/a"}, last=2)) == {"time/a"}
    assert [len(step) for step in spans.steps()] == [2, 2, 2]
