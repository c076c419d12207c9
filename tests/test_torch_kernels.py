"""The port's kernel modules against the JAX package: K1 and K2's plain
versions (the path a CPU tensor takes through each wrapper) against the jnp
functions the JAX step calls and against the Pallas kernels in interpret
mode; the train-mode BatchNorm autograd.Function against jax.grad.

The CUDA kernels themselves are checked against their plain versions on the
card (chip_smoke.py phases 3-4, and the `cuda`-marked test of
tests/test_torch_kernel_plans.py, which imports no JAX so that it runs there)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from onda_tpu.models.layers import _bn_train_math
from onda_tpu.ops import prototypes as JP
from onda_tpu.ops.pallas_kernels import bn_batch_stats, fused_pseudo_labels
from onda_torch.models import layers as TL
from onda_torch.ops import kernels as K
from onda_torch.ops import prototypes as TP

C, F, PIX = 19, 256, 700  # P not a multiple of the Pallas tile: exercises padding


def _k1_inputs(rng):
    protos = rng.normal(size=(C, F)).astype(np.float32)
    feat = (protos[rng.integers(0, C, PIX)] + rng.normal(size=(PIX, F))).astype(np.float32)
    prior = rng.random(size=(PIX, C)).astype(np.float32) + 0.05
    prior /= prior.sum(-1, keepdims=True)
    sq = (protos**2 + rng.random(size=(C, F))).astype(np.float32)
    count = rng.integers(1, 50, size=C).astype(np.float32)
    return feat, protos, prior, sq, count


@pytest.mark.parametrize("metric", ["euclidean", "mahalanobis"])
def test_k1_plain_matches_jax(rng, metric):
    feat, protos, prior, sq, count = _k1_inputs(rng)
    tau = 1.3
    jstate = JP.init_state(C, F).replace(mean=jnp.asarray(protos), sq_mean=jnp.asarray(sq),
                                         count=jnp.asarray(count), tau=jnp.asarray(tau, jnp.float32))
    dis = JP.distances(jnp.asarray(feat), jstate, metric)
    prop = JP.proto_probs(dis, jstate.tau)
    want_soft = np.asarray(JP.fuse_prior(prop, jnp.asarray(prior)))
    want_hard = np.asarray(JP.hard_labels(jnp.asarray(want_soft), 0.3))

    tstate = TP.init_state(C, F).replace(mean=torch.tensor(protos), sq_mean=torch.tensor(sq),
                                         count=torch.tensor(count), tau=torch.tensor(tau))
    soft, hard, pmax = K.pseudo_labels(torch.tensor(feat), tstate.mean, torch.tensor(prior),
                                       tstate.tau, 0.3, TP.inv_std(tstate, metric))
    # same f32 formula, summation order of the cross term differs
    np.testing.assert_allclose(soft.numpy(), want_soft, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pmax.numpy(), np.asarray(prop).max(-1), rtol=1e-4, atol=1e-5)
    assert hard.dtype == torch.int32
    assert (hard.numpy() == want_hard).mean() > 0.999  # ties at the threshold may flip
    assert K.launches["pseudo_labels_kernel"] == 0  # CPU tensors never launch


@pytest.mark.parametrize("metric", ["euclidean", "mahalanobis"])
def test_k1_plain_matches_pallas_interpret(rng, metric):
    feat, protos, prior, sq, count = _k1_inputs(rng)
    tstate = TP.init_state(C, F).replace(mean=torch.tensor(protos), sq_mean=torch.tensor(sq),
                                         count=torch.tensor(count))
    scale = TP.inv_std(tstate, metric)
    soft, hard, _ = K.pseudo_labels(torch.tensor(feat), tstate.mean, torch.tensor(prior),
                                    torch.tensor(0.9), 0.3, scale)
    s = np.ones(F, np.float32) if scale is None else scale.numpy()
    # the Pallas kernel takes mahalanobis inputs pre-scaled by 1/global std
    want_soft, want_hard = fused_pseudo_labels(
        jnp.asarray(feat * s), jnp.asarray(protos * s), jnp.asarray(prior),
        jnp.asarray(0.9, jnp.float32), num_classes=C, thresh=0.3, interpret=True)
    np.testing.assert_allclose(soft.numpy(), np.asarray(want_soft), rtol=1e-4, atol=1e-5)
    assert (hard.numpy() == np.asarray(want_hard)).mean() > 0.999


def test_k2_plain_matches_jax(rng):
    x = rng.normal(size=(3, 17, 32, 24)).astype(np.float32) + 0.5  # NHWC, as JAX holds it
    _, want_mean, want_var, _ = _bn_train_math(jnp.asarray(x), jnp.ones((24,)), jnp.zeros((24,)), 1e-5)
    pallas_mean, pallas_var = bn_batch_stats(jnp.asarray(x), interpret=True)
    mean, var = K.bn_stats(torch.tensor(x.transpose(0, 3, 1, 2)))  # NCHW
    for m, v in ((want_mean, want_var), (pallas_mean, pallas_var)):
        np.testing.assert_allclose(mean.numpy(), np.asarray(m), atol=1e-6)
        # accumulation order differs -> f32 rounding noise (tests/test_pallas.py)
        np.testing.assert_allclose(var.numpy(), np.asarray(v), rtol=1e-5, atol=1e-6)
    assert K.launches["bn_stats_kernel"] == 0


def test_bn_train_function_grads_match_jax(rng):
    x = rng.normal(size=(3, 17, 32, 24)).astype(np.float32) * 1.5 + 0.3
    scale = (1.0 + 0.1 * rng.normal(size=24)).astype(np.float32)
    bias = (0.1 * rng.normal(size=24)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)

    def loss(xx, s, b):
        y, _, _, _ = _bn_train_math(xx, s, b, 1e-5)
        return (y * jnp.asarray(dy)).sum()

    want_y = np.asarray(_bn_train_math(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 1e-5)[0])
    gx, gs, gb = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))

    to_nchw = lambda a: torch.tensor(a.transpose(0, 3, 1, 2))  # noqa: E731
    xt = to_nchw(x).requires_grad_(True)
    st = torch.tensor(scale).requires_grad_(True)
    bt = torch.tensor(bias).requires_grad_(True)
    y, _, _ = TL.bn_train(xt, st, bt, 1e-5)
    (y * to_nchw(dy)).sum().backward()
    # closed form vs XLA autodiff of the same f32 math: rounding-level differences
    np.testing.assert_allclose(y.detach().numpy(), want_y.transpose(0, 3, 1, 2), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx).transpose(0, 3, 1, 2), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(gs), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gb), rtol=1e-4, atol=1e-4)


def test_wrappers_reject_mixed_devices():
    x = torch.zeros(2, 3)
    with pytest.raises(ValueError):
        K._on_cpu(x, torch.zeros(1, device="meta"))
