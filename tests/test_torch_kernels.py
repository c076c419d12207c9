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


# BatchNorm's passes after the statistics (csrc/bn_norm.cu): their plain
# versions, which a CPU tensor takes, against the JAX package. An odd plane
# (33 x 25) and the ASPP pooling branch's 1 x 1 planes; NCHW here, NHWC in JAX.
BN_SHAPES = [(3, 17, 33, 25), (4, 256, 1, 1)]
BN_DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
             "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}
# y and dx in f32: the same f32 formula, summation order aside (and autodiff
# against the closed form for dx); in bf16 both round the f32 result once, so
# a rounding-level gap in f32 may move a value by one bf16 step (2^-8)
BN_TOL = {"f32": dict(rtol=1e-4, atol=1e-5), "bf16": dict(rtol=1.6e-2, atol=1.6e-2)}


def _bn_inputs(rng, shape):
    n, c, h, w = shape
    x = rng.normal(size=(n, h, w, c)) * (0.5 + rng.random(c)) + rng.normal(size=c)
    scale = 1.0 + 0.1 * rng.normal(size=c)
    bias = 0.1 * rng.normal(size=c)
    dy = rng.normal(size=(n, h, w, c))
    return (a.astype(np.float32) for a in (x, scale, bias, dy))


def _nchw(a, dtype):
    return torch.tensor(np.asarray(a, np.float32).transpose(0, 3, 1, 2)).to(dtype)


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("dtype", BN_DTYPES)
@pytest.mark.parametrize("shape", BN_SHAPES, ids=str)
def test_bn_train_plain_passes_match_jax(rng, shape, dtype):
    """bn_train on CPU tensors (K2's, bn_apply's and the two backward passes'
    plain versions) against `_bn_train_math` and jax.grad of it."""
    x, scale, bias, dy = _bn_inputs(rng, shape)
    _, jdt, tdt = BN_DTYPES[dtype]
    jx = jnp.asarray(x).astype(jdt)
    jdy = jnp.asarray(dy).astype(jdt)

    def loss(xx, s, b):
        y, _, _, _ = _bn_train_math(xx, s, b, 1e-5)
        return (y.astype(jnp.float32) * jdy.astype(jnp.float32)).sum()

    want_y, want_mean, want_var, _ = _bn_train_math(jx, jnp.asarray(scale), jnp.asarray(bias), 1e-5)
    gx, gs, gb = jax.grad(loss, argnums=(0, 1, 2))(jx, jnp.asarray(scale), jnp.asarray(bias))

    xt = _nchw(jx.astype(jnp.float32), tdt).requires_grad_(True)
    st = torch.tensor(scale).requires_grad_(True)
    bt = torch.tensor(bias).requires_grad_(True)
    y, mean, var = TL.bn_train(xt, st, bt, 1e-5)
    assert y.dtype == tdt
    (y.float() * _nchw(jdy.astype(jnp.float32), torch.float32)).sum().backward()
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(var.numpy(), np.asarray(want_var), rtol=1e-4, atol=1e-5)
    tol = BN_TOL[dtype]
    np.testing.assert_allclose(_nhwc(y), np.asarray(want_y, np.float32), **tol)
    assert xt.grad.dtype == tdt
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx, np.float32),
                               rtol=tol["rtol"], atol=tol["atol"] * np.abs(np.asarray(gx, np.float32)).max())
    # dγ and dβ: f32 sums of the same products in another order
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(gs), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gb), rtol=1e-4, atol=1e-4)
    assert all(v == 0 for v in K.launches.values()) and all(v == 0 for v in K.bn_launches.values())


@pytest.mark.parametrize("dtype", BN_DTYPES)
@pytest.mark.parametrize("shape", BN_SHAPES, ids=str)
def test_bn_eval_plain_apply_matches_jax(rng, shape, dtype):
    """The eval branch (running statistics through bn_apply's plain version)
    against the JAX TorchBatchNorm, and its gradient (statistics held
    constant: dx = γ·inv·dy) against jax.grad of it."""
    from onda_tpu.models.layers import TorchBatchNorm as JaxBatchNorm

    x, scale, bias, dy = _bn_inputs(rng, shape)
    c = shape[1]
    rmean = rng.normal(size=c).astype(np.float32)
    rvar = (0.5 + rng.random(c)).astype(np.float32)
    _, jdt, tdt = BN_DTYPES[dtype]
    jx = jnp.asarray(x).astype(jdt)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"running_mean": jnp.asarray(rmean),
                                 "running_var": jnp.asarray(rvar)}}

    def loss(xx, params):
        y = JaxBatchNorm().apply({**variables, "params": params}, xx, train=False)
        return (y.astype(jnp.float32) * jnp.asarray(dy)).sum()

    want = JaxBatchNorm().apply(variables, jx, train=False)
    gx, gp = jax.grad(loss, argnums=(0, 1))(jx, variables["params"])

    bn = TL.TorchBatchNorm(c)
    with torch.no_grad():
        for t, a in ((bn.weight, scale), (bn.bias, bias), (bn.running_mean, rmean),
                     (bn.running_var, rvar)):
            t.copy_(torch.tensor(a))
    xt = _nchw(jx.astype(jnp.float32), tdt).requires_grad_(True)
    y = bn(xt, train=False)
    assert y.dtype == tdt
    (y.float() * _nchw(dy, torch.float32)).sum().backward()
    tol = BN_TOL[dtype]
    np.testing.assert_allclose(_nhwc(y), np.asarray(want, np.float32), **tol)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx, np.float32),
                               rtol=tol["rtol"], atol=tol["atol"] * np.abs(np.asarray(gx, np.float32)).max())
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(gp["scale"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(gp["bias"]), rtol=1e-4, atol=1e-4)
    # eval mode leaves the running statistics alone
    np.testing.assert_array_equal(bn.running_mean.numpy(), rmean)
    np.testing.assert_array_equal(bn.running_var.numpy(), rvar)


@pytest.mark.parametrize("momentum,n", [(0.1, 3 * 33 * 25), (0.01, 4), (0.1, 1)])
def test_bn_running_update_plain_matches_inplace_sequence(rng, momentum, n):
    """The running update that bn_apply takes in its launch, in its plain
    version, bit for bit the `mul_(1 − m).add_(...)` sequence of the module
    (the unbiased variance from the global count n, n/(n−1) at n ≥ 2)."""
    c = 17
    x = torch.tensor(rng.normal(size=(3, c, 5, 5)).astype(np.float32))
    mean, var = K.bn_stats(x)
    start_mean = torch.tensor(rng.normal(size=c).astype(np.float32))
    start_var = torch.tensor((0.5 + rng.random(c)).astype(np.float32))
    got_mean, got_var = start_mean.clone(), start_var.clone()
    ones, zeros = torch.ones(c), torch.zeros(c)
    K.bn_apply(x, mean, var, ones, zeros, 1e-5, running=(got_mean, got_var, momentum, n))
    want_mean, want_var = start_mean.clone(), start_var.clone()
    want_mean.mul_(1 - momentum).add_(momentum * mean)
    want_var.mul_(1 - momentum).add_(momentum * var * (n / max(n - 1, 1)))
    assert torch.equal(got_mean, want_mean) and torch.equal(got_var, want_var)
    assert not torch.equal(got_mean, start_mean)
    assert all(v == 0 for v in K.bn_launches.values())


def test_bn_module_on_cpu_launches_nothing(rng):
    """A TorchBatchNorm on CPU tensors, train (updating) and eval, forward and
    backward, takes the plain versions: no launch counted in either dict."""
    K.reset_launches()
    bn = TL.TorchBatchNorm(17)
    x = torch.tensor(rng.normal(size=(3, 17, 33, 25)).astype(np.float32), requires_grad=True)
    before = bn.running_mean.clone()
    bn(x, train=True).square().sum().backward()
    assert not torch.equal(bn.running_mean, before)
    with torch.no_grad():
        bn(x, train=True, update_stats=False)
        bn(x, train=False)
    bn(x, train=False).sum().backward()
    assert K.launches == {"pseudo_labels_kernel": 0, "bn_stats_kernel": 0}
    assert K.bn_launches == {"bn_apply_kernel": 0, "bn_grad_sums_kernel": 0,
                             "bn_grad_dx_kernel": 0}
