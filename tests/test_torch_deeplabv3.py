"""The port's DeepLab-v3 / v3+ zoo against `onda_tpu.models.deeplabv3`: weights
carried across by `convert.flax_v3_to_state_dict`, eval- and train-mode
outputs, the running statistics a train-mode forward leaves, the gradients
of a CE loss, ResNet-101's layout and the image-pooling branch at batch 1.

Weights are seeded numpy draws of the JAX model's variable shapes (He-scaled
kernels, running statistics off their init), so that eval mode reads real
statistics. Each configuration's JAX side is one jitted function (eval and
train forwards, the stats update and the gradients), compiled once in a
module fixture: XLA:CPU compiles of this zoo are why `tests/test_deeplabv3.py`
is marked slow."""

import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from torch.func import functional_call

from onda_tpu.models.deeplabv3 import ASPPv3 as JaxASPPv3
from onda_tpu.models.deeplabv3 import build_deeplab_v3 as jax_build
from onda_tpu.ops import losses as JL
from onda_torch.models.convert import flax_v3_to_state_dict
from onda_torch.models.deeplabv3 import ASPPv3, build_deeplab_v3
from onda_torch.models.layers import TorchBatchNorm
from onda_torch.ops import losses as L

B, S, C = 2, 64, 19
CONFIGS = [("mobilenetv2", False, 16), ("mobilenetv2", True, 16), ("mobilenetv2", False, 8),
           ("mobilenetv2", True, 8), ("resnet50", True, 16)]
# bounds, each on max|port − JAX| / max|JAX| of a tensor (the worst seen in
# brackets): the forwards run the same f32 arithmetic in another order (JAX
# at HIGHEST precision). Train mode normalises by batch statistics whose
# variance both packages take in one pass in f32 (E[x²] − E[x]², JAX's
# `_bn_train_math`, K2's plain version): over the 32 values a channel has
# in an OS16 stage at this size, and the 2 of the pooling branch, that
# loses digits wherever a channel's mean dwarfs its spread, and the
# gradient that flows back through every BatchNorm to the image agrees only
# to a few % of its largest entry, as the v2 backbone's gradients do
# (`tests/test_torch_advent.py::GRAD_ENVELOPE`)
EVAL_REL = 1e-4         # [1.3e-05]
TRAIN_REL = 2e-3        # outputs [5.9e-04] and running statistics [3.2e-04]
LOSS_RTOL = 5e-5        # [8.6e-06]
HEAD_GRAD_REL = 2e-3    # the classifier's weight and bias [5.2e-04]
INPUT_GRAD_REL = 5e-2   # [2.7e-02]
# the JAX side compiles with XLA:CPU's backend optimisation off: the
# reference's arithmetic is the same, its compile about 40% shorter
XLA_FAST = {"xla_backend_optimization_level": 0}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Torch on two threads in this file: the test run's workers share the
    host's cores, and one torch thread per core in each oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def seeded_variables(module, x_shape, seed):
    """Numpy variables of `module`'s shapes (no JAX init runs): kernels
    He-scaled by their fan-in, affine near (1, 0), running means near 0 and
    variances in [0.5, 1.5]."""
    abstract = jax.eval_shape(lambda: module.init(jax.random.key(0), jnp.zeros(x_shape),
                                                  train=False))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            value = rng.normal(size=shape) * math.sqrt(2.0 / math.prod(shape[:-1]))
        elif name == "scale":
            value = 1.0 + 0.1 * rng.normal(size=shape)
        elif name == "running_var":
            value = rng.uniform(0.5, 1.5, size=shape)
        else:  # bias, running_mean
            value = 0.1 * rng.normal(size=shape)
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(abstract))


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def assert_rel(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rel, f"{what}: max|port - jax| / max|jax| = {err:.3e} > {rel}"


def both_packages(backbone, plus, os_):
    """Both packages on the same weights, image and labels: eval forward,
    train forward with the stats update, CE loss and its gradients with
    respect to the image and the classifier."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, S, S, 3)).astype(np.float32)
    labels = rng.integers(0, C, size=(B, S, S)).astype(np.int32)
    labels[0, :4] = 255  # ignored pixels
    jmodel = jax_build(num_classes=C, backbone=backbone, plus=plus, output_stride=os_)
    variables = seeded_variables(jmodel, (1, S, S, 3), seed=3)

    def jax_side(variables, x, labels):
        _, ev = jmodel.apply(variables, x, train=False)

        def loss_fn(params, x):
            (_, out), mut = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                         x, train=True, update_stats=True, mutable=["batch_stats"])
            return JL.cross_entropy_2d(out["out"], labels), (out, mut["batch_stats"])

        (loss, (tr, stats)), (g_params, g_x) = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True)(variables["params"], x)
        return ev, tr, stats, loss, g_params["classifier"], g_x

    args = (variables, jnp.asarray(x), jnp.asarray(labels))
    compiled = jax.jit(jax_side).lower(*args).compile(compiler_options=XLA_FAST)
    want = jax.tree.map(np.asarray, compiled(*args))

    tmodel = build_deeplab_v3(C, backbone, plus, os_)
    tmodel.load_state_dict(flax_v3_to_state_dict(variables), strict=True)
    xt = torch.tensor(_nchw(x))
    with torch.no_grad():
        _, ev = tmodel(xt)
    buffers = {k: v.clone() for k, v in tmodel.named_buffers()}
    xg = xt.clone().requires_grad_(True)
    _, tr = functional_call(tmodel, {**dict(tmodel.named_parameters()), **buffers}, (xg,),
                            {"train": True, "update_stats": True})
    loss = L.cross_entropy_2d(tr["out"], torch.tensor(labels).long())
    g_w, g_b, g_x = torch.autograd.grad(
        loss, [tmodel.classifier.weight, tmodel.classifier.bias, xg])
    got = {"eval": ev, "train": tr, "stats": buffers, "loss": loss.item(),
           "classifier": (g_w, g_b), "x": g_x}
    return {"want": want, "got": got, "variables": variables, "model": tmodel}


@pytest.fixture(scope="module", params=CONFIGS,
                ids=lambda c: f"{c[0]}-{'v3plus' if c[1] else 'v3'}-os{c[2]}")
def run(request):
    return both_packages(*request.param)


def test_state_dict_is_the_converted_jax_variables(run):
    sd = run["model"].state_dict()
    converted = flax_v3_to_state_dict(run["variables"])
    assert set(sd) == set(converted)
    for key, value in converted.items():
        torch.testing.assert_close(sd[key], value, rtol=0, atol=0, msg=key)


def test_eval_forward_matches_jax(run):
    ev, got = run["want"][0], run["got"]["eval"]
    assert got["out"].shape == (B, C, S, S)
    for key in ("out", "feat"):
        assert_rel(got[key].numpy(), _nchw(ev[key]), EVAL_REL, f"eval {key}")


def test_train_forward_and_running_stats_match_jax(run):
    _, tr, stats, loss, _, _ = run["want"]
    got = run["got"]
    for key in ("out", "feat"):
        assert_rel(got["train"][key].detach().numpy(), _nchw(tr[key]), TRAIN_REL, f"train {key}")
    np.testing.assert_allclose(got["loss"], float(loss), rtol=LOSS_RTOL)
    want = flax_v3_to_state_dict({"batch_stats": stats})
    before = dict(run["model"].named_buffers())
    moved = 0
    for key, value in want.items():
        assert_rel(got["stats"][key].numpy(), value.numpy(), TRAIN_REL, key)
        moved += not torch.equal(before[key], value)
    assert moved > 0  # momentum 0.1 moved them


def test_gradients_match_jax(run):
    _, _, _, _, g_cls, g_x = run["want"]
    g_w, g_b = run["got"]["classifier"]
    assert_rel(g_w.numpy(), np.asarray(g_cls["kernel"]).transpose(3, 2, 0, 1), HEAD_GRAD_REL,
               "classifier weight")
    assert_rel(g_b.numpy(), g_cls["bias"], HEAD_GRAD_REL, "classifier bias")
    assert_rel(run["got"]["x"].numpy(), _nchw(g_x), INPUT_GRAD_REL, "input")


def test_resnet101_has_the_jax_layout():
    """The converted JAX ResNet-101 variables load strictly (keys and shapes)."""
    jmodel = jax_build(num_classes=C, backbone="resnet101", plus=True)
    abstract = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, S, S, 3)),
                                                  train=False))
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), dict(abstract))
    converted = flax_v3_to_state_dict(zeros)
    with torch.device("meta"):
        tmodel = build_deeplab_v3(C, "resnet101", True)
    sd = tmodel.state_dict()
    assert set(sd) == set(converted)
    for key, value in converted.items():
        assert tuple(sd[key].shape) == tuple(value.shape), key
    assert sum(k.startswith("backbone.layer3.") and k.endswith(".conv1.weight") for k in sd) == 23
    assert sum(isinstance(m, TorchBatchNorm) for m in tmodel.modules()) == 112


def test_pooled_branch_at_batch_one():
    """ASPP in train mode at N = 1: the pooling branch's BatchNorm sees one
    value a channel (variance 0). The output and the input gradient are
    finite, and the running statistics equal JAX's."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(1, 5, 6, 32)).astype(np.float32)
    jaspp = JaxASPPv3(features=16, rates=(1, 2, 3))
    variables = seeded_variables(jaspp, x.shape, seed=5)
    (out, mut) = jax.jit(lambda v, xx: jaspp.apply(v, xx, train=True, update_stats=True,
                                                   mutable=["batch_stats"]))(variables, x)
    taspp = ASPPv3(32, features=16, rates=(1, 2, 3))
    taspp.load_state_dict(flax_v3_to_state_dict(variables), strict=True)
    xt = torch.tensor(_nchw(x)).requires_grad_(True)
    got = taspp(xt, train=True, update_stats=True)
    (g,) = torch.autograd.grad(got.square().sum(), xt)
    assert torch.isfinite(got).all() and torch.isfinite(g).all()
    assert_rel(got.detach().numpy(), _nchw(out), TRAIN_REL, "ASPP output")
    want = flax_v3_to_state_dict({"batch_stats": jax.tree.map(np.asarray, mut["batch_stats"])})
    # a zero batch variance: the running variance only decays
    np.testing.assert_allclose(want["pool.bn.running_var"].numpy(),
                               0.9 * variables["batch_stats"]["pool"]["bn"]["running_var"],
                               rtol=1e-6)
    for key, value in want.items():
        assert_rel(taspp.state_dict()[key].numpy(), value.numpy(), TRAIN_REL, key)
