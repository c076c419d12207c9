"""The port's DeepLab-v2 against the JAX model: weights carried across by
`onda_torch.models.convert`, eval- and train-mode outputs, running-stat
updates and the ceil-mode pooling grid."""

import shutil

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from torch.func import functional_call

from onda_tpu.models import build_deeplab_v2 as jax_build
from onda_tpu.models.import_torch import flax_to_torch_state_dict
from onda_tpu.models.layers import max_pool_ceil as jax_max_pool_ceil
from onda_torch.models import build_deeplab_v2
from onda_torch.models.convert import flax_to_state_dict
from onda_torch.models.layers import max_pool_ceil

B, H, W, C = 2, 32, 64, 19

# JAX runs its convolutions at HIGHEST precision, torch in f32 on the CPU; the
# head's GroupNorm renormalises small activations, which amplifies benign
# rounding differences (the same envelope as tests/test_model.py)
TOL = dict(rtol=1e-3, atol=2e-4)


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """The `.pt`, `.pth` and prototype pickles a test writes (up to 1.2 GB
    each) go when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def pair():
    jmodel = jax_build(num_classes=C, layers=(1, 1, 1, 1), droprate=0.0)
    variables = jmodel.init(jax.random.key(0), jnp.zeros((1, H, W, 3)), train=False)
    variables = jax.tree.map(np.asarray, dict(variables))
    tmodel = build_deeplab_v2(C, (1, 1, 1, 1), "ProDA", droprate=0.0)
    tmodel.load_state_dict(flax_to_state_dict(variables), strict=True)
    return jmodel, variables, tmodel


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def test_convert_loads_strict_and_matches_export_keys(pair):
    _, variables, tmodel = pair
    sd = flax_to_state_dict(variables)
    want = flax_to_torch_state_dict(variables)
    assert {k for k in sd if not k.endswith("num_batches_tracked")} == set(want)
    assert set(sd) == set(tmodel.state_dict())
    for key, value in want.items():
        np.testing.assert_array_equal(sd[key].numpy(), value, err_msg=key)


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_jax(pair, rng, train):
    jmodel, variables, tmodel = pair
    x = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    aux, main = jax.jit(lambda v, xx: jmodel.apply(v, xx, train=train, update_stats=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        taux, tmain = tmodel(torch.tensor(_nchw(x)), train=train, update_stats=False)
    assert aux is None and taux is None
    assert tmain["out"].shape == (B, C, H // 8 + 1, W // 8 + 1)
    np.testing.assert_allclose(tmain["out"].numpy(), _nchw(main["out"]), **TOL)
    np.testing.assert_allclose(tmain["feat"].numpy(), _nchw(main["feat"]), **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_aux_head_matches_jax(pair, rng, train):
    """multi_level: the aux head `layer5` on layer3's features, against the
    JAX model's; `with_aux=False` skips it and leaves the main output alone."""
    _, variables, _ = pair
    jmodel = jax_build(num_classes=C, layers=(1, 1, 1, 1), droprate=0.0, multi_level=True)
    tmodel = build_deeplab_v2(C, (1, 1, 1, 1), "ProDA", multi_level=True, droprate=0.0)
    tmodel.load_state_dict(flax_to_state_dict(variables), strict=True)
    x = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    aux, main = jax.jit(lambda v, xx: jmodel.apply(v, xx, train=train, update_stats=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        taux, tmain = tmodel(torch.tensor(_nchw(x)), train=train, update_stats=False)
        skipped, tmain2 = tmodel(torch.tensor(_nchw(x)), train=train, update_stats=False,
                                 with_aux=False)
    assert taux["out"].shape == (B, C, H // 8 + 1, W // 8 + 1)
    for key in ("out", "feat"):
        np.testing.assert_allclose(taux[key].numpy(), _nchw(aux[key]), err_msg=key, **TOL)
        np.testing.assert_allclose(tmain[key].numpy(), _nchw(main[key]), err_msg=key, **TOL)
    assert skipped is None
    torch.testing.assert_close(tmain2["out"], tmain["out"], rtol=0, atol=0)


def test_running_stat_updates_match_jax(pair, rng):
    jmodel, variables, tmodel = pair
    x = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    _, mutated = jax.jit(lambda v, xx: jmodel.apply(
        v, xx, train=True, update_stats=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    want = flax_to_torch_state_dict({"batch_stats": jax.tree.map(np.asarray, mutated["batch_stats"])})
    buffers = {k: v.clone() for k, v in tmodel.named_buffers()}
    with torch.no_grad():
        functional_call(tmodel, buffers, (torch.tensor(_nchw(x)),),
                        {"train": True, "update_stats": True})
    for key, value in want.items():
        # unbiased n/(n-1) running-var update on f32 batch statistics
        np.testing.assert_allclose(buffers[key].numpy(), value, rtol=1e-4, atol=1e-6, err_msg=key)
    before = dict(tmodel.named_buffers())
    assert any(not np.allclose(want[k], before[k].numpy()) for k in want)  # momentum 0.1 moved them


def test_max_pool_ceil_grid(rng):
    x = rng.normal(size=(2, 17, 22, 3)).astype(np.float32)
    want = np.asarray(jax_max_pool_ceil(jnp.asarray(x), 3, 2, 1))
    got = max_pool_ceil(torch.tensor(_nchw(x)), 3, 2, 1)
    np.testing.assert_array_equal(got.numpy(), _nchw(want))
    assert max_pool_ceil(torch.zeros(1, 1, 256, 512), 3, 2, 1).shape[-2:] == (129, 257)
    # the full 512x1024 input gives the 1/8+1 output grid (shapes only: meta tensors)
    with torch.device("meta"):
        model = build_deeplab_v2(C, (1, 1, 1, 1), "ProDA")
    _, main = model(torch.empty(1, 3, 512, 1024, device="meta"))
    assert tuple(main["out"].shape[-2:]) == (65, 129)


def test_reference_checkpoint_loads_strict(pair, tmp_path):
    """A reference-layout .pth (here exported by the JAX package, with its
    num_batches_tracked counters) loads into the port with strict=True."""
    from onda_tpu.models.import_torch import save_torch_checkpoint
    from onda_torch.registry import _load_checkpoint

    _, variables, tmodel = pair
    path = str(tmp_path / "model.pth")
    save_torch_checkpoint(variables, path)
    fresh = build_deeplab_v2(C, (1, 1, 1, 1), "ProDA", droprate=0.0)
    _load_checkpoint(fresh, path)
    for key, value in tmodel.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[key], value, rtol=0, atol=0, msg=key)


def test_registry_builds_seeded_r50():
    from onda_torch import registry
    from onda_torch.config import cfg_from_file
    from onda_torch.models.layers import TorchBatchNorm

    cfg = cfg_from_file("configs/hybrid_switch.yml")
    cfg.MODEL.LOAD = None
    model, variables = registry.get_model(cfg, C, device="cpu")
    again, _ = registry.get_model(cfg, C, device="cpu")
    assert sum(isinstance(m, TorchBatchNorm) for m in model.modules()) == 53
    assert set(variables["params"]) | set(variables["batch_stats"]) == set(model.state_dict())
    torch.testing.assert_close(model.state_dict(), again.state_dict(), rtol=0, atol=0)
    assert registry.get_adapt_method(cfg).__name__ == "ProtoOnlineAdapter"
    cfg.MODEL.NAME = "DeepLabv2-Resnet18"
    with pytest.raises(ValueError):
        registry.get_model(cfg, C, device="cpu")
    cfg.METHOD.ADAPTATION.NAME = "ADVENT"
    assert registry.get_adapt_method(cfg).__name__ == "AdventAdapter"
