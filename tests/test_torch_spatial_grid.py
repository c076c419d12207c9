"""The spatial mesh axis on gloo ranks (`onda_torch/parallel/spatial.py`,
`mesh.spatial_grid`): image rows split over the spatial ranks of a (data ×
spatial) grid, as JAX's `make_mesh(shape=(d, s), axes=("data", "spatial"))`
splits them.

(a) The forward of R50 at layers (1, 1, 1, 1), ProDA head, 64×64, b2, on a
(2 × 2) grid (each rank one sample's block of 32 image rows; the pool's 17
rows and the 9-row feature grid split 9/8 and 5/4) against JAX's forward on
its 2 × 2 ("data", "spatial") mesh of the conftest's virtual CPU devices
(eval mode, `tests/test_multichip.py::test_spatial_sharding_forward`'s
shape), and against the port's one process in eval and train mode: within
1e-5 of each output's largest entry.

(b) hybrid_switch.yml's bootstrap (full-resolution source labels, split as
the images) and two fused steps on a (1 × 2) grid at 64×64, b2 (uneven
blocks at every resolution below the stem), against the port's one process
at the same global batch, batch-invariant (every BatchNorm variance from
f64 moments, as K2 takes it on the card: `card_bn_stats`): the step-0
losses within 1e-6 relative and the same pseudo-labels, the losses within
2e-4 relative and Σ|params| within 1e-4 relative after the last step
(`__graft_entry__.py`'s bounds for JAX's data × spatial step), the spatial
ranks' states equal bit for bit, and the collectives a step by group.

Both grids run as one launch each of tests/torch_parallel_worker.py, at
once, beside the references in this process.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from onda_tpu.models import build_deeplab_v2 as jax_build
from onda_torch.models.convert import flax_to_state_dict
from onda_torch.ops import kernels as K

from .torch_parallel_worker import (card_bn_stats, finish_ranks, model_of, nchw,
                                    run_spatial_step, start_ranks)

B, H, W, C = 2, 64, 64, 19
HR, WR = H // 8 + 1, W // 8 + 1
STEPS, LR = 2, 1e-3
DEADLINE = 300  # seconds for a grid's workers; a hang fails the test
FORWARD_BOUND = 1e-5
STEP0_RTOL, LOSS_RTOL, PARAMS_RTOL = 1e-6, 2e-4, 1e-4
LOSSES = ("ce_loss", "rce_loss", "regularization_loss", "buff_ce_loss", "Total target loss")


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _batch(rng):
    return {"image": rng.normal(size=(B, H, W, 3)).astype(np.float32),
            "label": rng.integers(0, C, size=(B, H, W)).astype(np.int32),
            "label_res": rng.integers(0, C, size=(B, HR, WR)).astype(np.int32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spatial")
    rng = np.random.default_rng(0)
    jmodel = jax_build(num_classes=C, layers=(1, 1, 1, 1), droprate=0.0)
    variables = jax.tree.map(np.asarray, dict(
        jmodel.init(jax.random.key(0), jnp.zeros((1, H, W, 3)), train=False)))
    state_dict = flax_to_state_dict(variables)
    image = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    step_sc = {"kind": "spatial_step", "grid": (1, 2), "spec": {}, "hw": (H, W), "batch": B,
               "lr": LR, "boot": _batch(rng), "steps": [(_batch(rng), _batch(rng))
                                                       for _ in range(STEPS)]}
    dirs = {name: tmp / name for name in ("forward", "step")}
    for d in dirs.values():
        d.mkdir()
    started = {
        "forward": start_ranks(dirs["forward"], {"state_dict": state_dict, "scenarios": {
            "forward": {"kind": "spatial_forward", "grid": (2, 2), "image": image}}}, world=4),
        "step": start_ranks(dirs["step"], {"state_dict": state_dict, "scenarios": {
            "step": {**step_sc, "card_bn": True}}}, world=2)}
    try:
        devices = np.asarray(jax.devices()[:4]).reshape(2, 2)
        jmesh = Mesh(devices, ("data", "spatial"))
        jvars = jax.device_put(variables, NamedSharding(jmesh, PartitionSpec()))
        xs = jax.device_put(image, NamedSharding(jmesh, PartitionSpec("data", "spatial")))
        _, jmain = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(jvars, xs)
        jax_out = {k: torch.tensor(np.asarray(v).transpose(0, 3, 1, 2)) for k, v in jmain.items()}
        model = model_of(state_dict, False)
        one_forward = {}
        with torch.no_grad():
            for train in (False, True):
                one_forward[f"train={train}"] = model(nchw(image), train=train, update_stats=False,
                                                      with_aux=False)[1]
        saved = K.bn_stats_plain
        K.bn_stats_plain = card_bn_stats
        try:
            one_step = run_spatial_step({**step_sc, "grid": (1, 1)}, state_dict, 0, 1,
                                        str(tmp / "one"))
        finally:
            K.bn_stats_plain = saved
    finally:
        done = {k: finish_ranks(v, DEADLINE) for k, v in started.items()}
    out = {"jax": jax_out, "one_forward": one_forward, "one_step": one_step}
    for name, (rcs, logs, timed_out) in done.items():
        assert not timed_out and rcs == [0] * len(rcs), f"{name}: {rcs}\n" + "\n".join(
            log[-3000:] for log in logs)
        out[name] = [torch.load(dirs[name] / f"rank{r}.pt", weights_only=False)
                     for r in range(len(rcs))]
    yield out
    shutil.rmtree(tmp, ignore_errors=True)


def _assemble(ranks, name, mode, key):
    """The whole output from the (2 × 2) ranks' blocks: rows in spatial
    order, samples in data order."""
    by_pos = {r["scenarios"][name]["position"]: r["scenarios"][name][mode][key] for r in ranks}
    return torch.cat([torch.cat([by_pos[(d, s)] for s in range(2)], dim=2) for d in range(2)])


def _gap(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("key", ["out", "feat"])
def test_forward_matches_jax_on_its_data_x_spatial_mesh(runs, key):
    got = _assemble(runs["forward"], "forward", "train=False", key)
    assert got.shape == runs["jax"][key].shape == (B, C if key == "out" else 256, 9, 9)
    assert _gap(got, runs["jax"][key]) <= FORWARD_BOUND


@pytest.mark.parametrize("mode", ["train=False", "train=True"])
def test_forward_matches_one_process(runs, mode):
    """Eval mode, and train mode (BatchNorm's batch statistics weighted by
    each rank's uneven share, GroupNorm's and the SE mean over the spatial
    group)."""
    for key in ("out", "feat"):
        got = _assemble(runs["forward"], "forward", mode, key)
        assert _gap(got, runs["one_forward"][mode][key]) <= FORWARD_BOUND, key


# R50 at (1, 1, 1, 1) with the ProDA head: 17 BatchNorms; 11 windowed ops
# that exchange rows at 64x64 (the stem's conv and pool, 4 dilated conv2s,
# the 4 ASPP branches and the bottleneck's 3x3; layer 2's stride-2 1x1s read
# only their own rows here) and 7 sums over the spatial group (6 GroupNorms,
# the SE mean) a forward
N_BN, N_HALO, N_SPATIAL_SUMS = 17, 11, 7


def test_forward_collectives(runs):
    """Per forward, the halo exchanges and the GroupNorm and SE sums run on
    the spatial group (2 ranks of a data index), and in train mode each
    BatchNorm's moments on the world (data × spatial); nothing on the data
    group alone."""
    for r in runs["forward"]:
        c = r["scenarios"]["forward"]["collectives"]
        assert c["data"]["collectives"] == 0 and c["model"]["collectives"] == 0, c
        assert c["world"]["collectives"] == N_BN, c
        assert c["spatial"]["collectives"] == 2 * (N_HALO + N_SPATIAL_SUMS), c


def _step(runs):
    return [r["scenarios"]["step"] for r in runs["step"]]


def test_step0_matches_one_process(runs):
    """After the bootstrap, the first fused step's losses within 1e-6 and
    its hard pseudo-labels equal to one process's."""
    ranks, one = _step(runs), runs["one_step"]
    for key in LOSSES + ("pseudolabel_pixel_num",):
        want = one["logs"][0][key]
        assert abs(ranks[0]["logs"][0][key] - want) <= STEP0_RTOL * abs(want), key
    hard = torch.cat([r["hard"][0] for r in sorted(ranks, key=lambda r: r["position"])], dim=1)
    assert torch.equal(hard, one["hard"][0])
    for key in ("mean", "sq_mean", "count"):
        assert torch.allclose(ranks[0]["boot_proto"][key], one["boot_proto"][key], rtol=1e-5,
                              atol=1e-6), key


def test_steps_match_one_process_within_jax_bounds(runs):
    ranks, one = _step(runs), runs["one_step"]
    for key in LOSSES:
        want = one["logs"][-1][key]
        assert abs(ranks[0]["logs"][-1][key] - want) <= LOSS_RTOL * abs(want), key
    assert abs(ranks[0]["abs_params"] - one["abs_params"]) <= PARAMS_RTOL * one["abs_params"]


def test_spatial_ranks_end_with_the_same_bits(runs):
    """The state stays whole and equal on every rank, as JAX replicates it."""
    ranks = _step(runs)
    for step in range(STEPS):
        assert ranks[0]["digests"][step] == ranks[1]["digests"][step]
        assert ranks[0]["logs"][step] == ranks[1]["logs"][step]


def test_step_collectives_by_group(runs):
    """Per step on (1 × 2), on the world (data × spatial): the BatchNorm
    moments of the three train-mode forwards and the backward sums of the
    two student passes, the counts, three buckets of confidences (the last
    with the prototype moments), the logs and the gradient bucket. On the
    spatial group: every forward's halo exchanges and sums (the dynamic
    teacher's when its gate fires) and the backward's, but the stem's (the
    image takes no gradient). Nothing on the data group alone."""
    for r in _step(runs):
        for c, logs in zip(r["collectives"], r["logs"]):
            assert c["data"]["collectives"] == 0 and c["model"]["collectives"] == 0, c
            assert c["world"]["collectives"] == 5 * N_BN + 6, c
            forwards = 4 + int(logs["dynamic forward fired"])
            assert c["spatial"]["collectives"] == (
                forwards * (N_HALO + N_SPATIAL_SUMS) + 2 * (N_HALO - 1 + N_SPATIAL_SUMS)), c
