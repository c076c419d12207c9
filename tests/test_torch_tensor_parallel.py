"""OTHERS.TENSOR_PARALLEL for the PROTO_ONLINE family on a (data × model) grid
of ranks (`onda_torch/parallel/tensor.py`), on the CPU with gloo ranks.

The hybrid step (R50 at layers (1, 1, 1, 1), 32×64, global batch 4, weights
converted from the JAX variables, dropout off) on a (1 × 2) and a (2 × 2) grid
is held against (d) the port's own one-process step on the global batch, at
a bound tighter than the cross-package one, and (e) the JAX adapter with
OTHERS.TENSOR_PARALLEL 4 on the conftest's 8 virtual devices, a (2 × 4) mesh,
at tests/test_torch_step.py's tolerances. The plan is held against JAX's
`tensor_parallel_shardings` at full R50 ProDA width (a), the option's guards
and the grid's shape against JAX's `data_parallel_setup` (b), the autograd
pieces on a small chain of the model's layers (c), the bits of the whole
leaves across ranks (f), files between the grid and one process (g) and the
other families' configs on a grid (h; their steps are
tests/test_torch_tensor_parallel_adversarial.py's). A model axis of 1 is the
data-parallel path: tests/test_torch_parallel.py::test_collectives_per_step
holds its collectives, and (i) here holds the data group's. The workers
(tests/torch_parallel_worker.py) run under a deadline, with their output in
files, and are killed when it passes.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onda_tpu.config import cfg_from_file as jax_cfg_from_file
from onda_tpu.config import default_config
from onda_tpu.methods.proto_online import ProtoOnlineAdapter as JaxAdapter
from onda_tpu.models import build_deeplab_v2 as jax_build
from onda_tpu.parallel import mesh as jax_mesh
from onda_torch.config import cfg_from_file
from onda_torch.models import build_deeplab_v2
from onda_torch.models.convert import flax_to_state_dict, torch_key
from onda_torch.ops import kernels as K
from onda_torch.parallel import distributed, mesh
from onda_torch.parallel import tensor as T

from .torch_parallel_worker import (SELECTED, chain_modules, digest, finish_ranks,
                                    make_adapter, run_chain, run_tensor_parallel, start_ranks)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, W, C = 4, 32, 64, 19
HR, WR = H // 8 + 1, W // 8 + 1
STEPS, LR, TP = 2, 1e-3, 2
EWC = {"MODEL_REGULARIZATION": 20.0}
GRIDS = {"1x2": 2, "2x2": 4}  # name: world size, at a model axis of TP
DEADLINE = 300  # seconds for a grid's workers; a hang fails the test
LOSSES = ("ce_loss", "rce_loss", "regularization_loss", "buff_ce_loss", "Total target loss")
# (d), a grid against one process on the global batch, every BatchNorm's
# variance taken as K2 takes it on the card in both (`card_bn_stats`). The
# arithmetic differs in the rounding of the sharded convolutions and in the
# order of a few sums (each sharded conv's input gradient is the sum of the
# model ranks' partial ones; the data group sums moments and gradients).
# Measured on the CPU (both grids): losses 1.6e-7 relative; prototypes 1.9e-6
# absolute; running statistics and monitor 3.6e-7; each parameter's update
# off by at most 1.3e-4 of its largest entry in the head (the SE expansion),
# 4.0e-6 in the backbone at step 0 and 1.3e-2 at step 1. The backbone's
# second step amplifies last-bit differences in the conv outputs (the
# half-width convolutions round some outputs otherwise) through BatchNorms of
# near-constant channels and near-tied pseudo-labels (random weights at
# 32×64): one process whose conv outputs carry rounding-level noise moves at
# least as much. The bounds are about 10x (4x for the backbone's second step).
ONE_RTOL, ONE_PROTO, ONE_STATS = 2e-6, 4e-5, 4e-6
ONE_HEAD, ONE_BACKBONE = 1.5e-3, (4e-5, 5e-2)


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """A (1, 1, 1, 1) R50 `adapt_state.pt` is ≈0.8 GB: a test's files go
    when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _batch(rng, n):
    return {"image": rng.normal(size=(n, H, W, 3)).astype(np.float32),
            "label": rng.integers(0, C, size=(n, H, W)).astype(np.int32),
            "label_res": rng.integers(0, C, size=(n, HR, WR)).astype(np.int32)}


@pytest.fixture(scope="module")
def inputs():
    """The JAX variables and the global batches; the second half of each
    source batch mostly 255, so that the data ranks' valid counts differ."""
    rng = np.random.default_rng(0)
    jmodel = jax_build(num_classes=C, layers=(1, 1, 1, 1), droprate=0.0)
    variables = jax.tree.map(np.asarray, dict(
        jmodel.init(jax.random.key(0), jnp.zeros((1, H, W, 3)), train=False)))
    boot, val = _batch(rng, B), _batch(rng, 6)
    steps = []
    for _ in range(STEPS):
        src, trg = _batch(rng, B), _batch(rng, B)
        src["label_res"][B // 2:][rng.random((B // 2, HR, WR)) < 0.8] = 255
        steps.append((src, trg))
    return {"variables": variables, "state_dict": flax_to_state_dict(variables), "boot": boot,
            "val": val, "steps": steps}


def _scenario(inputs, tp, load=None, spec=None):
    """The worker's `tensor_parallel` scenario on a model axis of tp (None:
    one process, which does not save); with `spec` overrides (the EWC term)
    it neither evaluates nor saves."""
    return {"kind": "tensor_parallel", "config": "hybrid_switch", "spec": spec or {}, "hw": (H, W),
            "batch": B, "lr": LR, "boot": inputs["boot"], "val": inputs["val"],
            "steps": inputs["steps"], "tp": tp, "card_bn": True, "load": load,
            "evaluate": spec is None, "save": spec is None and tp is not None}


def _one_process_file(inputs, path):
    """A whole-state `adapt_state.pt` written by one process, every tensor of
    it moved off the initial state (so that a load that drops or misplaces a
    shard shows); returns its contents and the digests of its tensors by
    flat name."""
    ad = make_adapter(inputs["state_dict"], "hybrid_switch", {}, str(path.parent), (H, W), B)
    g = torch.Generator().manual_seed(9)
    for tree in ("params", "batch_stats", "alt_batch_stats", "opt_momentum", "ema_params",
                 "static_params", "static_batch_stats", "dynamic_params", "dynamic_batch_stats"):
        for v in getattr(ad.state, tree).values():
            if v.is_floating_point():
                v.add_(torch.rand(v.shape, generator=g))
    ad.state.proto.mean.add_(1.0)
    ad.save_model()
    saved = torch.load(path, weights_only=False)
    out = {f"{tree}.{k}": digest(v) for tree, d in saved.items() if isinstance(d, dict)
           and tree not in ("proto", "monitor", "switch") for k, v in d.items()}
    out.update({f"proto.{k}": digest(v) for k, v in saved["proto"].items()})
    return saved, out


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """Both grids' workers at once and, meanwhile, the one-process reference
    (the same worker code at world size 1, its BatchNorm variance as K2 takes
    it on the card; torch.distributed's all-reduce raises meanwhile) and the
    JAX step on a (2 × 4) mesh."""
    tmp = tmp_path_factory.mktemp("tp")
    file_one = tmp / "one_file" / "adapt_state.pt"
    one_file, file_digests = _one_process_file(inputs, file_one)
    started = {}
    for name, world in GRIDS.items():
        os.makedirs(tmp / name)
        scenarios = {"tp": _scenario(inputs, TP, load=str(file_one))}
        if world == TP:  # the EWC term, on the lighter grid
            scenarios["ewc"] = _scenario(inputs, TP, spec=EWC)
        payload = {"state_dict": inputs["state_dict"], "scenarios": scenarios}
        started[name] = start_ranks(tmp / name, payload, world=world)

    def refuse(*args, **kwargs):
        raise AssertionError("a collective at world size 1")

    try:
        distributed.reset_counts()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.distributed, "all_reduce", refuse)
            mp.setattr(K, "bn_stats_plain", K.bn_stats_plain)  # restored after the run's patch
            one = run_tensor_parallel(_scenario(inputs, None), inputs["state_dict"], 0, 1,
                                      str(tmp / "one"))
            one_ewc = run_tensor_parallel(_scenario(inputs, None, spec=EWC), inputs["state_dict"],
                                          0, 1, str(tmp / "one_ewc"))
        one["collectives_total"] = distributed.counts()
        jax_out = _jax_tensor_parallel(inputs, str(tmp / "jax"))
        grids = {}
        for name, world in GRIDS.items():
            rcs, outs, timed_out = finish_ranks(started.pop(name), DEADLINE)
            if timed_out:
                pytest.fail(f"grid {name} still running after {DEADLINE} s (a deadlock?)")
            for r, (rc, out) in enumerate(zip(rcs, outs)):
                assert rc == 0, f"grid {name} rank {r} failed (rc {rc}):\n{out[-4000:]}"
            results = [torch.load(tmp / name / f"rank{r}.pt", weights_only=False)["scenarios"]
                       for r in range(world)]
            grids[name] = [r["tp"] for r in results]
            if "ewc" in results[0]:
                grids["ewc"] = [r["ewc"] for r in results]
        files = {}
        for name in GRIDS:  # rank 0's file in memory, the checkpoints off the disk
            files[name] = torch.load(tmp / name / "snap_tp_0" / "adapt_state.pt",
                                     weights_only=False)
            shutil.rmtree(tmp / name, ignore_errors=True)
        shutil.rmtree(file_one.parent, ignore_errors=True)
        yield {"one": one, "one_ewc": one_ewc, "jax": jax_out, "grids": grids, "files": files,
               "file_digests": file_digests, "one_file": one_file}
    finally:
        for s in started.values():
            finish_ranks(s, 1)
        shutil.rmtree(tmp, ignore_errors=True)


def _jax_tensor_parallel(inputs, snap):
    """The JAX hybrid step with OTHERS.TENSOR_PARALLEL 4 on the 8 virtual
    devices: a (2 × 4) (data × model) mesh with channel-sharded state."""
    cfg = jax_cfg_from_file("configs/hybrid_switch.yml", default_config())
    spec = cfg.METHOD.ADAPTATION.PROTO_ONLINE_HYBRIDSWITCH
    cfg.SCHEME.RESOLUTION = [W, H]
    cfg.OTHERS.SNAPSHOT_DIR = snap
    cfg.TRAINING.BATCH_SIZE = B
    cfg.OTHERS.TENSOR_PARALLEL = 4
    spec.LOAD_PROTO, spec.set_, spec.PSEUDO_THRESH = None, "test", 0.06
    model = jax_build(num_classes=C, layers=(1, 1, 1, 1), droprate=0.0)
    ad = JaxAdapter(model, inputs["variables"], cfg, spec, num_classes=C)
    assert dict(zip(ad.mesh.axis_names, ad.mesh.devices.shape)) == {"data": 2, "model": 4}
    ad.calculate_prototypes([inputs["boot"]])
    step = ad.step_fn(have_src=True, source_repeat=1, want_soft=False)
    out = {"boot_proto": np.asarray(ad.state.proto.mean), "logs": [], "values": []}
    for src, trg in inputs["steps"]:
        ad.state, logs = step(ad.state, ad._place(trg["image"]), ad._place(src["image"][None], 1),
                              ad._place(src["label_res"][None], 1), jnp.asarray(LR, jnp.float32))
        out["logs"].append({k: float(v) for k, v in logs.items() if np.ndim(v) == 0})
        sd = flax_to_state_dict({"params": jax.tree.map(np.asarray, ad.state.params),
                                 "batch_stats": jax.tree.map(np.asarray, ad.state.batch_stats)})
        values = {f"params.{k}": sd[k] for k in SELECTED}
        values.update({f"proto.{k}": np.asarray(getattr(ad.state.proto, k))
                       for k in ("mean", "sq_mean", "count")})
        values.update({f"monitor.{k}": np.asarray(getattr(ad.state.monitor, k))
                       for k in ("ring", "count", "ptr", "exp", "started")})
        values.update({f"switch.{k}": np.asarray(getattr(ad.state.switch, k))
                       for k in ("current", "current_dev")})
        out["values"].append(values)
    return out


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _update_gap(start, got, want):
    """max |got − want| of a parameter's update from start, over the largest
    entry of want's update."""
    update = np.abs(_np(want) - _np(start)).max()
    return np.abs(_np(got) - _np(want)).max() / max(update, 1e-30)


# ---------------------------------------------------------------------------
# (a) the plan against JAX's rule; (b) the guards and the grid
# ---------------------------------------------------------------------------

def _jax_sharded_leaves(tp, layers=(3, 4, 6, 3)):
    """The state_dict names of the JAX model's variables at full ProDA width
    that `tensor_parallel_shardings` shards on a model axis of tp, from the
    shapes alone (`jax.eval_shape` of init)."""
    model = jax_build(num_classes=C, layers=layers)
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), jnp.zeros((1, 65, 65, 3)),
                                               train=False))
    grid = jax_mesh.make_mesh(shape=(8 // tp, tp), axes=("data", "model"))
    specs = jax_mesh.tensor_parallel_shardings(grid, dict(shapes))
    flat = jax.tree_util.tree_flatten_with_path(specs)[0]
    sharded, names = set(), set()
    for path, sharding in flat:
        key = torch_key(tuple(p.key for p in path))
        names.add(key)
        if "model" in tuple(sharding.spec):
            assert tuple(sharding.spec)[-1] == "model", key  # JAX's last axis
            sharded.add(key)
    return sharded, names


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_plan_shards_the_jax_leaves_at_full_width(tp):
    """(a): at full R50 ProDA width the plan shards exactly the leaves JAX's
    rule shards, on the axis `models/convert.py` maps from JAX's last one
    (axis 0); the port's BN counters stay whole. Each rank's params,
    momentum and teachers then take 1/tp of one process's bytes in the
    sharded leaves."""
    with torch.device("meta"):
        model = build_deeplab_v2(C, (3, 4, 6, 3), "ProDA")
    state = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    plan = T.tensor_parallel_plan(state, tp)
    want, jax_names = _jax_sharded_leaves(tp)
    assert jax_names == {k for k in state if not k.endswith("num_batches_tracked")}
    assert set(plan) == want and set(plan.values()) == {0}
    # stem and layer-1 bn1/bn2 whole, every bn3 and downsample BN sharded, the
    # head's five branches, SE expansion and bottleneck sharded, SE squeeze and
    # classifier whole
    assert not {"conv1.weight", "bn1.weight", "layer1.0.bn1.weight", "layer1.2.bn2.weight",
                "layer6.bottleneck.0.se.0.weight", "layer6.head.1.weight"} & set(plan)
    assert {"layer1.0.bn3.weight", "layer4.2.bn3.running_var", "layer1.0.downsample.1.weight",
            "layer6.conv2d_list.4.0.weight", "layer6.conv2d_list.4.1.bias",
            "layer6.bottleneck.0.se.2.weight", "layer6.bottleneck.1.weight",
            "layer6.bottleneck.2.weight"} <= set(plan)
    whole = sum(state[k].numel() for k in plan) * 4
    rank = sum(state[k].numel() // tp for k in plan) * 4
    assert rank * tp == whole


def _setup(option, batch):
    """JAX's mesh shape, or ValueError."""
    try:
        grid, _ = jax_mesh.data_parallel_setup(None, batch, tensor_parallel=option)
        return tuple(grid.devices.shape)
    except ValueError:
        return ValueError


def _grid(option, batch, world):
    try:
        return mesh.grid_shape(option, batch, world=world)
    except ValueError:
        return ValueError


def test_tensor_parallel_guards_match_jax():
    """(b): the twins of tests/test_mesh_guards.py's TENSOR_PARALLEL guards,
    with ranks in place of devices."""
    with pytest.raises(ValueError, match="integer"):
        mesh.grid_shape(True, 8, world=8)
    with pytest.raises(ValueError, match="does not divide the 8"):
        mesh.grid_shape(3, 8, world=8)
    with pytest.raises(ValueError, match="integer"):
        jax_mesh.data_parallel_setup(None, 8, tensor_parallel=True)
    with pytest.raises(ValueError, match="does not divide the 8"):
        jax_mesh.data_parallel_setup(None, 8, tensor_parallel=3)


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_grid_shape_matches_the_jax_mesh(monkeypatch, world):
    """(b): for every option ≥ 2 × batch, the port's (data, model) grid is
    JAX's (data × model) mesh over `world` devices, and it raises where JAX
    raises, and where JAX would cap its data axis to divide the batch (idle
    devices). Rank r sits at (r // tp, r % tp), as JAX lays its devices. An
    option that asks for no model axis gives (world, 1)."""
    devices = jax.devices()[:world]
    monkeypatch.setattr(jax, "devices", lambda: devices)
    for option in (2, 3, 4, 8):
        for batch in (1, 2, 3, 4, 6, 8):
            want = _setup(option, batch)
            got = _grid(option, batch, world)
            if want is not ValueError and want[0] != world // option:
                want = ValueError  # JAX capped its data axis
            assert got == want, (option, batch, world)
            if got is not ValueError:
                grid, _ = jax_mesh.data_parallel_setup(None, batch, tensor_parallel=option)
                for r in range(world):
                    monkeypatch.setattr(distributed, "rank", lambda r=r: r)
                    monkeypatch.setattr(distributed, "world", lambda: world)
                    monkeypatch.setitem(distributed._GRID, "tp", option)
                    d, m = distributed.data_rank(), distributed.model_rank()
                    assert grid.devices[d, m].id == devices[r].id
                    assert (distributed.data_world(), distributed.model_world()) == got
                monkeypatch.setitem(distributed._GRID, "tp", 1)
    for option in (None, False, 1):
        assert mesh.grid_shape(option, 4, world=world) == (world, 1)


# ---------------------------------------------------------------------------
# (c) the autograd pieces
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """`chain_forward` on 2 ranks, each with its shards, and on one process."""
    rng = np.random.default_rng(4)
    sc = {"kind": "chain", "x": rng.normal(size=(3, 4, 6, 5)).astype(np.float32),
          "weight": rng.normal(size=(3, 8, 6, 5)).astype(np.float32)}
    tmp = tmp_path_factory.mktemp("chain")
    started = start_ranks(tmp, {"state_dict": {}, "scenarios": {"chain": sc}}, world=2)
    one = run_chain(sc, {}, 0, 1, str(tmp))
    rcs, outs, timed_out = finish_ranks(started, DEADLINE)
    assert not timed_out and rcs == [0, 0], outs
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)["scenarios"]["chain"]
             for r in range(2)]
    shutil.rmtree(tmp, ignore_errors=True)
    return one, ranks


def test_copy_to_model_and_gather_channels_match_one_process(chain):
    """(c): a chain of sharded conv → BN → conv → GroupNorm (whole groups in a
    shard) → conv → GroupNorm (one group: gathered first) → SE-like Linear →
    BN of a whole input, on 2 ranks: the output and the gradient of the
    input and of every parameter (the shards' gathered) match one process to
    f32 rounding, and every parameter of the chain was sharded."""
    one, ranks = chain
    with torch.device("meta"):
        names = {k for k, _ in chain_modules().named_parameters()}
    for r in ranks:
        assert set(r["plan"]) >= names
        torch.testing.assert_close(r["y"], one["y"], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(r["dx"], one["dx"], rtol=1e-5, atol=1e-5)
        for k in names:
            torch.testing.assert_close(r["grads"][k], one["grads"][k], rtol=1e-4, atol=1e-5,
                                       msg=k)
    assert torch.equal(ranks[0]["y"], ranks[1]["y"])
    assert torch.equal(ranks[0]["dx"], ranks[1]["dx"])


# ---------------------------------------------------------------------------
# (d)-(g) the hybrid step on the grids
# ---------------------------------------------------------------------------

def test_grids_are_the_ones_asked_for(runs):
    for name, world in GRIDS.items():
        ranks = runs["grids"][name]
        assert [r["position"] for r in ranks] == [(r // TP, r % TP) for r in range(world)]
        assert all(r["grid"] == (world // TP, TP) for r in ranks)
        assert ranks[0]["plan"] and all(r["plan"] == ranks[0]["plan"] for r in ranks)


@pytest.mark.parametrize("name", list(GRIDS))
def test_grid_step_matches_one_process(runs, inputs, name):
    """(d): bootstrap, evaluation and two hybrid steps on the grid against
    the port's one-process step on the global batch: losses, prototypes,
    monitor, switch, running statistics and every parameter's update."""
    got, want = runs["grids"][name][0], runs["one"]
    np.testing.assert_allclose(_np(got["boot_proto"]), _np(want["boot_proto"]), rtol=0,
                               atol=ONE_PROTO)
    for key in want["eval"]:
        np.testing.assert_allclose(got["eval"][key], want["eval"][key], rtol=0, atol=1e-6)
    for i in range(STEPS):
        for key in LOSSES + ("pseudolabel_pixel_num", "output & prototype agreement",
                             "model confidence ma", "dynamic forward fired"):
            np.testing.assert_allclose(got["logs"][i][key], want["logs"][i][key], rtol=ONE_RTOL,
                                       atol=1e-7, err_msg=f"{name} step {i} {key}")
        assert set(got["values"][i]) == set(want["values"][i])
        for key, w in want["values"][i].items():
            g = got["values"][i][key]
            if key.startswith("params."):
                bound = ONE_HEAD if key.startswith("params.layer6") else ONE_BACKBONE[i]
                start = inputs["state_dict"][key[len("params."):]]
                assert _update_gap(start, g, w) <= bound, (name, i, key, _update_gap(start, g, w))
            elif not w.is_floating_point():
                assert torch.equal(g, w), (name, i, key)
            else:
                atol = ONE_PROTO if key.startswith("proto.") else ONE_STATS
                np.testing.assert_allclose(_np(g), _np(w), rtol=ONE_RTOL, atol=atol,
                                           err_msg=f"{name} step {i} {key}")


@pytest.mark.parametrize("name", list(GRIDS))
def test_grid_step_matches_jax_tensor_parallel(runs, inputs, name):
    """(e): the grid against the JAX step with OTHERS.TENSOR_PARALLEL 4 on a
    (2 × 4) mesh, at tests/test_torch_step.py's tolerances: step 0 losses
    rtol 1e-4, prototypes rtol 1e-4 / atol 1e-5, the head's update to 1e-4
    and the backbone's to 5% of their largest entries (JAX's one-pass f32
    BatchNorm variance, ROADMAP §3); step 1 losses rtol 2e-3, prototypes
    atol 4e-5, the head kernel atol 6e-4. Monitor and switch as the losses,
    pseudo-labels to 0.1% of the pixels. The parameters compared are
    tests/test_torch_parallel.py's: the stem, a conv of layers 1, 3 and 4,
    the head's bottleneck and classifier (every parameter is held against
    one process in (d)."""
    got, jx = runs["grids"][name][0], runs["jax"]
    np.testing.assert_allclose(_np(got["boot_proto"]), jx["boot_proto"], rtol=1e-4, atol=1e-5)
    for i in range(STEPS):
        rtol = 1e-4 if i == 0 else 2e-3
        for key in LOSSES:
            np.testing.assert_allclose(got["logs"][i][key], jx["logs"][i][key], rtol=rtol,
                                       atol=1e-5, err_msg=f"step {i} {key}")
        assert abs(got["logs"][i]["pseudolabel_pixel_num"]
                   - jx["logs"][i]["pseudolabel_pixel_num"]) <= 0.001 * B * HR * WR
        assert got["logs"][i]["dynamic forward fired"] == jx["logs"][i]["dynamic forward fired"]
        values, jvalues = got["values"][i], jx["values"][i]
        for key in ("proto.mean", "proto.sq_mean"):
            np.testing.assert_allclose(_np(values[key]), jvalues[key], rtol=1e-4 if i == 0 else 0,
                                       atol=1e-5 if i == 0 else 4e-5, err_msg=f"step {i} {key}")
        np.testing.assert_array_equal(_np(values["proto.count"]), jvalues["proto.count"])
        for key in ("monitor.ring", "monitor.exp"):
            np.testing.assert_allclose(_np(values[key]), jvalues[key], rtol=rtol, atol=1e-6,
                                       err_msg=f"step {i} {key}")
        for key in ("monitor.count", "monitor.ptr", "monitor.started", "switch.current",
                    "switch.current_dev"):
            np.testing.assert_array_equal(_np(values[key]).astype(np.int64),
                                          jvalues[key].astype(np.int64), err_msg=key)
        if i > 0:
            np.testing.assert_allclose(_np(values["params.layer6.head.1.weight"]),
                                       jvalues["params.layer6.head.1.weight"], rtol=0, atol=6e-4)
            continue
        for key in [k for k in jvalues if k.startswith("params.")]:
            bound = 1e-4 if key.startswith("params.layer6") else 0.05
            start = inputs["state_dict"][key[len("params."):]]
            assert _update_gap(start, values[key], jvalues[key]) <= bound, key


@pytest.mark.parametrize("name", list(GRIDS))
def test_whole_leaves_keep_the_same_bits(runs, name):
    """(f): after every step, each whole (unsharded) tensor of the state has
    the same bits on every rank, each shard on the ranks of its model index,
    and the logs are equal; before their reduction, the whole leaves'
    gradients already had the same bits on the model ranks of a data index
    (`copy_to_model` summed the partial input gradients)."""
    ranks = runs["grids"][name]
    plan = set(ranks[0]["plan"])
    for i in range(STEPS):
        ref = ranks[0]["digests"][i]
        for r in ranks:
            same_model = ranks[r["position"][1]]["digests"][i]
            for k, v in r["digests"][i].items():
                sharded = k.split(".", 1)[-1] in plan
                assert v == (same_model[k] if sharded else ref[k]), (name, i, k, r["position"])
            assert r["logs"][i] == ranks[0]["logs"][i]
        for d in range(len(ranks) // TP):
            buckets = {tuple(r["whole_grads"][i]) for r in ranks if r["position"][0] == d}
            assert len(buckets) == 1 and len(next(iter(buckets))) == 1, (name, i, d)


@pytest.mark.parametrize("name", list(GRIDS))
def test_collectives_by_group(runs, name):
    """(i): per rank and step, the data group makes the data-parallel step's
    collectives (5 per BatchNorm and 6 more: tests/test_torch_parallel.py's
    count), none on a data axis of 1; the model group one gather per sharded
    norm of each of the 5 forwards (21) and one sum per sharded conv's input
    in each of the 2 backwards (14); the world one, the whole leaves'
    gradients."""
    n_bn = 17
    world = GRIDS[name]
    for r in runs["grids"][name]:
        for c in r["collectives"]:
            assert c["data"]["collectives"] == (0 if world == TP else 5 * n_bn + 6), c
            assert c["model"]["collectives"] == 5 * 21 + 2 * 14, c
            assert c["world"]["collectives"] == 1, c
    assert runs["one"]["collectives_total"] == {"collectives": 0, "bytes": 0}


@pytest.mark.parametrize("name", list(GRIDS))
def test_files_move_between_the_grid_and_one_process(runs, inputs, tmp_path, name):
    """(g): rank 0's `adapt_state.pt` holds the whole tensors in one
    process's layout (its keys and shapes those of one process's file) and
    loads into one process with the grid's state bit for bit; a file that
    one process wrote loads into the grid, every tensor of it in place
    (the grid's gathered state has the file's bits)."""
    saved, one_file = runs["files"][name], runs["one_file"]
    for tree, d in one_file.items():
        if isinstance(d, dict):
            assert {k: tuple(getattr(v, "shape", ())) for k, v in saved[tree].items()} == {
                k: tuple(getattr(v, "shape", ())) for k, v in d.items()}, tree
    ad = make_adapter(inputs["state_dict"], "hybrid_switch", {}, str(tmp_path), (H, W), B)
    ad.load_model(None, {k: dict(v) if isinstance(v, dict) else v for k, v in saved.items()})
    last = runs["grids"][name][0]["values"][-1]
    for key, v in last.items():
        tree, k = key.split(".", 1)
        held = vars(getattr(ad.state, tree))[k] if tree in ("proto", "monitor", "switch") \
            else getattr(ad.state, tree)[k]
        assert torch.equal(held, v), key
    loaded = runs["grids"][name][0]["loaded"]
    assert loaded and all(loaded[k] == v for k, v in runs["file_digests"].items())


def test_ewc_term_counts_once_on_the_grid(runs, inputs):
    """MODEL_REGULARIZATION > 0 on the (1 × 2) grid: the term enters on the
    ranks of data index 0, each with its shards and the whole leaves (whose
    gradient is summed over every rank and divided by the model axis), and
    its logged value sums the shards' parts over the model group: every
    parameter's update and the logged term equal one process's with the
    same weight. (That it enters on data index 0 alone is the data-parallel
    rule, tests/test_torch_parallel.py::test_ewc_term_counts_once.)"""
    ranks, want = runs["grids"]["ewc"], runs["one_ewc"]
    for i in range(STEPS):
        assert want["logs"][i]["model regularization"] > 0 or i == 0
        for r in ranks:
            for key in ("model regularization", "Total target loss"):
                np.testing.assert_allclose(r["logs"][i][key], want["logs"][i][key],
                                           rtol=ONE_RTOL, atol=1e-7, err_msg=f"step {i} {key}")
        got = ranks[0]["values"][i]
        for key, w in want["values"][i].items():
            if key.startswith("params."):
                bound = ONE_HEAD if key.startswith("params.layer6") else ONE_BACKBONE[i]
                start = inputs["state_dict"][key[len("params."):]]
                assert _update_gap(start, got[key], w) <= bound, (i, key)


# ---------------------------------------------------------------------------
# (h) the other families on a grid
# ---------------------------------------------------------------------------

def _two_rank_cfg(monkeypatch, config, option):
    """configs/<config>.yml with OTHERS.TENSOR_PARALLEL = option and global
    batch 2, on two ranks (the world set without a process group)."""
    monkeypatch.setattr(distributed, "world", lambda: 2)
    cfg = cfg_from_file(os.path.join(ROOT, "configs", f"{config}.yml"))
    cfg.OTHERS.TENSOR_PARALLEL = option
    cfg.TRAINING.BATCH_SIZE = 2
    return cfg


@pytest.mark.parametrize("config", ["advent", "proto_advent", "training_fog",
                                    "validation_offline_fog"])
def test_other_families_resolve_a_grid_under_tensor_parallel(monkeypatch, config):
    """(h): ADVENT, PROTO_ADVENT, SEGMENT training and EVALUATION mode no
    longer refuse OTHERS.TENSOR_PARALLEL: under 2 on two ranks each config
    resolves to a (1 × 2) grid, data axis 1, before anything is read or
    written; only JAX's guards refuse (True)."""
    cfg = _two_rank_cfg(monkeypatch, config, 2)
    assert mesh.data_axis(cfg) == 1
    assert mesh.grid_shape(cfg.OTHERS.TENSOR_PARALLEL, 2) == (1, 2)
    with pytest.raises(ValueError, match="integer"):
        mesh.data_axis(_two_rank_cfg(monkeypatch, config, True))
