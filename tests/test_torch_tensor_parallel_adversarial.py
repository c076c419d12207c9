"""OTHERS.TENSOR_PARALLEL for ADVENT, PROTO_ADVENT and SEGMENT training on a
(data × model) grid of ranks, on the CPU with gloo ranks.

Two ranks on a (1 × 2) grid (tests/torch_parallel_worker.py, one launch for
the three methods) take two steps of ADVENT (advent.yml, multi-level) and of
PROTO_ADVENT (proto_advent.yml, after a bootstrap), and one SEGMENT epoch of
two steps (training_fog.yml's multi-level model) with its evaluation, at R50
layers (1, 1, 1, 1), 32×64, global batch 4, dropout off, the weights and
discriminators converted from the JAX package's. They are held against (a)
JAX's `tensor_parallel_shardings` on `AdventState` at full width, (b) the
port's one process on the global batch, every BatchNorm's variance taken as
K2 takes it on the card in both (`card_bn_stats`), (c) the JAX adapters and
trainer with OTHERS.TENSOR_PARALLEL 4 on the conftest's 8 virtual devices (a
(2 × 4) mesh), (d) each other and one process through their files, and (e)
the collectives they make by group. The JAX runs and the one-process
references run while the ranks do.
"""

import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onda_tpu.methods import optim as jax_optim
from onda_tpu.models import build_deeplab_v2 as jax_build
from onda_tpu.models.discriminator import FCDiscriminator as JaxDiscriminator
from onda_tpu.parallel import mesh as jax_mesh
from onda_torch import registry
from onda_torch.methods import advent
from onda_torch.models import build_deeplab_v2
from onda_torch.models.convert import flax_to_state_dict, torch_key
from onda_torch.ops import kernels as K
from onda_torch.parallel import distributed

from .test_torch_advent import jax_disc, jax_variables
from .test_torch_parallel_adversarial import (LR_D, METHODS, _jax_adapter, check_against_jax,
                                              jax_steps)
from .test_torch_parallel_eval import RAW_HW, check_segment_against_jax, jax_segment
from .torch_parallel_worker import (adversarial_tensors, card_bn_stats, digest, finish_ranks,
                                    make_adversarial, run_adversarial, run_segment,
                                    start_ranks, thin)

B, H, W, C = 4, 32, 64, 19
STEPS, TP, WORLD = 2, 2, 2  # a (1 × 2) grid
SEG_LR = 2e-2  # tests/test_torch_parallel_eval.py's: training_fog.yml's moves too little
N_VAL = 8
DEADLINE = 300  # seconds for the grid's ranks; a hang fails the tests
SCENARIOS = (*METHODS, "segment")
# (b), the grid against one process on the global batch, every BatchNorm's
# variance as K2 takes it on the card in both. Only the rounding of the
# half-width convolutions and the order of the model group's sums differ.
# The losses, BN buffers and prototypes are held at
# tests/test_torch_tensor_parallel.py's (d) bounds (measured on the CPU: losses
# 1.7e-7 relative, ADVENT's and SEGMENT's equal; buffers 4.4e-7, prototypes
# 3.8e-6 absolute). Its parameter bounds were set on the hybrid step, whose
# student LR is 1e-5; ADVENT's 1e-3, PROTO_ADVENT's head at 10x its LR and
# SEGMENT's 2e-2 carry the half-width convolutions' last bits further
# (measured: each update off by up to 7.9e-4 of its largest entry in the
# head, 6.4e-4 / 4.0e-3 in the rest at steps 0 / 1), so the updates are
# held ≈10x those, as tests/test_torch_parallel_adversarial.py holds two
# data ranks (its 1e-2 / 5e-2 fit too). The discriminators' weights: Adam's
# first step moves each by ±lr_d, the sign of a near-cancelling gradient, so
# a weight whose gradient is within rounding of 0 could take the other sign;
# none did (measured 1.5e-2 lr_d), held within ONE_DISC lr_d. Their Adam
# moments (the gradients, near cancellations of two BCEs) within ONE_MOMENT
# of their largest entry at steps 0 / 1 (measured 8.6e-6 / 1.6e-2: the
# second step's maps carry the first's differences).
ONE_RTOL, ONE_PROTO, ONE_STATS = 2e-6, 4e-5, 4e-6
ONE_HEAD, ONE_BACKBONE, ONE_DISC, ONE_MOMENT = 8e-3, (6e-3, 4e-2), 0.15, (1e-4, 0.15)
# The adversarial gradient's share of ADVENT's update is ≈1e-5 (LAMBDA_ADV),
# below what the parameter bounds above can see. So ADVENT also takes a
# fool-only step (source labels ignored, no weight decay), after which the
# student's SGD momentum is the fool losses' gradient alone: it reaches the
# student only through the sharded discriminators' input gradients. Held
# within FOOL_GRAD of its largest entry, in the head and in the backbone
# (measured 4.0e-7 and 1.2e-6); a rank's share missed or doubled would be
# off by O(1).
FOOL_GRAD = 2e-5
# (c) against JAX: tests/test_torch_parallel_adversarial.py's tolerances for
# ADVENT and PROTO_ADVENT (tests/test_torch_advent.py's LOSS_TOL, TREE_TOL
# and DISC_TOL; the backbone within twice GRAD_ENVELOPE, because JAX takes
# the BatchNorm variance in one f32 pass: WELL_CONDITIONED) and
# tests/test_torch_parallel_eval.py's for SEGMENT; JAX's (2 × 4) mesh and
# the port's (1 × 2) grid compute the same global batch.


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _batch(rng, n, raw=False):
    out = {"image": rng.normal(size=(n, H, W, 3)).astype(np.float32),
           "label": rng.integers(0, C, size=(n, H, W)).astype(np.int32)}
    if raw:
        out["label_raw"] = rng.integers(0, C, size=(n, *RAW_HW)).astype(np.int32)
    return out


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _moved(tensors: dict, seed: int) -> dict:
    """Every float tensor moved off its value in place (so that a load that
    drops or misplaces a shard shows)."""
    g = torch.Generator().manual_seed(seed)
    for v in tensors.values():
        if v.is_floating_point():
            v.add_(torch.rand(v.shape, generator=g))
    return tensors


def _one_process_files(scenarios, state_dicts, tmp):
    """An `advent_state.pt` that one process wrote (its ADVENT state moved off
    the start) and a student `.pth` of PROTO_ADVENT's model; the digests of
    what each holds, by the worker's flat names."""
    ad = make_adversarial({**scenarios["advent"], "tp": None}, state_dicts["advent"],
                          str(tmp / "one_advent_file"))
    _moved(adversarial_tensors(ad), 9)
    ad.save_model()
    advent_file = tmp / "one_advent_file" / "advent_state.pt"
    advent_digests = {k: digest(v) for k, v in adversarial_tensors(ad).items()}
    sd = _moved({k: v.clone() for k, v in state_dicts["proto_advent"].items()}, 10)
    pth = tmp / "model_train_one.pth"
    torch.save(sd, pth)
    return ({"advent": str(advent_file), "pth": str(pth)},
            {"advent": advent_digests, "pth": {k: digest(v) for k, v in sd.items()}})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The grid's ranks; meanwhile the JAX adapters and trainer with
    OTHERS.TENSOR_PARALLEL 4 and the port's one-process references."""
    tmp = tmp_path_factory.mktemp("tp_adversarial")
    rng = np.random.default_rng(0)
    boot = _batch(rng, B)
    steps = []
    for _ in range(STEPS):
        src, trg = _batch(rng, B), _batch(rng, B)
        src["label"][B // 2:][rng.random((B // 2, H, W)) < 0.8] = 255
        steps.append((src, trg))
    seg_batches = [_batch(rng, B) for _ in range(STEPS)]
    val = [_batch(rng, B, raw=True) for _ in range(N_VAL // B)]
    variables, jads, scenarios = {}, {}, {}
    for name, (config, multi, lr) in METHODS.items():
        _, variables[name] = jax_variables(multi)
        jads[name] = _jax_adapter(name, variables[name], str(tmp / f"jax_{name}"),
                                  others={"TENSOR_PARALLEL": 4})
        jd = jads[name]
        d_aux, d_main = ((jd.state.d_aux_params, jd.state.d_main_params) if name == "advent"
                         else (jd.d_state["aux"], jd.d_state["main"]))
        scenarios[name] = {
            "kind": "adversarial", "model": name, "config": config, "multi_level": multi,
            "spec": {}, "hw": (H, W), "batch": B, "lr": lr, "lr_d": LR_D, "boot": boot,
            "steps": steps, "discs": {"d_aux": jax_disc(d_aux), "d_main": jax_disc(d_main)}}
    ignored = {**steps[0][0], "label": np.full_like(steps[0][0]["label"], 255)}
    scenarios["advent_fool"] = {**scenarios["advent"], "spec": {"WEIGHT_DECAY": 0.0},
                                "steps": [(ignored, steps[0][1])]}
    scenarios["segment"] = {"kind": "segment", "model": "advent", "hw": (H, W), "raw_hw": RAW_HW,
                            "batch": B, "lr": SEG_LR, "steps": seg_batches, "val": val}
    state_dicts = {n: flax_to_state_dict(v) for n, v in variables.items()}
    files, file_digests = _one_process_files(scenarios, state_dicts, tmp)
    grid = {name: {**sc, "tp": TP, "card_bn": True} for name, sc in scenarios.items()}
    grid["advent"]["load"], grid["proto_advent"]["load"] = files["advent"], files["pth"]
    for name in ("proto_advent", "advent_fool"):  # no test reads their files
        grid[name]["drop_snapshot"] = True
    started = start_ranks(tmp, {"scenarios": grid, "state_dicts": state_dicts}, world=WORLD)
    try:
        jax_out = {name: jax_steps(name, jads[name], boot, steps) for name in METHODS}
        del jads
        jax_out["segment"] = jax_segment(variables["advent"], seg_batches, val,
                                         str(tmp / "jax_segment"), others={"TENSOR_PARALLEL": 4})
        one = _one_process(scenarios, state_dicts, tmp)
    finally:
        rcs, outs, timed_out = finish_ranks(started, DEADLINE)
    assert not timed_out, f"the grid still running after {DEADLINE} s (a collective deadlock?)"
    for r, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"rank {r} failed (rc {rc}):\n{out[-4000:]}"
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)["scenarios"]
             for r in range(WORLD)]
    saved = {"advent": torch.load(tmp / "snap_advent_0" / "advent_state.pt", weights_only=False),
             "advent_one": torch.load(files["advent"], weights_only=False),
             "pth": torch.load(tmp / "snap_segment_0" / "model_train_[[0]].pth",
                               weights_only=False)}
    shutil.rmtree(tmp, ignore_errors=True)
    return {"ranks": ranks, "jax": jax_out, "one": one, "saved": saved, "state_dicts": state_dicts,
            "discs0": {n: sc["discs"] for n, sc in scenarios.items() if n in METHODS},
            "file_digests": file_digests, "scenarios": scenarios}


def _one_process(scenarios, state_dicts, tmp):
    """The three scenarios in one process on the global batch, its BatchNorm
    variance taken as K2 takes it on the card; any collective raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("a collective at world size 1")

    run = {"adversarial": run_adversarial, "segment": run_segment}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(K, "bn_stats_plain", card_bn_stats)
        mp.setattr(torch.distributed, "all_reduce", refuse)
        mp.setattr(torch.distributed, "broadcast", refuse)
        return {name: run[sc["kind"]](sc, state_dicts[sc["model"]], 0, 1, str(tmp / f"one_{name}"))
                for name, sc in scenarios.items()}


def _start(runs, name, key):
    tree, _, leaf = key.partition(".")
    if tree in ("d_aux", "d_main"):
        return thin(runs["discs0"][name][tree][leaf])
    return thin(runs["state_dicts"]["advent" if name == "segment" else name][leaf])


def _update_gap(got, want, start):
    """max |got − want| over the largest entry of want's update from start."""
    update = np.abs(_np(want) - _np(start)).max()
    return np.abs(_np(got) - _np(want)).max() / max(update, 1e-30)


# ---------------------------------------------------------------------------
# (a) the plan over AdventState at full width
# ---------------------------------------------------------------------------

def _jax_advent_sharded(tp, layers):
    """The port's flat names of the JAX `AdventState` leaves at full width
    that `tensor_parallel_shardings` shards on a model axis of tp (from the
    shapes alone), and every name."""
    model = jax_build(num_classes=C, layers=layers, multi_level=True)
    disc = JaxDiscriminator()

    def state():
        variables = model.init(jax.random.key(0), jnp.zeros((1, 65, 65, 3)), train=False)
        d = disc.init(jax.random.key(1), jnp.zeros((1, H, W, C)))["params"]
        return {"params": variables["params"], "batch_stats": variables["batch_stats"],
                "opt_momentum": variables["params"], "d_aux": d, "d_aux_opt": jax_optim.adam_init(d),
                "d_main": d, "d_main_opt": jax_optim.adam_init(d)}

    specs = jax_mesh.tensor_parallel_shardings(
        jax_mesh.make_mesh(shape=(8 // tp, tp), axes=("data", "model")), jax.eval_shape(state))
    sharded, names = set(), set()
    for path, sharding in jax.tree_util.tree_flatten_with_path(specs)[0]:
        keys = tuple(p.key for p in path)
        tree, rest = keys[0], keys[1:]
        if tree.startswith("d_"):
            leaf = ".".join(rest[:-1] + ({"kernel": "weight"}.get(rest[-1], rest[-1]),))
            name = f"{tree}.{leaf}"
        else:
            name = f"{tree}.{torch_key(('batch_stats' if tree == 'batch_stats' else 'params',) + rest)}"
        names.add(name)
        if "model" in tuple(sharding.spec):
            assert tuple(sharding.spec)[-1] == "model", name  # JAX's last axis
            sharded.add(name)
    return sharded, names


@pytest.fixture(scope="module")
def full_width():
    """advent.yml's model at full R50 width and depth, seeded, and its
    one-process ADVENT adapter's flat tensors."""
    layers = registry.LAYERS["DeepLabv2-Resnet50"]
    torch.manual_seed(0)
    model = build_deeplab_v2(C, layers, "ProDA", multi_level=True)
    return layers, model


def _advent_adapter(model, tp, monkeypatch):
    """ADVENT's adapter of advent.yml on model, as model rank 0 of a grid of
    tp holds it (the grid's shape set without a process group)."""
    from onda_torch.config import cfg_from_file

    cfg = cfg_from_file("configs/advent.yml")
    cfg.TRAINING.BATCH_SIZE = 2
    monkeypatch.setattr(advent, "resolve", lambda cfg: (1, tp))
    monkeypatch.setitem(distributed._GRID, "tp", tp)
    try:
        return advent.AdventAdapter(model, registry.variables_of(model), cfg,
                                    cfg.METHOD.ADAPTATION.ADVENT, C, device="cpu")
    finally:
        monkeypatch.setitem(distributed._GRID, "tp", 1)


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_plan_shards_the_jax_advent_state_leaves(full_width, monkeypatch, tp):
    """(a): at full R50 width the leaves an ADVENT adapter holds as shards on
    a model axis of tp, the student's, its BN buffers' and momentum's and
    both discriminators' with their Adam moments, are exactly those JAX's
    rule shards on `AdventState` (conv1-conv3 of each discriminator, conv0
    and conv4 whole; the Adam `count` whole); each is cut to 1/tp on axis 0
    and the rank holds 1/tp of their bytes."""
    layers, model = full_width
    want, jax_names = _jax_advent_sharded(tp, layers)
    ranked = adversarial_tensors(_advent_adapter(model, tp, monkeypatch))
    whole = adversarial_tensors(_advent_adapter(model, 1, monkeypatch))
    names = {k for k in whole if k != "generator" and not k.endswith("num_batches_tracked")}
    assert names == jax_names
    cut = {k for k in names if ranked[k].shape != whole[k].shape}
    assert cut == want
    for k in cut:
        assert ranked[k].shape == (whole[k].shape[0] // tp, *whole[k].shape[1:]), k
    assert {k for k in cut if k.startswith("d_")} == {
        f"{tree}.conv{i}.{p}" for tree in ("d_aux", "d_main", "d_aux_opt.mu", "d_aux_opt.nu",
                                           "d_main_opt.mu", "d_main_opt.nu")
        for i in (1, 2, 3) for p in ("weight", "bias")}
    assert sum(ranked[k].numel() for k in cut) * tp == sum(whole[k].numel() for k in cut)


def test_proto_advent_discriminators_stay_whole(runs):
    """(a), (d): JAX replicates PROTO_ADVENT's discriminator state beside its
    sharded `AdaptState` (`replicate_tree`); on the grid each rank holds
    both discriminators and their Adam states whole, one process's bytes,
    while each ADVENT rank holds half of `d_main`'s conv1-conv3 and their
    moments."""
    d = {k: jnp.zeros(v.shape) for k, v in runs["discs0"]["proto_advent"]["d_main"].items()}
    grid = jax_mesh.make_mesh(shape=(2, 4), axes=("data", "model"))
    for leaf in jax.tree.leaves(jax_mesh.replicate_tree(grid, {"main": d})):
        assert "model" not in tuple(leaf.sharding.spec)
    for r in runs["ranks"]:
        assert r["proto_advent"]["disc_bytes"] == runs["one"]["proto_advent"]["disc_bytes"]
        assert r["advent"]["disc_bytes"] < 0.6 * runs["one"]["advent"]["disc_bytes"]
        assert r["advent"]["grid"] == r["proto_advent"]["grid"] == (1, TP)


# ---------------------------------------------------------------------------
# (b) the grid against one process on the global batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(METHODS))
def test_grid_matches_one_process(runs, name):
    """(b): ADVENT's and PROTO_ADVENT's losses (each BCE divided by the data
    axis's ranks: a (1 × 2) grid's are one process's, not half of them), BN
    buffers, prototypes, every parameter's update and the discriminators'
    weights and Adam moments, the shards gathered, equal one process's on
    the global batch within the bounds above; the Adam counts exactly."""
    got, want = runs["ranks"][0][name], runs["one"][name]
    for i in range(STEPS):
        for key, w in want["logs"][i].items():
            np.testing.assert_allclose(got["logs"][i][key], w, rtol=ONE_RTOL, atol=1e-7,
                                       err_msg=f"{name} step {i} {key}")
        assert set(got["values"][i]) == set(want["values"][i])
        for key, w in want["values"][i].items():
            g, tree = got["values"][i][key], key.split(".", 1)[0]
            if key.endswith(".count") or _np(w).dtype.kind in "biu":
                assert np.array_equal(_np(g), _np(w)), (name, i, key)
            elif tree in ("d_main", "d_aux"):
                assert np.abs(_np(g) - _np(w)).max() <= ONE_DISC * LR_D, (name, i, key)
            elif tree.endswith("_opt"):
                err = np.abs(_np(g) - _np(w)).max() / max(np.abs(_np(w)).max(), 1e-30)
                assert err <= ONE_MOMENT[i], (name, i, key, err)
            elif tree == "params":
                bound = ONE_HEAD if key.startswith("params.layer6") else ONE_BACKBONE[i]
                gap = _update_gap(g, w, _start(runs, name, key))
                assert gap <= bound, (name, i, key, gap)
            else:
                atol = ONE_PROTO if tree == "proto" else ONE_STATS
                np.testing.assert_allclose(_np(g), _np(w), rtol=ONE_RTOL, atol=atol,
                                           err_msg=f"{name} step {i} {key}")
    assert len(got["values"][0]) > 100  # step 0 compares every tensor


def test_fool_gradient_matches_one_process(runs):
    """(b): ADVENT's fool-only step on the grid: the student's gradient
    through the sharded discriminators equals one process's within
    FOOL_GRAD, the shards gathered."""
    got, want = runs["ranks"][0]["advent_fool"], runs["one"]["advent_fool"]
    assert got["logs"][0]["Segmentation loss"] == want["logs"][0]["Segmentation loss"] == 0.0
    assert want["logs"][0]["Adversarial loss"] > 0
    for head in (True, False):
        keys = [k for k in want["values"][0] if k.startswith("opt_momentum.")
                and k.startswith("opt_momentum.layer6") == head]
        scale = max(np.abs(_np(want["values"][0][k])).max() for k in keys)
        gap = max(np.abs(_np(got["values"][0][k]) - _np(want["values"][0][k])).max()
                  for k in keys) / scale
        assert scale > 0 and gap <= FOOL_GRAD, (head, gap)


def test_segment_grid_matches_one_process(runs):
    """(b): SEGMENT's loss and LRs, every parameter's update (the shards
    gathered) and the BN buffers equal one process's within the bounds
    above, and the epoch's records (the evaluation's mIoU at both sizes and
    entropy) within the trained weights' own gap."""
    got, want = runs["ranks"][0]["segment"], runs["one"]["segment"]
    assert got["lr"] == want["lr"]
    for i in range(STEPS):
        assert got["loss"][i] == pytest.approx(want["loss"][i], rel=ONE_RTOL), i
        for key, w in want["values"][i].items():
            g = got["values"][i][key]
            if key.startswith("params."):
                bound = ONE_HEAD if key.startswith("params.layer6") else ONE_BACKBONE[i]
                gap = _update_gap(g, w, _start(runs, "segment", key))
                assert gap <= bound, (i, key, gap)
            elif _np(w).dtype.kind == "f":
                np.testing.assert_allclose(_np(g), _np(w), rtol=ONE_RTOL, atol=ONE_STATS,
                                           err_msg=f"{i} {key}")
    records, one = got["records"], want["records"]
    assert [set(r) for r in records] == [set(r) for r in one]
    for key, value in one[-1].items():
        assert records[-1][key] == pytest.approx(value, rel=1e-3, abs=1e-6), key


# ---------------------------------------------------------------------------
# (c) the grid against JAX with OTHERS.TENSOR_PARALLEL 4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SCENARIOS)
def test_grid_matches_jax_tensor_parallel(runs, name):
    """(c): each method on the grid against the JAX adapter (SEGMENT: the JAX
    trainer) with OTHERS.TENSOR_PARALLEL 4 on a (2 × 4) mesh of the 8
    virtual devices, at the tolerances of the data-parallel comparisons
    (above); the grid's shards gathered."""
    got = runs["ranks"][0][name]
    if name == "segment":
        check_segment_against_jax(got["loss"], got, runs["jax"]["segment"],
                                  runs["state_dicts"]["advent"])
    else:
        check_against_jax(got, runs["jax"][name], name, lambda key: _start(runs, name, key))


# ---------------------------------------------------------------------------
# (d) bits and files
# ---------------------------------------------------------------------------

def _sharded(run, key):
    """Whether the flat name `key` is a channel shard in `run` (the student's
    plan; the discriminators' and their Adam moments')."""
    tree, _, leaf = key.partition(".")
    if tree in ("d_aux_opt", "d_main_opt"):
        return leaf.partition(".")[2] in run.get("disc_plan", ())
    return leaf in (run.get("disc_plan", ()) if tree.startswith("d_") else run["plan"])


@pytest.mark.parametrize("name", SCENARIOS)
def test_whole_leaves_keep_the_same_bits(runs, name):
    """(d): after every step each whole tensor of the state (the student's
    narrow leaves and its teachers', prototypes and monitor; both
    discriminators of PROTO_ADVENT; ADVENT's conv0 and conv4 and the Adam
    counts) has the same bits on both ranks, each rank holds its own half of
    every sharded backbone and discriminator conv weight, and the logs are
    equal."""
    r0, r1 = (r[name] for r in runs["ranks"])
    assert r0["plan"] and r0["plan"] == r1["plan"]
    assert bool(r0.get("disc_plan")) == (name == "advent")
    for i in range(STEPS):
        digests = r0["digests"][i]
        whole = [k for k in digests if not _sharded(r0, k)]
        differ = [k for k in whole if r1["digests"][i][k] != digests[k]]
        assert len(whole) > 50 and not differ, (name, i, differ[:5])
        convs = [k for k in digests if _sharded(r0, k)
                 and re.fullmatch(r"params\.layer\d\.\d\.conv\d\.weight|d_\w+\.conv\d\.weight", k)]
        assert convs and all(r1["digests"][i][k] != digests[k] for k in convs), (name, i)
        if name == "segment":
            assert r0["loss"][i] == r1["loss"][i]
        else:
            assert r0["logs"][i] == r1["logs"][i]


def test_advent_state_moves_between_the_grid_and_one_process(runs, tmp_path):
    """(d): the grid's `advent_state.pt` holds the whole tensors in one
    process's layout (the keys and shapes of one process's file) and loads
    into one process with the grid's state bit for bit; a file that one
    process wrote loads into the grid, every tensor of it in place."""
    saved, one = runs["saved"]["advent"], runs["saved"]["advent_one"]
    assert set(saved) == set(one)
    for tree, d in one.items():
        if isinstance(d, dict):
            assert ({k: tuple(getattr(v, "shape", ())) for k, v in saved[tree].items()}
                    == {k: tuple(getattr(v, "shape", ())) for k, v in d.items()}), tree
    ad = make_adversarial({**runs["scenarios"]["advent"], "tp": None},
                          runs["state_dicts"]["advent"], str(tmp_path))
    ad.load_model(None, dict(saved))
    held = {k: digest(v) for k, v in adversarial_tensors(ad).items()}
    assert held == runs["ranks"][0]["advent"]["final"]
    assert runs["ranks"][0]["advent"]["loaded"] == runs["file_digests"]["advent"]


def test_model_train_pth_moves_between_the_grid_and_one_process(runs):
    """(d): the grid's SEGMENT `model_train_[[0]].pth` is one process's
    state_dict of the model, every tensor whole and equal to the grid's
    gathered state, and loads into the model strictly; a `.pth` that one
    process wrote loads into the grid's PROTO_ADVENT adapter, its student
    every tensor of the file."""
    saved = runs["saved"]["pth"]
    model = build_deeplab_v2(C, (1, 1, 1, 1), "ProDA", multi_level=True, droprate=0.0)
    assert {k: tuple(v.shape) for k, v in saved.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    model.load_state_dict(saved, strict=True)
    assert {k: digest(v) for k, v in saved.items()} == runs["ranks"][0]["segment"]["final"]
    loaded = runs["ranks"][0]["proto_advent"]["loaded"]
    want = runs["file_digests"]["pth"]
    for k, v in want.items():
        tree = "params" if f"params.{k}" in loaded else "batch_stats"
        assert loaded[f"{tree}.{k}"] == v, k


# ---------------------------------------------------------------------------
# (e) the collectives by group
# ---------------------------------------------------------------------------

# R50 at layers (1, 1, 1, 1) with a ProDA head on a model axis of 2: the
# norms a forward gathers after (14 BatchNorms, the head's 5 branch and
# bottleneck GroupNorms and its SE), the sharded convs' shared inputs whose
# gradient a backward sums (11 in the backbone, 3 in the head), and the same
# for the multi-level aux head (7, 3); an ADVENT discriminator's 3 sharded
# convs (a gather after each in a forward, a sum at each input in a backward)
NORMS, INPUTS, AUX_NORMS, AUX_INPUTS, DISC = 21, 14, 7, 3, 3
WANT_COLLECTIVES = {
    # 2 student forwards with the aux head and their backward; 6 discriminator
    # forwards (the student's BCE through d_main and d_aux, and each
    # discriminator's loss on the source and target maps); the backward of
    # the student's BCE through both, and of each discriminator's loss
    "advent": {"data": 0, "world": 2,
               "model": 2 * (NORMS + AUX_NORMS) + 6 * DISC + 2 * (INPUTS + AUX_INPUTS)
               + 2 * DISC + 2 * 2 * DISC},
    # the EMA, static and (gated, fired here) dynamic teachers, the source and
    # target slices; the discriminators are whole: no model-group call
    "proto_advent": {"data": 0, "world": 2, "model": 5 * NORMS + 2 * INPUTS},
    "segment": {"data": 0, "world": 1, "model": NORMS + AUX_NORMS + INPUTS + AUX_INPUTS},
}


@pytest.mark.parametrize("name", SCENARIOS)
def test_collectives_by_group(runs, name):
    """(e): per rank and step on the (1 × 2) grid, no data-group collective
    (a data axis of 1); in the model group a gather after each sharded norm
    of every forward and a sum of each sharded conv's input gradient in
    every backward, the discriminators' (ADVENT) among them; in the world
    group the buckets of whole leaves' gradients: the student's, and the
    discriminators' (ADVENT and PROTO_ADVENT). One process made none."""
    want = WANT_COLLECTIVES[name]
    assert want["model"] == {"advent": 126, "proto_advent": 133, "segment": 45}[name]
    for r in runs["ranks"]:
        for c in r[name]["by_group"]:
            assert {g: c[g]["collectives"] for g in c} == want, (name, c)
    assert all(c == {"collectives": 0, "bytes": 0} for c in runs["one"][name]["collectives"])
