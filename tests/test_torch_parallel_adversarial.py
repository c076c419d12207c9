"""OTHERS.DATA_PARALLEL for ADVENT and PROTO_ADVENT across ranks, on the CPU
with 2 gloo processes.

Two ranks (tests/torch_parallel_worker.py) take two steps of each method at
global batch 4 (b2 a rank), 32×64, R50 at layers (1, 1, 1, 1), dropout off,
the weights and both discriminators converted from the JAX package's
(advent.yml multi-level, proto_advent.yml as shipped, PROTO_ADVENT after a
bootstrap). Rank 1's source labels are mostly 255, so the ranks' valid
counts differ widely. The ranks are held against (a) the JAX adapters with
OTHERS.DATA_PARALLEL 2 on the conftest's virtual CPU devices, at
tests/test_torch_advent.py's tolerances, (b) the port's one-process steps on
the global batch, at tighter stated tolerances, and (c) each other: every
tensor, both discriminators and both Adam states equal bit for bit after
every step. The JAX steps and the one-process references run while the
ranks do.
"""

import math
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onda_tpu.config import cfg_from_file as jax_cfg_from_file
from onda_tpu.config import default_config
from onda_tpu.methods.advent import AdventAdapter as JaxAdvent
from onda_tpu.methods.proto_advent import ProtoAdventAdapter as JaxProtoAdvent
from onda_torch.models import build_deeplab_v2
from onda_torch.models.convert import flax_to_state_dict
from onda_torch.models.layers import TorchBatchNorm
from onda_torch.ops import kernels as K
from onda_torch.parallel import distributed

from .test_torch_advent import (DISC_TOL, GRAD_ENVELOPE, LOSS_TOL, TREE_TOL, WELL_CONDITIONED,
                                configure, jax_disc, jax_tree, jax_variables)
from .test_torch_parallel import _card_bn_stats
from .torch_parallel_worker import finish_ranks, run_adversarial, start_ranks, thin

B, H, W, C = 4, 32, 64, 19
STEPS, WORLD = 2, 2
LR_D = 1e-4
DEADLINE = 300  # seconds for the pair of ranks; a hang fails the tests
METHODS = {  # scenario: (config, MULTI_LEVEL, the student's LR as tests/test_torch_*advent.py)
    "advent": ("advent", True, 1e-3),
    "proto_advent": ("proto_advent", False, 1e-5),  # proto_advent.yml's (LR_RATIO 80:10)
}
ADVENT_LOSSES = ("Segmentation loss", "Adversarial loss", "Discriminator loss")
PA_LOSSES = ADVENT_LOSSES + ("ce_loss", "rce_loss", "sym_loss", "regularization_loss",
                             "Total target loss")
# (b), the ranks against one process on the global batch, whose BatchNorm
# variance is taken in f64 as K2 takes it on the card and as the ranks take
# it from their all-reduced f64 moments (tests/test_torch_parallel.py). The
# rest is the same arithmetic but for the order of a few sums (the moments',
# the counts', the gradients'). Measured on this CPU (steps 0, 1): losses
# 2.3e-7 relative; BN buffers 6e-8 and prototypes 3.6e-6 absolute; each
# parameter's update off by up to 1.6e-3 of its largest entry in the head
# (PROTO_ADVENT's tiny head LR), 1.0e-3 and 8.9e-3 in the rest; each
# discriminator weight's by 1.1e-2 of its update (Adam's first step is
# ±lr_d but for gradients near eps). Bounds ≈5-10x those.
ONE_RTOL, ONE_STATS, ONE_PROTO = 2e-6, 1e-6, 4e-5
ONE_HEAD, ONE_BACKBONE, ONE_DISC = 1e-2, (1e-2, 5e-2), 5e-2
# (a), against JAX: the discriminators' gradient here is a near cancellation
# (BCE toward 0 and toward 1 of near-equal entropy maps at near-zero logits),
# so where JAX's first moment is under DISC_NOISE[step] of its tensor's
# largest, Adam's step (±lr_d, set by the gradient's sign) is the
# rounding's: there a weight is held within 2·lr_d, elsewhere at DISC_TOL
# (measured: the 8 weights of step 0 that moved apart had |g| under 0.9% of
# the largest, of opposite signs). At step 1, whose inputs the first step's
# differences moved, Adam's second step turns on the two gradients' ratio,
# which that near cancellation leaves loose (14 weights with |g| over 10% of
# the largest moved apart by 2·lr_d): the weights are held within 2·lr_d a
# step. Adam's moments are gradients: held within GRAD_ENVELOPE of their
# largest entry at both steps (measured 1.8% at step 0).
DISC_NOISE = 0.02
# The backbone's gradients pass BatchNorms whose variance JAX takes in one
# pass in f32 (see WELL_CONDITIONED): tests/test_torch_advent.py saw them
# agree to 5% (GRAD_ENVELOPE) at b2; at this b4 they agree to 9.0% (the
# PROTO_ADVENT momentum of layer4.0's downsample at step 0), and the updates
# to 6.7% (PROTO_ADVENT step 0) and 6.5% (ADVENT step 1). The backbone is
# held within twice GRAD_ENVELOPE; the one-process comparison above bounds
# what data parallelism itself adds at 1e-2 / 5e-2. The head's parameters
# are held at TREE_TOL; its momentum within GRAD_ENVELOPE (measured 1.4%
# in PROTO_ADVENT at step 0: the features it sees pass the backbone's
# BatchNorms' forward).
BACKBONE_ENVELOPE = 2 * GRAD_ENVELOPE


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _batch(rng, n):
    return {"image": rng.normal(size=(n, H, W, 3)).astype(np.float32),
            "label": rng.integers(0, C, size=(n, H, W)).astype(np.int32)}


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _jax_adapter(name, variables, snap):
    """The JAX adapter of the scenario with OTHERS.DATA_PARALLEL 2."""
    config, multi, _ = METHODS[name]
    cfg = jax_cfg_from_file(f"configs/{config}.yml", default_config())
    spec = cfg.METHOD.ADAPTATION[cfg.METHOD.ADAPTATION.NAME]
    cfg.MODEL.MULTI_LEVEL = multi
    configure(cfg, spec, snap)
    cfg.OTHERS.DATA_PARALLEL = WORLD
    cfg.TRAINING.BATCH_SIZE = B
    jmodel, _ = jax_variables(multi)
    cls = JaxAdvent if name == "advent" else JaxProtoAdvent
    ad = cls(jmodel, variables, cfg, spec, num_classes=C)
    assert ad.mesh is not None and ad.mesh.size == WORLD
    return ad


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks, the JAX steps on a 2-device mesh and the one-process
    steps, of both methods; the JAX adapters are made first, so that all
    three start from their discriminators."""
    tmp = tmp_path_factory.mktemp("adversarial")
    rng = np.random.default_rng(0)
    boot = _batch(rng, B)
    steps = []
    for _ in range(STEPS):
        src, trg = _batch(rng, B), _batch(rng, B)
        src["label"][B // WORLD:][rng.random((B // WORLD, H, W)) < 0.8] = 255
        steps.append((src, trg))
    variables, jads, scenarios = {}, {}, {}
    for name, (config, multi, lr) in METHODS.items():
        _, variables[name] = jax_variables(multi)
        jads[name] = _jax_adapter(name, variables[name], str(tmp / f"jax_{name}"))
        jd = jads[name]
        d_aux, d_main = ((jd.state.d_aux_params, jd.state.d_main_params) if name == "advent"
                         else (jd.d_state["aux"], jd.d_state["main"]))
        scenarios[name] = {
            "kind": "adversarial", "model": name, "config": config, "multi_level": multi,
            "spec": {}, "hw": (H, W), "batch": B, "lr": lr, "lr_d": LR_D, "boot": boot,
            "steps": steps, "discs": {"d_aux": jax_disc(d_aux), "d_main": jax_disc(d_main)}}
    payload = {"scenarios": scenarios,
               "state_dicts": {n: flax_to_state_dict(v) for n, v in variables.items()}}
    started = start_ranks(tmp, payload, world=WORLD)
    try:
        jax_out = {name: _jax_steps(name, jads[name], boot, steps) for name in METHODS}
        single = _single(scenarios, payload["state_dicts"], tmp)
    finally:
        rcs, outs, timed_out = finish_ranks(started, DEADLINE)
    assert not timed_out, f"ranks still running after {DEADLINE} s (a collective deadlock?)"
    for r, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"rank {r} failed (rc {rc}):\n{out[-4000:]}"
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    out = {"ranks": ranks, "jax": jax_out, "single": single,
           "start": payload["state_dicts"], "discs0": {n: sc["discs"] for n, sc in
                                                       scenarios.items()}}
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def _jax_steps(name, jad, boot, steps):
    """Two JAX steps on the mesh; the logs and, after each, the state trees
    on the port's names."""
    if name == "proto_advent":
        jad.calculate_prototypes([boot])
        step = jad._build_pa_step()
    else:
        step = jad.step_fn()
    out = {"logs": [], "values": []}
    for src, trg in steps:
        args = (jad._place(src["image"]), jad._place(src["label"]), jad._place(trg["image"]),
                jnp.asarray(METHODS[name][2], jnp.float32), jnp.asarray(LR_D, jnp.float32))
        if name == "proto_advent":
            jad.state, jad.d_state, logs = step(jad.state, jad.d_state, *args)
            discs = {"d_aux": jad.d_state["aux"], "d_main": jad.d_state["main"],
                     "d_aux_opt": jad.d_state["aux_opt"], "d_main_opt": jad.d_state["main_opt"]}
        else:
            jad.state, logs = step(jad.state, *args)
            s = jad.state
            discs = {"d_aux": s.d_aux_params, "d_main": s.d_main_params,
                     "d_aux_opt": s.d_aux_opt, "d_main_opt": s.d_main_opt}
        s = jad.state
        values = {f"params.{k}": v for k, v in jax_tree("params", s.params).items()}
        values.update({f"opt_momentum.{k}": v
                       for k, v in jax_tree("params", s.opt_momentum).items()})
        values.update({f"batch_stats.{k}": v
                       for k, v in jax_tree("batch_stats", s.batch_stats).items()})
        if name == "proto_advent":
            values.update({f"alt_batch_stats.{k}": v
                           for k, v in jax_tree("batch_stats", s.alt_batch_stats).items()})
            values.update({f"proto.{k}": np.asarray(getattr(s.proto, k))
                           for k in ("mean", "sq_mean", "count")})
        for dname, tree in discs.items():
            if dname.endswith("_opt"):
                values.update({f"{dname}.{m}.{k}": v for m in ("mu", "nu")
                               for k, v in jax_disc(tree[m]).items()})
                values[f"{dname}.count"] = int(tree["count"])
            else:
                values.update({f"{dname}.{k}": v for k, v in jax_disc(tree).items()})
        out["logs"].append({k: float(v) for k, v in logs.items() if np.ndim(v) == 0})
        out["values"].append({k: v if isinstance(v, int) else thin(np.asarray(v))
                              for k, v in values.items()})
    return out


def _single(scenarios, state_dicts, tmp):
    """The port's steps on one process on the global batch, its BatchNorm
    variance taken as K2 takes it on the card; any all-reduce raises, and
    none is counted."""
    def refuse(*args, **kwargs):
        raise AssertionError("a collective at world size 1")

    distributed.reset_counts()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(K, "bn_stats_plain", _card_bn_stats)
        mp.setattr(torch.distributed, "all_reduce", refuse)
        mp.setattr(torch.distributed, "broadcast", refuse)
        out = {name: run_adversarial(sc, state_dicts[sc["model"]], 0, 1,
                                     str(tmp / f"single_{name}"))
               for name, sc in scenarios.items()}
    out["collectives"] = [c for o in out.values() for c in o["collectives"]]
    return out


def _gap(got, want, start):
    """max |got − want| over the largest entry of want's update from start."""
    update = np.abs(_np(want) - _np(start)).max()
    return np.abs(_np(got) - _np(want)).max() / max(update, 1e-30)


def _start(runs, name, key):
    tree, _, leaf = key.partition(".")
    if tree in ("d_aux", "d_main"):
        return thin(runs["discs0"][name][tree][leaf])
    return thin(runs["start"][name][leaf])


# ---------------------------------------------------------------------------
# (c) the ranks against each other
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(METHODS))
def test_ranks_end_every_step_with_the_same_bits(runs, name):
    """The student, its BN buffers and momentum, both discriminators and both
    Adam states (moments and `count`), the teachers, prototypes, monitor and
    generator: equal bit for bit on both ranks after every step; the logs
    equal and finite."""
    r0, r1 = (r["scenarios"][name] for r in runs["ranks"])
    assert runs["ranks"][0]["world"] == WORLD and runs["ranks"][0]["backend"] == "gloo"
    for i in range(STEPS):
        assert len(r0["digests"][i]) == len(r1["digests"][i])
        differ = [k for k, v in r0["digests"][i].items() if r1["digests"][i][k] != v]
        assert not differ, (name, i, differ[:5])
        assert r0["logs"][i] == r1["logs"][i], (name, i)
        assert all(math.isfinite(v) for v in r0["logs"][i].values()), (name, i)
    counts = {k: v for k, v in r0["values"][-1].items() if k.endswith("_opt.count")}
    want = {"d_main_opt.count": STEPS, "d_aux_opt.count": STEPS if name == "advent" else 0}
    assert {k: int(v) for k, v in counts.items()} == want, counts


@pytest.mark.parametrize("name", list(METHODS))
def test_collectives_per_step(runs, name):
    """Per rank and step: one all-reduce per train-mode BatchNorm forward and
    one per BN backward (ADVENT: the source and target forwards; PROTO_ADVENT
    also the EMA teacher's), PROTO_ADVENT's three in the teachers, then one
    each for the loss counts, the student's gradients, the discriminators'
    gradients and the logs. One process made none."""
    with torch.device("meta"):
        model = build_deeplab_v2(C, (1, 1, 1, 1), "ProDA", multi_level=METHODS[name][1])
    n_bn = sum(isinstance(m, TorchBatchNorm) for m in model.modules())  # 17
    want = 4 * n_bn + 4 if name == "advent" else 5 * n_bn + 3 + 4
    for counts in runs["ranks"][0]["scenarios"][name]["collectives"]:
        assert counts["collectives"] == want, (name, counts)
    assert all(c == {"collectives": 0, "bytes": 0} for c in runs["single"]["collectives"])


# ---------------------------------------------------------------------------
# (b) the ranks against one process on the global batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(METHODS))
def test_two_ranks_match_one_process(runs, name):
    """Losses, BN buffers, prototypes and every parameter's and discriminator
    weight's update equal one process's on the global batch within the
    bounds above; the Adam counts and the pseudo-label count exactly."""
    got, want = runs["ranks"][0]["scenarios"][name], runs["single"][name]
    for i in range(STEPS):
        for key, w in want["logs"][i].items():
            np.testing.assert_allclose(got["logs"][i][key], w, rtol=ONE_RTOL, atol=1e-7,
                                       err_msg=f"{name} step {i} {key}")
        assert set(got["values"][i]) == set(want["values"][i])
        for key, w in want["values"][i].items():
            g = got["values"][i][key]
            tree = key.split(".", 1)[0]
            if key.endswith(".count") or _np(w).dtype.kind in "biu":
                assert np.array_equal(_np(g), _np(w)), (name, i, key)
            elif tree in ("params", "d_main", "d_aux"):
                bound = (ONE_DISC if tree != "params" else ONE_HEAD
                         if key.startswith("params.layer6") else ONE_BACKBONE[i])
                gap = _gap(g, w, _start(runs, name, key))
                assert gap <= bound, (name, i, key, gap)
            elif tree in ("batch_stats", "alt_batch_stats", "proto"):
                atol = ONE_PROTO if tree == "proto" else ONE_STATS
                np.testing.assert_allclose(_np(g), _np(w), rtol=ONE_RTOL, atol=atol,
                                           err_msg=f"{name} step {i} {key}")


# ---------------------------------------------------------------------------
# (a) the ranks against the JAX adapters on a 2-device `data` mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(METHODS))
def test_two_ranks_match_jax_data_parallel(runs, name):
    """Both steps at tests/test_torch_advent.py's tolerances: the losses at
    LOSS_TOL, the WELL_CONDITIONED head's parameters at TREE_TOL and its
    momentum within GRAD_ENVELOPE, the rest of the student's momentum within BACKBONE_ENVELOPE of
    each tensor's largest entry and its update within BACKBONE_ENVELOPE of
    the update's, the BN buffers at TREE_TOL, the discriminators at DISC_TOL
    (but where the gradient is within its rounding of 0, above) and their
    Adam moments within GRAD_ENVELOPE, the counts equal; PROTO_ADVENT's
    prototypes as tests/test_torch_parallel.py holds them. Step 0 compares
    every tensor, step 1 the selected ones."""
    got, want = runs["ranks"][0]["scenarios"][name], runs["jax"][name]
    losses = ADVENT_LOSSES if name == "advent" else PA_LOSSES
    for i in range(STEPS):
        for key in losses:
            np.testing.assert_allclose(got["logs"][i][key], want["logs"][i][key],
                                       err_msg=f"{name} step {i} {key}", **LOSS_TOL)
        values, jvalues = got["values"][i], want["values"][i]
        for key, g in values.items():
            if key not in jvalues or key.endswith("num_batches_tracked"):
                continue
            w, tree = jvalues[key], key.split(".", 1)[0]
            leaf = key.split(".", 1)[1]
            if key.endswith("_opt.count"):
                assert int(g) == int(w), (name, i, key)
            elif tree == "params" and not leaf.startswith(WELL_CONDITIONED):
                # the update from the same start, against its largest entry
                # (PARAM_ENVELOPE's atol is below what the gradients' envelope
                # allows at PROTO_ADVENT's backbone LR)
                gap = _gap(g, w, _start(runs, name, key))
                assert gap <= BACKBONE_ENVELOPE, (name, i, key, gap)
            elif tree in ("opt_momentum", "d_aux_opt", "d_main_opt"):
                err = np.abs(_np(g) - w).max() / max(np.abs(w).max(), 1e-30)
                bound = (BACKBONE_ENVELOPE if tree == "opt_momentum"
                         and not leaf.startswith(WELL_CONDITIONED) else GRAD_ENVELOPE)
                assert err <= bound, (name, i, key, err)
            elif tree in ("d_aux", "d_main"):
                mu = jvalues[f"{tree}_opt.mu.{leaf}"]
                noise = (np.abs(mu) < DISC_NOISE * np.abs(mu).max() if i == 0
                         else np.ones(mu.shape, bool))
                diff = np.abs(_np(g) - w)
                np.testing.assert_allclose(_np(g)[~noise], w[~noise],
                                           err_msg=f"{name} {i} {key}", **DISC_TOL)
                assert (diff[noise] <= 2 * LR_D * (i + 1) + DISC_TOL["atol"]).all(), (name, i, key)
            elif tree == "proto":
                np.testing.assert_allclose(_np(g), w, rtol=1e-4, atol=1e-5,
                                           err_msg=f"{name} {i} {key}")
            else:
                np.testing.assert_allclose(_np(g), w, err_msg=f"{name} {i} {key}", **TREE_TOL)
    assert len(got["values"][0]) > 100  # step 0 compares every tensor
