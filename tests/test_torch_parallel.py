"""OTHERS.DATA_PARALLEL for the PROTO_ONLINE family across ranks
(`onda_torch/parallel`), on the CPU with 2 gloo processes.

Two ranks of the hybrid step (R50 at layers (1, 1, 1, 1), 32×64, global batch
4, weights converted from the JAX variables, dropout off) are held against
(a) the JAX `ProtoOnlineAdapter` with OTHERS.DATA_PARALLEL 2 on the conftest's
virtual CPU devices, at the tolerances of tests/test_torch_step.py, and (b)
the port's own one-process step on the global batch, at a tighter tolerance.
The ranks must end every step with the same bits. The workers
(tests/torch_parallel_worker.py) run under a deadline, with their output in
files, and are killed when it passes. A 2-rank CLI run goes through
`python -m torch.distributed.run -m onda_torch.train_ouda`.
"""

import contextlib
import io
import json
import math
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from onda_tpu.config import cfg_from_file as jax_cfg_from_file
from onda_tpu.config import default_config
from onda_tpu.methods.proto_online import ProtoOnlineAdapter as JaxAdapter
from onda_tpu.models import build_deeplab_v2 as jax_build
from onda_tpu.parallel import distributed as jax_distributed
from onda_tpu.parallel import mesh as jax_mesh
from onda_torch import registry, train_ouda
from onda_torch.config import cfg_from_file
from onda_torch.methods import optim
from onda_torch.models import build_deeplab_v2
from onda_torch.models.convert import flax_to_state_dict
from onda_torch.ops import kernels as K
from onda_torch.parallel import distributed, mesh

from .synthetic import make_synthetic_dataset
from .torch_parallel_worker import (SELECTED, finish_ranks, make_adapter, nchw, record,
                                    start_ranks, val_loader)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
B, H, W, C = 4, 32, 64, 19
HR, WR = H // 8 + 1, W // 8 + 1
STEPS, LR, WORLD = 2, 1e-3, 2
DEADLINE = 300  # seconds for a pair of workers; a hang fails the test
EWC = 20.0
SCENARIOS = {  # name: (config, spec overrides)
    "hybrid": ("hybrid_switch", {}),
    "ewc": ("hybrid_switch", {"MODEL_REGULARIZATION": EWC}),
}
LOSSES = ("ce_loss", "rce_loss", "regularization_loss", "buff_ce_loss", "Total target loss")
# (b), the two ranks against one process on the global batch. The ranks take
# each BatchNorm's variance in f64 from the all-reduced f64 moments, as K2
# takes it for one device on the card; the plain K2 on the CPU takes it in
# f32 (E[x²] − E[x]², JAX's formula), whose rounding moves this small
# model's backbone updates by up to 2% at step 0. So the one-process
# reference here takes its variance as the card does (`_card_bn_stats`).
# The rest is the same arithmetic but for the order of a few sums (the
# moments' and the gradients' all-reduces). Measured (PR 9), the bounds are
# about 10x: losses 2.0e-7 relative; prototypes 3.8e-6 absolute; monitor
# and running statistics 6.0e-8 absolute; each parameter's update off by
# 3.0e-6 of its largest entry in the head, 4.0e-6 in the backbone at step 0
# and 1.8e-3 at step 1 (the backbone's LR ×80 spreads the rounding).
ONE_RTOL, ONE_PROTO, ONE_STATS = 2e-6, 4e-5, 1e-6
ONE_HEAD, ONE_BACKBONE = 3e-5, (5e-5, 2e-2)


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _batch(rng, n):
    return {"image": rng.normal(size=(n, H, W, 3)).astype(np.float32),
            "label": rng.integers(0, C, size=(n, H, W)).astype(np.int32),
            "label_res": rng.integers(0, C, size=(n, HR, WR)).astype(np.int32)}


@pytest.fixture(scope="module")
def inputs():
    """The JAX variables and the global batches. Rank 1's source labels are
    mostly 255, so the ranks' valid-pixel counts differ widely."""
    rng = np.random.default_rng(0)
    jmodel = jax_build(num_classes=C, layers=(1, 1, 1, 1), droprate=0.0)
    variables = jax.tree.map(np.asarray, dict(
        jmodel.init(jax.random.key(0), jnp.zeros((1, H, W, 3)), train=False)))
    boot, val = _batch(rng, B), _batch(rng, 6)
    steps = []
    for _ in range(STEPS):
        src, trg = _batch(rng, B), _batch(rng, B)
        hidden = rng.random((B // WORLD, HR, WR)) < 0.8
        src["label_res"][B // WORLD:][hidden] = 255
        steps.append((src, trg))
    return {"variables": variables, "state_dict": flax_to_state_dict(variables), "boot": boot,
            "val": val, "steps": steps}


def _scenario(inputs, config, spec):
    return {"config": config, "spec": spec, "hw": (H, W), "batch": B, "lr": LR,
            "boot": inputs["boot"], "val": inputs["val"], "steps": inputs["steps"]}


def run_ranks(tmp, payload, argv=None, world=WORLD):
    """Run `world` gloo ranks of the worker (or of `argv`) under a deadline;
    their output goes to files. Returns the ranks' outputs."""
    rcs, outs, timed_out = finish_ranks(start_ranks(tmp, payload, argv, world), DEADLINE)
    if timed_out:
        pytest.fail(f"ranks still running after {DEADLINE} s (a collective deadlock?)")
    for r, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"rank {r} failed (rc {rc}):\n{out[-4000:]}"
    return outs


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    payload = {"state_dict": inputs["state_dict"],
               "scenarios": {name: _scenario(inputs, *sc) for name, sc in SCENARIOS.items()}}
    run_ranks(tmp, payload)
    out = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    files = {(name, r): sorted(os.listdir(tmp / f"snap_{name}_{r}"))
             if (tmp / f"snap_{name}_{r}").exists() else []
             for name in SCENARIOS for r in range(WORLD)}
    shutil.rmtree(tmp, ignore_errors=True)
    return out, files


def _card_bn_stats(x):
    """K2's arithmetic on the card: the variance taken in f64 from the f64
    moments, then rounded to f32."""
    mean, mean_sq = K.bn_moments_plain(x)
    return mean.float(), torch.clamp(mean_sq - mean * mean, min=0.0).float()


def one_process(inputs, config, spec, snap):
    """The port's step on one device on the global batches; the records the
    workers make, on rank 0's terms."""
    ad = make_adapter(inputs["state_dict"], config, spec, snap, (H, W), B)
    boot = inputs["boot"]
    ad.calculate_prototypes([{"image": nchw(boot["image"]), "label": torch.tensor(boot["label"])}])
    out = {"eval": {k: v.tolist() for k, v in ad.evaluate(val_loader(inputs["val"], B)).items()},
           "boot_proto": ad.state.proto.mean.clone(), "logs": [], "values": []}
    step = ad.step_fn(True, 1, False)
    for src, trg in inputs["steps"]:
        ad.state, logs = step(ad.state, nchw(trg["image"]), nchw(src["image"])[None],
                              torch.tensor(src["label_res"][None]).long(), LR)
        out["logs"].append(dict(logs.items()))
        out["values"].append(record(ad.state)[1])
    return out


@pytest.fixture(scope="module")
def single(inputs, tmp_path_factory):
    """The one-process reference of every scenario, its BatchNorm variance
    taken as K2 takes it on the card; torch.distributed's all-reduce raises
    meanwhile, and the collectives the helpers counted are kept."""
    def refuse(*args, **kwargs):
        raise AssertionError("a collective at world size 1")

    snap = str(tmp_path_factory.mktemp("single"))
    distributed.reset_counts()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(K, "bn_stats_plain", _card_bn_stats)
        mp.setattr(torch.distributed, "all_reduce", refuse)
        out = {name: one_process(inputs, *sc, snap) for name, sc in SCENARIOS.items()}
        # the EWC term counted on both ranks: one process with twice the weight
        out["ewc_twice"] = one_process(inputs, "hybrid_switch",
                                       {"MODEL_REGULARIZATION": 2 * EWC}, snap)
    out["collectives"] = distributed.counts()
    shutil.rmtree(snap, ignore_errors=True)
    return out


@pytest.fixture(scope="module")
def jax_dp(inputs, tmp_path_factory):
    """The JAX hybrid step on a 2-device `data` mesh (OTHERS.DATA_PARALLEL 2)."""
    snap = str(tmp_path_factory.mktemp("jax"))
    cfg = jax_cfg_from_file("configs/hybrid_switch.yml", default_config())
    spec = cfg.METHOD.ADAPTATION.PROTO_ONLINE_HYBRIDSWITCH
    cfg.SCHEME.RESOLUTION = [W, H]
    cfg.OTHERS.SNAPSHOT_DIR = snap
    cfg.OTHERS.DATA_PARALLEL = WORLD
    spec.LOAD_PROTO, spec.set_, spec.PSEUDO_THRESH = None, "test", 0.06
    model = jax_build(num_classes=C, layers=(1, 1, 1, 1), droprate=0.0)
    ad = JaxAdapter(model, inputs["variables"], cfg, spec, num_classes=C)
    assert ad.mesh is not None and ad.mesh.size == WORLD
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
                       for k in ("mean", "sq_mean", "count", "tau")})
        values.update({f"monitor.{k}": np.asarray(getattr(ad.state.monitor, k))
                       for k in ("ring", "count", "ptr", "exp", "started")})
        values.update({f"switch.{k}": np.asarray(getattr(ad.state.switch, k))
                       for k in ("current", "current_dev")})
        out["values"].append(values)
    shutil.rmtree(snap, ignore_errors=True)
    return out


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# parallel.mesh, parallel.distributed and K2's raw moments (no process group)
# ---------------------------------------------------------------------------

OPTIONS = (None, False, True, 1, 2, 3, 4, 8)
BATCHES = (None, 1, 2, 3, 4, 6, 8)


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_data_parallel_size_matches_the_jax_mesh(monkeypatch, world):
    """For every option × batch, the port's size equals the JAX mesh's with
    `world` processes of one device each (its multi-process guards
    included), and it raises where JAX raises; False above one rank raises
    in the port only (JAX would let every process train alone)."""
    devices = jax.devices()[:world]
    monkeypatch.setattr(jax, "devices", lambda: devices)
    monkeypatch.setattr(jax, "process_count", lambda: world)
    for option in OPTIONS:
        for batch in BATCHES:
            try:
                m = jax_mesh.data_parallel_mesh(option, batch_size=batch)
                want = 1 if m is None else m.size
            except ValueError:
                want = ValueError
            if option is False and world > 1:
                want = ValueError
            try:
                got = mesh.data_parallel_size(option, batch, world=world)
            except ValueError:
                got = ValueError
            assert got == want, (option, batch, world)


@pytest.mark.parametrize("device, ranks, cards, want", [
    ("cuda", 2, 2, "nccl"), ("cuda", 4, 8, "nccl"), ("cuda", 1, 1, "nccl"),
    ("cuda", 2, 1, "gloo"), ("cuda", 8, 4, "gloo"), ("cpu", 2, 0, "gloo"), ("cpu", 2, 8, "gloo")])
def test_backend_rule(device, ranks, cards, want):
    """NCCL where every rank has a card of its own; gloo on the CPU and where
    ranks share a card (NCCL refuses two ranks on one card)."""
    assert distributed.choose_backend(device, ranks, cards) == want


def test_shard_split_matches_the_jax_split(monkeypatch):
    for n, batch, count, seed, shuffle in [(10, 4, 2, 0, True), (17, 6, 3, 5, True),
                                           (9, 4, 4, 1, False), (8, 2, 1, 0, True)]:
        for p in range(count):
            got = list(distributed.host_local_batch_indices(n, batch, p, count, seed, shuffle))
            want = list(jax_distributed.host_local_batch_indices(n, batch, p, count, seed, shuffle))
            assert [a.tolist() for a in got] == [a.tolist() for a in want]
            # the CLI's metadata split: JAX's frame.iloc[p::n].iloc[:len // n]
            monkeypatch.setattr(distributed, "rank", lambda p=p: p)
            monkeypatch.setattr(distributed, "world", lambda count=count: count)
            assert list(distributed.shard_rows(n)) == list(range(n))[p::count][:n // count]
    with pytest.raises(ValueError, match="not divisible"):
        next(distributed.host_local_batch_indices(10, 5, 0, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_moments_plain_against_float64(dtype):
    """K2's raw-moments twin: (2, C) f64, each channel's mean and E[x²] to
    f64 rounding of the values, f32 or bf16 (an offset of 3 std included);
    the variance taken from them equals the f64 variance."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(3, 7, 9, 11)) * rng.uniform(0.5, 2.0, (1, 7, 1, 1))
                     + rng.normal(scale=3.0, size=(1, 7, 1, 1))).to(dtype)
    got = K.bn_moments_plain(x)
    x64 = x.double()
    want = torch.stack([x64.mean(dim=(0, 2, 3)), (x64 * x64).mean(dim=(0, 2, 3))])
    assert got.shape == (2, 7) and got.dtype == torch.float64
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)
    np.testing.assert_allclose(got[1] - got[0] ** 2, x64.var(dim=(0, 2, 3), unbiased=False),
                               rtol=1e-9)


def test_world_size_one_makes_no_collective_call(single):
    """One process: the bootstraps, evaluations and steps of the `single`
    runs (EWC included) never reached torch.distributed."""
    assert single["collectives"] == {"collectives": 0, "bytes": 0}
    assert all(math.isfinite(logs["Total target loss"]) for logs in single["ewc"]["logs"])


# ---------------------------------------------------------------------------
# two gloo ranks of the step
# ---------------------------------------------------------------------------


def test_ranks_end_every_step_with_the_same_bits(ranks):
    """Parameters, BN buffers, momentum, teachers, prototypes, monitor,
    switch and dropout generator: equal bit for bit on both ranks after every
    step, and the logs equal."""
    (r0, r1), _ = ranks
    assert r0["world"] == r1["world"] == WORLD and r0["backend"] == "gloo"
    for name in SCENARIOS:
        a, b = r0["scenarios"][name], r1["scenarios"][name]
        for i in range(STEPS):
            differ = [k for k in a["digests"][i] if a["digests"][i][k] != b["digests"][i][k]]
            assert not differ, (name, i, differ[:5])
            assert a["logs"][i] == b["logs"][i], (name, i)
        assert a["eval"] == b["eval"]


def test_gate_agrees_across_ranks(ranks, single):
    """The dynamic teacher's gate (one host read a step) took the same branch
    on both ranks and as on one process, in every policy."""
    (r0, r1), _ = ranks
    for name in SCENARIOS:
        fired = [[logs["dynamic forward fired"] for logs in r["scenarios"][name]["logs"]]
                 for r in (r0, r1)]
        assert fired[0] == fired[1] == [logs["dynamic forward fired"]
                                        for logs in single[name]["logs"]], name


def _update_gap(inputs, got, want, key):
    """max |got − want| of a parameter's update from the start, over the
    largest entry of want's update."""
    start = _np(inputs["state_dict"][key])
    update = _np(want) - start
    return np.abs(_np(got) - _np(want)).max() / np.abs(update).max()


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_two_ranks_match_one_process(ranks, single, inputs, name):
    """(b): the ranks' step is the one-process step on the global batch."""
    (r0, _), _ = ranks
    got, want = r0["scenarios"][name], single[name]
    np.testing.assert_allclose(_np(got["boot_proto"]), _np(want["boot_proto"]), rtol=0,
                               atol=ONE_PROTO)
    for i in range(STEPS):
        for key in LOSSES + ("pseudolabel_pixel_num", "output & prototype agreement",
                             "model regularization", "model confidence ma"):
            np.testing.assert_allclose(got["logs"][i][key], want["logs"][i][key], rtol=ONE_RTOL,
                                       atol=1e-7, err_msg=f"{name} step {i} {key}")
        for key, w in want["values"][i].items():
            g = got["values"][i][key]
            if key.startswith("params."):
                bound = ONE_HEAD if key.startswith("params.layer6") else ONE_BACKBONE[i]
                gap = _update_gap(inputs, g, w, key[len("params."):])
                assert gap <= bound, (name, i, key, gap)
            elif _np(w).dtype.kind in "biu":
                assert np.array_equal(_np(g), _np(w)), (name, i, key)
            else:
                atol = ONE_PROTO if key.startswith("proto.") else ONE_STATS
                np.testing.assert_allclose(_np(g), _np(w), rtol=ONE_RTOL, atol=atol,
                                           err_msg=f"{name} step {i} {key}")


def test_two_ranks_match_jax_data_parallel(ranks, jax_dp, inputs):
    """(a): the ranks against the JAX step on a 2-device `data` mesh, at
    tests/test_torch_step.py's tolerances. Step 0: losses rtol 1e-4,
    prototypes rtol 1e-4 / atol 1e-5, the head's update to 1e-4 and the
    backbone's to 5% of their largest entries (one-pass f32 BN variance in
    JAX, ROADMAP §3). Step 1, the drift of its later steps: losses rtol 2e-3,
    prototypes atol 4e-5, the head kernel atol 6e-4. Monitor and switch as
    the losses, pseudo-labels to 0.1% of the pixels."""
    (r0, _), _ = ranks
    got = r0["scenarios"]["hybrid"]
    np.testing.assert_allclose(_np(got["boot_proto"]), jax_dp["boot_proto"], rtol=1e-4, atol=1e-5)
    for i in range(STEPS):
        rtol = 1e-4 if i == 0 else 2e-3
        for key in LOSSES:
            np.testing.assert_allclose(got["logs"][i][key], jax_dp["logs"][i][key], rtol=rtol,
                                       atol=1e-5, err_msg=f"step {i} {key}")
        assert abs(got["logs"][i]["pseudolabel_pixel_num"]
                   - jax_dp["logs"][i]["pseudolabel_pixel_num"]) <= 0.001 * B * HR * WR
        assert got["logs"][i]["dynamic forward fired"] == jax_dp["logs"][i]["dynamic forward fired"]
        values, jvalues = got["values"][i], jax_dp["values"][i]
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
                                       _np(jvalues["params.layer6.head.1.weight"]), rtol=0,
                                       atol=6e-4, err_msg=f"step {i} head")
            continue
        for key in SELECTED:
            bound = 1e-4 if key.startswith("layer6") else 0.05
            gap = _update_gap(inputs, values[f"params.{key}"], jvalues[f"params.{key}"], key)
            assert gap <= bound, (key, gap)


def test_uneven_valid_counts_take_the_global_mean(ranks, inputs, single, tmp_path):
    """The ranks' source labels hold very different numbers of valid pixels:
    the buffer CE is the global sum over the global count (one process's
    value), which the mean of the per-rank means misses by far more than
    the tolerance."""
    (r0, r1), _ = ranks
    hybrid = [r["scenarios"]["hybrid"] for r in (r0, r1)]
    for i in range(STEPS):
        n0, n1 = hybrid[0]["valid_counts"][i], hybrid[1]["valid_counts"][i]
        assert n0 > 3 * n1 > 0
        want = single["hybrid"]["logs"][i]["buff_ce_loss"]
        np.testing.assert_allclose(hybrid[0]["logs"][i]["buff_ce_loss"], want, rtol=ONE_RTOL)
    # step 0's source logits on one process (the state before the step), and
    # the CE each rank's rows give alone
    ad = make_adapter(inputs["state_dict"], "hybrid_switch", {}, str(tmp_path), (H, W), B)
    src = inputs["steps"][0][0]
    with torch.no_grad():
        out = ad._forward(ad.state.params, ad.state.batch_stats, nchw(src["image"]),
                          train=True)["out"].float()
    from onda_torch.ops import losses as L

    labels = torch.tensor(src["label_res"]).long()
    b = B // WORLD
    per_rank = [float(L.cross_entropy_2d(out[r * b:(r + 1) * b], labels[r * b:(r + 1) * b]))
                for r in range(WORLD)]
    assert float(L.cross_entropy_2d(out, labels)) == pytest.approx(
        single["hybrid"]["logs"][0]["buff_ce_loss"], rel=ONE_RTOL)
    mean_of_means = sum(per_rank) / WORLD
    assert abs(mean_of_means - hybrid[0]["logs"][0]["buff_ce_loss"]) > 100 * ONE_RTOL * abs(
        mean_of_means)


def test_ewc_term_counts_once(ranks, single, inputs):
    """MODEL_REGULARIZATION > 0: the ranks' update equals one process's, and
    is far from one process's with twice the weight (the term counted on
    both ranks)."""
    (r0, _), _ = ranks
    got, once, twice = r0["scenarios"]["ewc"], single["ewc"], single["ewc_twice"]
    last = STEPS - 1
    for key in ("params.conv1.weight", "params.layer6.head.1.weight"):
        g, w1, w2 = (v["values"][last][key] for v in (got, once, twice))
        bound = ONE_HEAD if key.startswith("params.layer6") else ONE_BACKBONE[last]
        assert _update_gap(inputs, g, w1, key[len("params."):]) <= bound
        assert _update_gap(inputs, w2, w1, key[len("params."):]) > 10 * bound, key
    assert got["logs"][last]["model regularization"] > 0
    np.testing.assert_allclose(got["logs"][last]["model regularization"],
                               once["logs"][last]["model regularization"], rtol=ONE_RTOL)


def test_evaluation_is_the_global_one(ranks, single):
    """Both ranks evaluate their shard (3 of the 6 frames each, the last
    batch padded); the summed confusion matrices give one process's IoUs."""
    (r0, _), _ = ranks
    for name in SCENARIOS:
        assert r0["scenarios"][name]["eval"] == single[name]["eval"], name


def test_collectives_per_step(ranks):
    """Per rank and step: one all-reduce per train-mode BatchNorm forward
    (EMA teacher, source and target slices: 3 × 17 in this R50), one per BN
    backward of the two gradient passes (2 × 17), three in the teachers, one
    for the loss counts, one gradient bucket and one for the logs."""
    (r0, _), _ = ranks
    n_bn = 17
    with torch.device("meta"):
        params = dict(build_deeplab_v2(C, (1, 1, 1, 1), "ProDA").named_parameters())
    bucket = 4 * sum(params[k].numel() for k, lab in optim.label_params(
        params, aux_grad=False).items() if lab != optim.FROZEN)
    for name in SCENARIOS:
        for counts in r0["scenarios"][name]["collectives"]:
            assert counts["collectives"] == 5 * n_bn + 6, (name, counts)
            # the gradient bucket (one f32 copy of the trainable parameters)
            # and the small reductions beside it
            assert bucket < counts["bytes"] < bucket + 1e6, (name, counts)


def test_only_rank_0_writes_the_prototype_pickle(ranks):
    _, files = ranks
    for name in SCENARIOS:
        assert files[(name, 0)] == ["proto_current.pickle"], name
        assert files[(name, 1)] == [], name


# ---------------------------------------------------------------------------
# the CLI under torchrun
# ---------------------------------------------------------------------------

CLI_PER_DOMAIN, CLI_BATCH = 2, 2


def _cli_cfg(path, root, snap, **over):
    """hybrid_switch.yml cut to the synthetic dataset: two domains, one
    epoch, global batch 2, a dynamic replay buffer that the steps insert into."""
    with open(os.path.join(ROOT, "configs", "hybrid_switch.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg["SCHEME"].update(PATH=root + "/", RESOLUTION=[64, 32], DOMAIN_ORDER=[[25], [50]])
    cfg["TRAINING"].update(BATCH_SIZE=CLI_BATCH, REPLAY_BUFFER=4, BUFFER_DYNAMIC=True,
                           PERC_FILL_PER_DOMAIN=1.0)
    cfg["OTHERS"].update(SNAPSHOT_DIR=snap, NUM_WORKERS=2, SCHEDULE=True)
    cfg["MODEL"]["LOAD"] = None
    cfg["METHOD"]["ADAPTATION"]["PROTO_ONLINE_HYBRIDSWITCH"].update(
        EPOCHS=1, LOAD_PROTO=None, PSEUDO_THRESH=0.06)
    for key, value in over.items():
        section, name = key.split(".")
        cfg[section][name] = value
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _records(snap):
    with open(os.path.join(snap, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The cut config through `onda_torch.train_ouda.main` under `python -m
    torch.distributed.run --nproc-per-node 2` (tests/torch_parallel_worker.py
    cli), and through the one-process CLI; the R50 of both cut to one
    bottleneck a stage."""
    tmp = tmp_path_factory.mktemp("cli")
    root = str(tmp / "ds")
    make_synthetic_dataset(root, intensities=(0, 25, 50), per_domain=CLI_PER_DOMAIN,
                           size_wh=(64, 32))
    snaps = {"ranks": str(tmp / "snap_ranks"), "one": str(tmp / "snap_one")}
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "2"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(WORLD), WORKER, "cli",
           "--cfg", _cli_cfg(tmp / "ranks.yml", root, snaps["ranks"]), "--device", "cpu"]
    with open(tmp / "torchrun.log", "w+") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, cwd=ROOT, env=env,
                                start_new_session=True)
        try:  # the one-process run meanwhile
            with contextlib.redirect_stdout(io.StringIO()), pytest.MonkeyPatch.context() as mp:
                mp.setitem(registry.LAYERS, "DeepLabv2-Resnet50", (1, 1, 1, 1))
                train_ouda.main(["--cfg", _cli_cfg(tmp / "one.yml", root, snaps["one"]),
                                 "--device", "cpu"])
            proc.wait(timeout=DEADLINE)
        except subprocess.TimeoutExpired:
            pytest.fail(f"torchrun still running after {DEADLINE} s (a collective deadlock?)")
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
        log.seek(0)
        text = log.read()
    assert proc.returncode == 0, text[-4000:]
    runs = {k: {"records": _records(v), "files": sorted(os.listdir(v))} for k, v in snaps.items()}
    runs["ranks"]["log"] = text
    for name in ("ranks", "one"):
        runs[name]["samples"] = sorted(os.listdir(os.path.join(snaps[name], "samples")))
    yield runs
    shutil.rmtree(tmp, ignore_errors=True)  # the runs' checkpoints


def _step_records(records):
    return [r for r in records if "Total target loss" in r]


def test_two_rank_cli_runs_with_one_writer(cli_runs):
    """Every step of both domains ran (one a domain: 2 frames at global batch 2),
    its losses finite; one metrics record a step, as one process writes them;
    the checkpoints, pickles and the source `.pth` written once, with no
    temporary left; the ranks' buffers took insertions."""
    ranks, one = cli_runs["ranks"], cli_runs["one"]
    steps = _step_records(ranks["records"])
    assert len(steps) == len(_step_records(one["records"])) == 2 * CLI_PER_DOMAIN // CLI_BATCH
    assert len(ranks["records"]) == len(one["records"])
    for r in steps:
        for key in LOSSES:
            assert math.isfinite(r[key]), key
    assert ranks["files"] == one["files"]
    assert {"adapt_state.pt", "metrics.jsonl", "proto_current.pickle", "proto_(25,).pickle",
            "proto_(50,).pickle", "model_train_[[0]]_after_src_training.pth"} <= set(ranks["files"])
    assert not [f for f in ranks["files"] if f.startswith(".")]
    # rank 0 renders the global batches' rows, as many as one process
    assert len(ranks["samples"]) == len(one["samples"])
    assert sum(r["Total buffer updates"] for r in steps) == len(steps) * CLI_BATCH // WORLD


def test_two_rank_cli_keys_and_evaluation_match_one_process(cli_runs):
    """The metrics' key set is the one-process CLI's, and the evaluation
    before adaptation (both ranks' validation shards, summed) gives one
    process's mIoU of every set, exactly."""
    ranks, one = cli_runs["ranks"], cli_runs["one"]
    assert set().union(*ranks["records"]) == set().union(*one["records"])
    first = [next(r for r in run["records"] if any(k.startswith("Val mIoU") for k in r))
             for run in (ranks, one)]
    miou = [{k: v for k, v in r.items() if k.startswith(("Val mIoU", "Val std IoU"))}
            for r in first]
    assert miou[0] == miou[1] and len(miou[0]) == 6


def test_advent_resolves_a_grid_under_two_ranks(monkeypatch):
    """No path refuses an option under two ranks any more: advent.yml with
    OTHERS.TENSOR_PARALLEL 2 resolves to a (1 × 2) grid, data axis 1, before
    anything is read or written (the world set here without a process
    group); tests/test_torch_tensor_parallel_adversarial.py runs it."""
    monkeypatch.setattr(distributed, "world", lambda: 2)
    cfg = cfg_from_file(os.path.join(ROOT, "configs", "advent.yml"))
    cfg.TRAINING.BATCH_SIZE = 2
    cfg.OTHERS.TENSOR_PARALLEL = 2
    assert mesh.data_axis(cfg) == 1
    assert mesh.grid_shape(cfg.OTHERS.TENSOR_PARALLEL, 2) == (1, 2)
