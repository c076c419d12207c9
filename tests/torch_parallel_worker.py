"""One rank of the port's data-parallel paths, for tests/test_torch_parallel*.py.

    WORLD_SIZE=2 RANK=r LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_parallel_worker.py <payload.pt> <out_dir>
    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        tests/torch_parallel_worker.py cli --cfg <yaml> --device cpu

The second form is `onda_torch.train_ouda.main` with the R50 cut to one
bottleneck a stage (`registry.LAYERS`), as the port's CLI tests cut it.

The payload (written by the test) holds the model's state_dict and, per
scenario, a config, spec overrides and the global batches (NHWC numpy, as the
JAX step takes them). The rank joins the gloo group through
`onda_torch.parallel.distributed.initialize` (torchrun's environment), takes
its rows of each global batch (rank-major: rows [r·b, (r+1)·b)) and runs the
scenario's kind: `proto` (the default) bootstraps the prototypes, evaluates
and takes PROTO_ONLINE steps; `tensor_parallel` does so on a (data × model)
grid (OTHERS.TENSOR_PARALLEL), then saves and loads whole-state files;
`adversarial` takes ADVENT or PROTO_ADVENT steps; `spatial_forward` runs
the model on a (data × spatial) grid (`mesh.spatial_grid`), each rank on its
block of its data index's image rows, and `spatial_step` bootstraps the
prototypes and takes hybrid steps there; `segment` runs
`SegmentTrainer.train` (both on a grid where the scenario names a "tp");
`evaluation` makes the
EVALUATION runner on a directory of checkpoints, evaluates, sweeps and dumps
predictions, with a read failure injected on rank 1 where the scenario asks.
It writes `rank<r>.pt`: per scenario the logs, a digest of every tensor of
the state after each step (for bit-identity across ranks), the values the
test compares (rank 0 only: with JAX and with one process) and the
collectives. The `run_*` functions run at world size 1 too: the tests' one-
process references are the same code. Imports no JAX.
"""

import contextlib
import hashlib
import io
import os
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from onda_torch import registry  # noqa: E402
from onda_torch.config import cfg_from_file  # noqa: E402
from onda_torch.methods.proto_online import ProtoOnlineAdapter  # noqa: E402
from onda_torch.methods.segmentation import SegmentTrainer  # noqa: E402
from onda_torch.models import build_deeplab_v2  # noqa: E402
from onda_torch.ops import kernels as K  # noqa: E402
from onda_torch.ops import losses as L  # noqa: E402
from onda_torch.parallel import distributed  # noqa: E402

# the tensors whose values the test compares (the rest by digest only)
SELECTED = ("conv1.weight", "layer1.0.conv1.weight", "layer3.0.conv2.weight",
            "layer4.0.conv3.weight", "layer6.bottleneck.1.weight", "layer6.head.1.weight")
SELECTED_STATS = ("bn1.running_mean", "bn1.running_var", "layer4.0.bn3.running_var")


def nchw(a):
    return torch.tensor(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def configure(config, spec_over, snap, hw):
    """configs/<config>.yml at hw (H, W), as tests/test_torch_step.py cuts it."""
    cfg = cfg_from_file(os.path.join(ROOT, "configs", f"{config}.yml"))
    spec = cfg.METHOD.ADAPTATION[cfg.METHOD.ADAPTATION.NAME]
    cfg.SCHEME.RESOLUTION = [hw[1], hw[0]]
    cfg.OTHERS.SNAPSHOT_DIR = snap
    spec.LOAD_PROTO = None
    spec.set_ = "test"
    spec.PSEUDO_THRESH = 0.06  # random weights: keep some pixels above the threshold
    for key, value in spec_over.items():
        spec[key] = value
    return cfg, spec


def val_loader(val, b):
    """Batches of b rows of `val`, the last one padded by repeating its last
    row and carrying `valid`, as the evaluation loaders make them."""
    batches = []
    for i in range(0, len(val["image"]), b):
        image, label = nchw(val["image"][i:i + b]), torch.tensor(val["label"][i:i + b])
        valid, pad = len(label), b - len(label)
        batches.append({"image": torch.cat([image, image[-1:].repeat(pad, 1, 1, 1)]),
                        "label": torch.cat([label, label[-1:].repeat(pad, 1, 1)]),
                        "valid": valid})
    return batches


def make_adapter(state_dict, config, spec_over, snap, hw, batch, others=None):
    cfg, spec = configure(config, spec_over, snap, hw)
    cfg.TRAINING.BATCH_SIZE = batch
    for key, value in (others or {}).items():
        cfg.OTHERS[key] = value
    model = build_deeplab_v2(19, (1, 1, 1, 1), "ProDA", droprate=0.0)
    model.load_state_dict(state_dict, strict=True)
    return ProtoOnlineAdapter(model, registry.variables_of(model), cfg, spec, 19, device="cpu")


def state_tensors(state, cut=None):
    """Every tensor of an AdaptState by a flat name; with `cut` (an adapter's
    `_whole`), the trees of the model's tensors through it."""
    out = {}
    for tree in ("params", "batch_stats", "alt_batch_stats", "opt_momentum", "ema_params",
                 "dynamic_params", "dynamic_batch_stats"):
        t = getattr(state, tree)
        out.update({f"{tree}.{k}": v for k, v in (cut(t) if cut else t).items()})
    for name in ("proto", "monitor", "switch"):
        out.update({f"{name}.{k}": v for k, v in vars(getattr(state, name)).items()})
    out["generator"] = state.generator.get_state()
    return out


def digest(t):
    """sha256 of the tensor's bytes."""
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def record(state):
    """(digests of every tensor, values of the selected ones)."""
    tensors = state_tensors(state)
    values = {k: v.detach().clone() for k, v in tensors.items()
              if k.split(".", 1)[0] in ("proto", "monitor", "switch")}
    values.update({f"params.{k}": state.params[k].detach().clone() for k in SELECTED})
    values.update({f"batch_stats.{k}": state.batch_stats[k].detach().clone()
                   for k in SELECTED_STATS})
    return {k: digest(v) for k, v in tensors.items()}, values


def run_scenario(sc, state_dict, rank, world, snap):
    b = sc["batch"] // world
    rows = slice(rank * b, (rank + 1) * b)
    ad = make_adapter(state_dict, sc["config"], sc["spec"], snap, sc["hw"], sc["batch"])
    boot = sc["boot"]
    ad.calculate_prototypes([{"image": nchw(boot["image"][rows]),
                              "label": torch.tensor(boot["label"][rows])}])
    n_val = len(sc["val"]["image"]) // world
    val = {k: v[rank * n_val:(rank + 1) * n_val] for k, v in sc["val"].items()}
    out = {"eval": {k: v.tolist() for k, v in ad.evaluate(val_loader(val, b)).items()},
           "boot_proto": ad.state.proto.mean.clone(), "logs": [], "digests": [], "values": [],
           "valid_counts": [], "collectives": []}
    step = ad.step_fn(True, 1, False)
    for src, trg in sc["steps"]:
        labels = torch.tensor(src["label_res"][rows][None]).long()
        distributed.reset_counts()
        ad.state, logs = step(ad.state, nchw(trg["image"][rows]), nchw(src["image"][rows])[None],
                              labels, sc["lr"])
        out["collectives"].append(distributed.counts())
        out["logs"].append(dict(logs.items()))
        out["valid_counts"].append(float(L.valid_count(labels[0])))
        digests, values = record(ad.state)
        out["digests"].append(digests)
        out["values"].append(values if rank == 0 else {})
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(tmp, payload, argv=None, world=2):
    """Start `world` gloo ranks of this worker on `payload` (or of `argv`),
    their output into tmp/rank<r>.log, joined through torchrun's environment
    variables. Returns what `finish_ranks` takes."""
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE=str(world),
               LOCAL_WORLD_SIZE=str(world), OMP_NUM_THREADS="2")
    if payload is not None:
        torch.save(payload, os.path.join(tmp, "payload.pt"))
    cmd = argv or [sys.executable, os.path.abspath(__file__), os.path.join(tmp, "payload.pt"),
                   str(tmp)]
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(world)]
    procs = [subprocess.Popen(cmd, stdout=logs[r], stderr=subprocess.STDOUT, cwd=ROOT, text=True,
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)})
             for r in range(world)]
    return procs, logs


def finish_ranks(started, deadline_s: float):
    """Wait for the ranks until `deadline_s` seconds from now; kill every
    one still running then. Returns (return codes, outputs, timed out)."""
    procs, logs = started
    deadline = time.monotonic() + deadline_s
    timed_out = False
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        timed_out = True
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
    return [p.returncode for p in procs], outs, timed_out


class Recorder:
    """A logger that keeps every record (on every rank)."""

    def __init__(self):
        self.records = []

    def log(self, metrics):
        self.records.append({k: v if isinstance(v, str) else float(v)
                             for k, v in metrics.items()})


def local_rows(x, rank, world):
    """This rank's rows of a global batch (rank-major blocks)."""
    b = len(x) // world
    return x[rank * b:(rank + 1) * b]


def model_of(state_dict, multi_level):
    model = build_deeplab_v2(19, (1, 1, 1, 1), "ProDA", multi_level=multi_level, droprate=0.0)
    model.load_state_dict(state_dict, strict=True)
    return model


# ---- OTHERS.TENSOR_PARALLEL ------------------------------------------------

def whole_state(ad):
    """Every tensor of the adapter's state by a flat name, whole: the sharded
    trees gathered over the model group (a collective every rank joins)."""
    s = ad.state
    out = {}
    for tree in ("params", "batch_stats", "alt_batch_stats", "opt_momentum", "ema_params",
                 "static_params", "static_batch_stats", "dynamic_params", "dynamic_batch_stats"):
        out.update({f"{tree}.{k}": v for k, v in ad._whole(getattr(s, tree)).items()})
    for name in ("proto", "monitor", "switch"):
        out.update({f"{name}.{k}": v for k, v in vars(getattr(s, name)).items()})
    return out


def run_tensor_parallel(sc, state_dict, rank, world, snap):
    """The scenario's bootstrap, evaluation and hybrid steps on a grid of
    OTHERS.TENSOR_PARALLEL = sc["tp"] (each data index taking its rows of
    every global batch); per step the logs, the collectives by group, the
    digests of this rank's tensors, those of the whole-leaf gradients
    before their reduction, and (rank 0) the whole parameters, BN buffers,
    prototypes, monitor and switch. Then, unless sc["save"] is False,
    `save_model`, and a load of sc["load"] (a whole-state file written by one
    process), whose gathered state rank 0 returns. sc["evaluate"] False skips
    the evaluation."""
    if sc.get("card_bn"):  # the BatchNorm variance as K2 takes it on the card
        K.bn_stats_plain = card_bn_stats
    ad = make_adapter(state_dict, sc["config"], sc["spec"], snap, sc["hw"], sc["batch"],
                      others={"TENSOR_PARALLEL": sc["tp"]})
    d, dw = distributed.data_rank(), distributed.data_world()
    b = sc["batch"] // dw
    rows = slice(d * b, (d + 1) * b)
    boot = sc["boot"]
    ad.calculate_prototypes([{"image": nchw(boot["image"][rows]),
                              "label": torch.tensor(boot["label"][rows])}])
    n_val = len(sc["val"]["image"]) // dw
    val = {k: v[d * n_val:(d + 1) * n_val] for k, v in sc["val"].items()}
    out = {"grid": (dw, distributed.model_world()), "position": (d, distributed.model_rank()),
           "plan": sorted(ad.plan), "eval": {k: v.tolist() for k, v in ad.evaluate(
               val_loader(val, b)).items()} if sc.get("evaluate", True) else {},
           "boot_proto": ad.state.proto.mean.clone(), "logs": [], "digests": [], "values": [],
           "collectives": [], "whole_grads": []}
    all_sum = distributed.all_sum

    def recording_all_sum(*tensors, group="data"):
        if group == "world":  # the whole leaves' gradient bucket, before its reduction
            out["whole_grads"][-1].append(digest(torch.cat([t.reshape(-1) for t in tensors])))
        return all_sum(*tensors, group=group)

    step = ad.step_fn(True, 1, False)
    distributed.all_sum = recording_all_sum
    try:
        for src, trg in sc["steps"]:
            labels = torch.tensor(src["label_res"][rows][None]).long()
            out["whole_grads"].append([])
            distributed.reset_counts()
            ad.state, logs = step(ad.state, nchw(trg["image"][rows]),
                                  nchw(src["image"][rows])[None], labels, sc["lr"])
            out["collectives"].append({"all": distributed.counts(), **{
                g: dict(c) for g, c in distributed.COUNTS.items()}})
            out["logs"].append(dict(logs.items()))
            out["digests"].append(digests_of(state_tensors(ad.state)))
            whole = whole_state(ad)
            out["values"].append({k: v.clone() for k, v in whole.items()
                                  if k.split(".", 1)[0] in ("params", "batch_stats", "proto",
                                                            "monitor", "switch")}
                                 if rank == 0 else {})
    finally:
        distributed.all_sum = all_sum
    if sc.get("save", True):
        ad.save_model()
    if sc.get("load"):
        ad.load_model(sc["load"])
        loaded = whole_state(ad)
        out["loaded"] = {k: digest(v) for k, v in loaded.items()} if rank == 0 else {}
    out["files"] = sorted(os.listdir(snap)) if os.path.isdir(snap) else []
    return out


def digests_of(tensors):
    return {k: digest(v) for k, v in tensors.items()}


def card_bn_stats(x):
    """K2's arithmetic on the card: the variance taken in f64 from the f64
    moments, then rounded to f32 (what the ranks of a data axis above 1 take
    from their all-reduced moments)."""
    mean, mean_sq = K.bn_moments_plain(x)
    return mean.float(), torch.clamp(mean_sq - mean * mean, min=0.0).float()


def chain_modules():
    """A small chain of the model's layers, each wide enough to shard on 2
    ranks under a plan with min_dim 8: conv → BN → conv → GroupNorm (4
    groups: each shard holds whole groups) → conv → GroupNorm (1 group: it
    gathers first) → Linear over the pooled channels → BN of a whole input
    (`split_channels`)."""
    from onda_torch.models.layers import Conv2d, GroupNorm, Linear, TorchBatchNorm

    torch.manual_seed(5)
    return torch.nn.ModuleDict({
        "conv_a": Conv2d(4, 8, 3, padding=1, bias=True), "bn": TorchBatchNorm(8),
        "conv_b": Conv2d(8, 8, 1), "gn_local": GroupNorm(8, num_groups=4),
        "conv_c": Conv2d(8, 8, 3, padding=1, bias=True), "gn_gathered": GroupNorm(8, num_groups=1),
        "fc": Linear(8, 8), "bn_whole_in": TorchBatchNorm(8)})


def chain_forward(m, x):
    """The chain on x, every sharded layer entered through `fan_in`."""
    from torch.nn import functional as F

    from onda_torch.parallel import tensor as T

    y = F.relu(m["bn"](m["conv_a"](T.fan_in(x, m["conv_a"])[0]), train=True))
    y = F.relu(m["gn_local"](m["conv_b"](T.fan_in(y, m["conv_b"])[0])))
    y = m["gn_gathered"](m["conv_c"](T.fan_in(y, m["conv_c"])[0]))
    s = m["fc"](T.fan_in(y.mean(dim=(2, 3)), m["fc"])[0])
    s = T.gather_channels(s) if T.shards(m["fc"]) > 1 else s
    return m["bn_whole_in"](y * torch.sigmoid(s)[:, :, None, None], train=True)


def run_chain(sc, state_dict, rank, world, snap):
    """`chain_forward` with this model rank's shards of the chain's
    parameters and buffers (every one planned at min_dim 8) on the whole
    input; returns the output and the whole gradients of the input and of
    every parameter (the shards' gathered over the model group)."""
    from onda_torch.parallel import tensor as T

    distributed.form_grid(world)
    m = chain_modules()
    tensors = {**dict(m.named_parameters()), **dict(m.named_buffers())}
    plan = T.tensor_parallel_plan(tensors, world, min_dim=8)
    for name, t in T.shard_state({k: v.detach() for k, v in tensors.items()}, plan,
                                 distributed.model_rank(), world).items():
        owner, leaf = name.split(".")
        kind = "_parameters" if leaf in ("weight", "bias") else "_buffers"
        getattr(m[owner], kind)[leaf] = torch.nn.Parameter(t) if kind == "_parameters" else t
    params = dict(m.named_parameters())
    x = torch.tensor(sc["x"]).requires_grad_(True)
    y = chain_forward(m, x)
    grads = torch.autograd.grad((y * torch.tensor(sc["weight"])).sum(), [x, *params.values()])
    return {"y": y.detach(), "dx": grads[0], "plan": sorted(plan),
            "grads": T.gather_state(dict(zip(params, grads[1:])), plan)}


# ---- ADVENT and PROTO_ADVENT ---------------------------------------------

def adversarial_tensors(ad, whole=False):
    """Every tensor of an ADVENT or PROTO_ADVENT adapter's state by a flat
    name, the discriminators and their Adam states (`count` included): this
    rank's, or with `whole` the whole ones (on a grid, the shards gathered:
    a collective every rank joins)."""
    if hasattr(ad, "d_state"):  # PROTO_ADVENT: an AdaptState beside the discriminators
        out = state_tensors(ad.state, ad._whole if whole else None)
        discs = {"d_aux": ad.d_state["aux"], "d_main": ad.d_state["main"],
                 "d_aux_opt": ad.d_state["aux_opt"], "d_main_opt": ad.d_state["main_opt"]}
    else:
        fields = ("params", "batch_stats", "opt_momentum", "d_aux", "d_main", "d_aux_opt",
                  "d_main_opt")
        trees = {name: getattr(ad.state, name) for name in fields}
        if whole:
            trees = ad._trees(trees, ad._whole)
        out = {f"{tree}.{k}": v for tree in fields[:3] for k, v in trees[tree].items()}
        out["generator"] = ad.state.generator.get_state()
        discs = {name: trees[name] for name in fields[3:]}
    for name, tree in discs.items():
        if name.endswith("_opt"):
            out.update({f"{name}.{m}.{k}": v for m in ("mu", "nu") for k, v in tree[m].items()})
            out[f"{name}.count"] = torch.tensor(tree["count"])
        else:
            out.update({f"{name}.{k}": v for k, v in tree.items()})
    return out


THIN_ABOVE, THIN_TO = 2**20, 2**18


def thin(x):
    """A tensor or array of more than THIN_ABOVE elements as about THIN_TO of
    them at an even stride through its flat order (the compared values of
    the largest weights; the digests cover every element); others whole."""
    n = int(np.prod(x.shape))
    return x.reshape(-1)[::-(-n // THIN_TO)] if n > THIN_ABOVE else x


def adversarial_values(ad, full: bool):
    """The compared tensors, whole and thinned (`thin`): with `full` every
    tensor (rank 0's after the first step), else the selected parameters,
    statistics and the discriminators' first and last layers with their
    Adam moments."""
    tensors = adversarial_tensors(ad, whole=True)
    if full:
        keep = [k for k in tensors if k != "generator"]
    else:
        keep = [f"params.{k}" for k in SELECTED + ("layer5.conv2d_list.0.weight",)
                if f"params.{k}" in tensors]
        keep += [f"batch_stats.{k}" for k in SELECTED_STATS]
        keep += [k for k in tensors if k.startswith(("d_main", "d_aux", "proto."))
                 and ("conv0." in k or "conv4." in k or k.startswith("proto."))]
        keep += [k for k in tensors if k.endswith(".count")]
    return {k: thin(tensors[k].detach()).clone() for k in keep}


def make_adversarial(sc, state_dict, snap):
    """The scenario's ADVENT or PROTO_ADVENT adapter at its global batch (on
    a grid of OTHERS.TENSOR_PARALLEL = sc["tp"], if set), its discriminators
    the payload's."""
    cfg, spec = configure(sc["config"], sc["spec"], snap, sc["hw"])
    cfg.TRAINING.BATCH_SIZE = sc["batch"]
    cfg.MODEL.MULTI_LEVEL = sc["multi_level"]
    if sc.get("tp"):
        cfg.OTHERS.TENSOR_PARALLEL = sc["tp"]
    model = model_of(state_dict, sc["multi_level"])
    ad = registry.get_adapt_method(cfg)(model, registry.variables_of(model), cfg, spec, 19,
                                        device="cpu")
    discs = {name: {k: v.clone() for k, v in sd.items()} for name, sd in sc["discs"].items()}
    if hasattr(ad, "d_state"):
        ad.d_state["aux"], ad.d_state["main"] = discs["d_aux"], discs["d_main"]
    else:
        ad.state.d_aux, ad.state.d_main = (ad._shard(discs[n], ad.disc_plan)
                                           for n in ("d_aux", "d_main"))
    return ad


def run_adversarial(sc, state_dict, rank, world, snap):
    """The scenario's steps on its data index's rows (PROTO_ADVENT after a
    bootstrap on its rows of the payload's source batch). On a grid, also
    the collectives by group, the bytes of the discriminators this rank
    holds, `save_model` and a load of sc["load"] (a file one process wrote),
    whose whole tensors' digests rank 0 returns, with those of the state it
    saved ("final")."""
    ad = make_adversarial(sc, state_dict, snap)
    d, dw = distributed.data_rank(), distributed.data_world()
    out = {"logs": [], "digests": [], "values": [], "collectives": [], "by_group": [],
           "grid": (dw, distributed.model_world()), "plan": sorted(ad.plan),
           "disc_plan": sorted(getattr(ad, "disc_plan", ())),
           "disc_bytes": sum(v.numel() * v.element_size() for k, v in adversarial_tensors(
               ad).items() if k.startswith(("d_main.", "d_main_opt.mu.", "d_main_opt.nu.")))}
    if hasattr(ad, "d_state"):
        boot = sc["boot"]
        ad.calculate_prototypes([{"image": local_rows(nchw(boot["image"]), d, dw),
                                  "label": local_rows(torch.tensor(boot["label"]), d, dw)}])
        step = ad.pa_step_fn()
    else:
        step = ad.build_step()
    for i, (src, trg) in enumerate(sc["steps"]):
        s_img = local_rows(nchw(src["image"]), d, dw)
        s_lbl = local_rows(torch.tensor(src["label"]).long(), d, dw)
        t_img = local_rows(nchw(trg["image"]), d, dw)
        distributed.reset_counts()
        if hasattr(ad, "d_state"):
            ad.state, ad.d_state, logs = step(ad.state, ad.d_state, s_img, s_lbl, t_img,
                                              sc["lr"], sc["lr_d"])
        else:
            ad.state, logs = step(ad.state, s_img, s_lbl, t_img, sc["lr"], sc["lr_d"])
        out["collectives"].append(distributed.counts())
        out["by_group"].append({g: dict(c) for g, c in distributed.COUNTS.items()})
        out["logs"].append({k: float(v) for k, v in logs.items()})
        out["digests"].append({k: digest(v) for k, v in adversarial_tensors(ad).items()})
        values = adversarial_values(ad, full=i == 0)
        out["values"].append(values if rank == 0 else {})
    if sc.get("tp"):
        final = adversarial_tensors(ad, whole=True)
        out["final"] = {k: digest(v) for k, v in final.items()} if rank == 0 else {}
        ad.save_model()
        if sc.get("load"):
            ad.load_model(sc["load"])
            loaded = adversarial_tensors(ad, whole=True)
            out["loaded"] = {k: digest(v) for k, v in loaded.items()} if rank == 0 else {}
        out["files"] = sorted(os.listdir(snap)) if os.path.isdir(snap) else []
    return out


# ---- SEGMENT --------------------------------------------------------------

def make_trainer(sc, state_dict, snap):
    cfg = cfg_from_file(os.path.join(ROOT, "configs", "training_fog.yml"))
    if sc.get("tp"):
        cfg.OTHERS.TENSOR_PARALLEL = sc["tp"]
    h, w = sc["hw"]
    cfg.SCHEME.RESOLUTION = [w, h]
    cfg.SCHEME.ORIGINAL_RES = [sc["raw_hw"][1], sc["raw_hw"][0]]
    cfg.OTHERS.SNAPSHOT_DIR = snap
    cfg.TRAINING.BATCH_SIZE = sc["batch"]
    spec = cfg.METHOD.PRETRAIN.SEGMENT
    spec.LEARNING_RATE, spec.EPOCHS = sc["lr"], 1
    model = model_of(state_dict, True)
    return SegmentTrainer(model, registry.variables_of(model), cfg, spec, 19, logger=Recorder(),
                          device="cpu")


def run_segment(sc, state_dict, rank, world, snap):
    """`SegmentTrainer.train` over one epoch of its data index's rows of the
    payload's batches, with its evaluation of those validation rows; each
    step's LR, loss (this rank's share), collectives and state (the values
    whole)."""
    tr = make_trainer(sc, state_dict, snap)
    d, dw = distributed.data_rank(), distributed.data_world()
    out = {"lr": [], "loss": [], "digests": [], "values": [], "collectives": [], "by_group": [],
           "plan": sorted(tr.plan)}
    step = tr.step

    def recorded(images, labels, lr):
        distributed.reset_counts()
        loss = step(images, labels, lr)
        out["collectives"].append(distributed.counts())
        out["by_group"].append({g: dict(c) for g, c in distributed.COUNTS.items()})
        out["lr"].append(lr)
        out["loss"].append(float(loss))
        trees = {"params": tr.params, "batch_stats": tr.batch_stats, "momentum": tr.momentum_buf}
        out["digests"].append({f"{t}.{k}": digest(v) for t, tree in trees.items()
                               for k, v in tree.items()})
        whole = {f"{t}.{k}": v for t in ("params", "batch_stats")
                 for k, v in tr._whole(trees[t]).items()}
        out["values"].append({k: thin(v.detach()).clone() for k, v in whole.items()}
                             if rank == 0 else {})
        return loss

    tr.step = recorded

    def rows(batches):
        return [{k: local_rows(nchw(v) if k == "image" else torch.tensor(v), d, dw)
                 for k, v in b.items()} for b in batches]

    tr.train({"src": rows(sc["steps"])}, {"v": rows(sc["val"])})
    final = tr.state_dict()
    out["final"] = {k: digest(v) for k, v in final.items()} if rank == 0 else {}
    out["records"] = tr.logger.records
    out["files"] = sorted(os.listdir(snap)) if os.path.isdir(snap) else []
    return out


# ---- EVALUATION -----------------------------------------------------------

def run_evaluation(sc, state_dict, rank, world, snap):
    """The EVALUATION runner of validation_offline_fog.yml on the payload's
    directory of checkpoints (rank r failing to read the files that
    `fail_on_ranks[r]` names): the file it loaded and `evaluate_all`; then a new
    runner's EVAL_SWEEP; then `run_predictions` of the target frames, this
    rank's every world-th row (the CLI's shard), into the scenario's
    directory. Returns the prints, records and results."""
    from onda_torch.methods.evaluation import EvaluationRunner
    from onda_torch.train_ouda import _with_adapt_defaults

    fail = set(sc["fail_on_ranks"].get(rank, ()))
    read = EvaluationRunner.read_checkpoint

    def read_or_fail(self, path):
        if os.path.basename(path) in fail:
            raise OSError(f"injected read failure of {os.path.basename(path)}")
        return read(self, path)

    cfg = cfg_from_file(os.path.join(ROOT, "configs", "validation_offline_fog.yml"))
    h, w = sc["hw"]
    cfg.SCHEME.RESOLUTION = [w, h]
    cfg.OTHERS.SNAPSHOT_DIR = sc["ckpt_dir"]
    cfg.TRAINING.BATCH_SIZE = sc["batch"]
    spec = _with_adapt_defaults(cfg, cfg.METHOD.PRETRAIN.EVALUATION)
    spec.LOAD_PROTO, spec.set_ = None, "(25,)"
    spec.PREDICTION_SAVE = f"{sc['pred_dir']}{rank}"  # one directory a rank: rank 1's stays empty
    b = sc["batch"] // world
    n_val = len(sc["val"]["image"]) // world
    val = {k: v[rank * n_val:(rank + 1) * n_val] for k, v in sc["val"].items()}
    out = {}
    for part in ("load", "sweep"):
        text = io.StringIO()
        logger = Recorder()
        model = model_of(state_dict, False)
        with contextlib.redirect_stdout(text), _patched(EvaluationRunner, "read_checkpoint",
                                                         read_or_fail):
            runner = EvaluationRunner(model, registry.variables_of(model), cfg, spec, 19,
                                      logger=logger, device="cpu")
            if part == "load":
                out["evaluate_all"] = runner.evaluate_all({"v": val_loader(val, b)})
                frames = nchw(sc["frames"])[rank::world][:len(sc["frames"]) // world]
                runner.run_predictions([{"image": frames[i:i + b]}
                                        for i in range(0, len(frames), b)])
            else:
                out["best"] = runner.sweep_checkpoints({"v": val_loader(val, b)})
        out[f"{part}_print"] = text.getvalue()
        out[f"{part}_records"] = logger.records
    return out


# ---- the spatial axis ------------------------------------------------------

def spatial_rows(x, row_dim):
    """This rank's rows of a global batch on a (data × spatial) grid: its
    data index's samples, its spatial index's block of their rows."""
    from onda_torch.parallel import spatial

    d, b = distributed.data_rank(), len(x) // distributed.data_world()
    return spatial.shard_rows(x[d * b:(d + 1) * b], row_dim)


def run_spatial_forward(sc, state_dict, rank, world, snap):
    """The model's forward on a grid of sc["grid"] (data, spatial), in eval
    mode and in train mode (batch statistics, no update): this rank's
    blocks of "out" and "feat", and the collectives by group."""
    from onda_torch.parallel import mesh

    mesh.spatial_grid(sc["grid"], len(sc["image"]))
    model = model_of(state_dict, False)
    x = spatial_rows(nchw(sc["image"]), 2)
    out = {"position": (distributed.data_rank(), distributed.spatial_rank())}
    distributed.reset_counts()
    with torch.no_grad():
        for train in (False, True):
            _, main = model(x, train=train, update_stats=False, with_aux=False)
            out[f"train={train}"] = {k: v.clone() for k, v in main.items()}
    out["collectives"] = {g: dict(c) for g, c in distributed.COUNTS.items()}
    return out


def run_spatial_step(sc, state_dict, rank, world, snap):
    """hybrid_switch.yml's bootstrap (from full-resolution source labels)
    and sc["steps"] fused steps on a grid of sc["grid"] (data, spatial),
    every input cut to this rank's rows (the loss-grid labels as the feature
    grid): per step the logs, this rank's hard pseudo-labels (K1's first
    launch), the collectives by group and the digests of the state; the
    prototypes after the bootstrap and the step, Σ|params| in f64 and the
    selected parameters (rank 0)."""
    from onda_torch.parallel import mesh

    mesh.spatial_grid(sc["grid"], sc["batch"])
    ad = make_adapter(state_dict, "hybrid_switch", sc["spec"], snap, sc["hw"], sc["batch"])
    boot = sc["boot"]
    ad.calculate_prototypes([{"image": spatial_rows(nchw(boot["image"]), 2),
                              "label": spatial_rows(torch.tensor(boot["label"]), 1)}])
    out = {"position": (distributed.data_rank(), distributed.spatial_rank()),
           "boot_proto": {k: v.clone() for k, v in vars(ad.state.proto).items()}, "logs": [],
           "hard": [], "collectives": [], "digests": []}
    step = ad.step_fn(True, 1, False)
    launch = K.pseudo_labels

    def recording(feat, *args, **kwargs):
        result = launch(feat, *args, **kwargs)
        if len(out["hard"]) < len(out["logs"]) + 1:  # the step's first launch: the hard labels
            out["hard"].append(result[1].clone())
        return result

    K.pseudo_labels = recording
    try:
        for src, trg in sc["steps"]:
            labels = spatial_rows(torch.tensor(src["label_res"]), 1)[None].long()
            distributed.reset_counts()
            ad.state, logs = step(ad.state, spatial_rows(nchw(trg["image"]), 2),
                                  spatial_rows(nchw(src["image"]), 2)[None], labels, sc["lr"])
            out["collectives"].append({g: dict(c) for g, c in distributed.COUNTS.items()})
            out["logs"].append(dict(logs.items()))
            out["hard"][-1] = out["hard"][-1].view(labels.shape[1], labels.shape[2], -1)
            out["digests"].append(digests_of(state_tensors(ad.state)))
    finally:
        K.pseudo_labels = launch
    out["proto"] = {k: v.clone() for k, v in vars(ad.state.proto).items()}
    out["abs_params"] = float(sum(v.double().abs().sum() for v in ad.state.params.values()))
    out["params"] = ({k: ad.state.params[k].clone() for k in SELECTED} if rank == 0 else {})
    return out


@contextlib.contextmanager
def _patched(owner, name, value):
    saved = owner.__dict__.get(name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        if saved is None:
            delattr(owner, name)
        else:
            setattr(owner, name, saved)


KINDS = {"adversarial": run_adversarial, "segment": run_segment, "evaluation": run_evaluation,
         "tensor_parallel": run_tensor_parallel, "chain": run_chain,
         "spatial_forward": run_spatial_forward, "spatial_step": run_spatial_step}


def main():
    if sys.argv[1] == "cli":
        from onda_torch import train_ouda

        registry.LAYERS["DeepLabv2-Resnet50"] = (1, 1, 1, 1)
        train_ouda.main(sys.argv[2:])
        return
    payload_path, out_dir = sys.argv[1:3]
    torch.set_num_threads(2)
    distributed.initialize("cpu")
    rank, world = distributed.rank(), distributed.world()
    payload = torch.load(payload_path, weights_only=False)
    results = {"world": world, "backend": distributed.backend(), "scenarios": {}}
    for name, sc in payload["scenarios"].items():
        snap = os.path.join(out_dir, f"snap_{name}_{rank}")
        if sc.get("card_bn"):  # the BatchNorm variance as K2 takes it on the card
            K.bn_stats_plain = card_bn_stats
        run = KINDS.get(sc.get("kind"), run_scenario)
        state_dict = payload["state_dicts"][sc["model"]] if "model" in sc else payload["state_dict"]
        results["scenarios"][name] = run(sc, state_dict, rank, world, snap)
        if sc.get("drop_snapshot"):  # files no test reads: their disk freed at once
            shutil.rmtree(snap, ignore_errors=True)
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    distributed.destroy()


if __name__ == "__main__":
    main()
