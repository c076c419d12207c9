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
and takes PROTO_ONLINE steps; `adversarial` takes ADVENT or PROTO_ADVENT
steps; `segment` runs `SegmentTrainer.train`; `evaluation` makes the
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


def make_adapter(state_dict, config, spec_over, snap, hw, batch):
    cfg, spec = configure(config, spec_over, snap, hw)
    cfg.TRAINING.BATCH_SIZE = batch
    model = build_deeplab_v2(19, (1, 1, 1, 1), "ProDA", droprate=0.0)
    model.load_state_dict(state_dict, strict=True)
    return ProtoOnlineAdapter(model, registry.variables_of(model), cfg, spec, 19, device="cpu")


def state_tensors(state):
    """Every tensor of an AdaptState by a flat name."""
    out = {}
    for tree in ("params", "batch_stats", "alt_batch_stats", "opt_momentum", "ema_params",
                 "dynamic_params", "dynamic_batch_stats"):
        out.update({f"{tree}.{k}": v for k, v in getattr(state, tree).items()})
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
        out["collectives"].append(dict(distributed.COUNTS))
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


# ---- ADVENT and PROTO_ADVENT ---------------------------------------------

def adversarial_tensors(ad):
    """Every tensor of an ADVENT or PROTO_ADVENT adapter's state by a flat
    name, the discriminators and their Adam states (`count` included)."""
    if hasattr(ad, "d_state"):  # PROTO_ADVENT: an AdaptState beside the discriminators
        out = state_tensors(ad.state)
        discs = {"d_aux": ad.d_state["aux"], "d_main": ad.d_state["main"],
                 "d_aux_opt": ad.d_state["aux_opt"], "d_main_opt": ad.d_state["main_opt"]}
    else:
        s = ad.state
        out = {f"{tree}.{k}": v for tree in ("params", "batch_stats", "opt_momentum")
               for k, v in getattr(s, tree).items()}
        out["generator"] = s.generator.get_state()
        discs = {name: getattr(s, name) for name in ("d_aux", "d_main", "d_aux_opt", "d_main_opt")}
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
    """The compared tensors, thinned (`thin`): with `full` every tensor
    (rank 0's after the first step), else the selected parameters,
    statistics and the discriminators' first and last layers with their
    Adam moments."""
    tensors = adversarial_tensors(ad)
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
    """The scenario's ADVENT or PROTO_ADVENT adapter at its global batch,
    its discriminators the payload's."""
    cfg, spec = configure(sc["config"], sc["spec"], snap, sc["hw"])
    cfg.TRAINING.BATCH_SIZE = sc["batch"]
    cfg.MODEL.MULTI_LEVEL = sc["multi_level"]
    model = model_of(state_dict, sc["multi_level"])
    ad = registry.get_adapt_method(cfg)(model, registry.variables_of(model), cfg, spec, 19,
                                        device="cpu")
    discs = {name: {k: v.clone() for k, v in sd.items()} for name, sd in sc["discs"].items()}
    if hasattr(ad, "d_state"):
        ad.d_state["aux"], ad.d_state["main"] = discs["d_aux"], discs["d_main"]
    else:
        ad.state.d_aux, ad.state.d_main = discs["d_aux"], discs["d_main"]
    return ad


def run_adversarial(sc, state_dict, rank, world, snap):
    """The scenario's steps on this rank's rows (PROTO_ADVENT after a
    bootstrap on its rows of the payload's source batch)."""
    ad = make_adversarial(sc, state_dict, snap)
    out = {"logs": [], "digests": [], "values": [], "collectives": []}
    if hasattr(ad, "d_state"):
        boot = sc["boot"]
        ad.calculate_prototypes([{"image": local_rows(nchw(boot["image"]), rank, world),
                                  "label": local_rows(torch.tensor(boot["label"]), rank, world)}])
        step = ad.pa_step_fn()
    else:
        step = ad.build_step()
    for i, (src, trg) in enumerate(sc["steps"]):
        s_img = local_rows(nchw(src["image"]), rank, world)
        s_lbl = local_rows(torch.tensor(src["label"]).long(), rank, world)
        t_img = local_rows(nchw(trg["image"]), rank, world)
        distributed.reset_counts()
        if hasattr(ad, "d_state"):
            ad.state, ad.d_state, logs = step(ad.state, ad.d_state, s_img, s_lbl, t_img,
                                              sc["lr"], sc["lr_d"])
        else:
            ad.state, logs = step(ad.state, s_img, s_lbl, t_img, sc["lr"], sc["lr_d"])
        out["collectives"].append(dict(distributed.COUNTS))
        out["logs"].append({k: float(v) for k, v in logs.items()})
        out["digests"].append({k: digest(v) for k, v in adversarial_tensors(ad).items()})
        out["values"].append(adversarial_values(ad, full=i == 0) if rank == 0 else {})
    return out


# ---- SEGMENT --------------------------------------------------------------

def make_trainer(sc, state_dict, snap):
    cfg = cfg_from_file(os.path.join(ROOT, "configs", "training_fog.yml"))
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
    """`SegmentTrainer.train` over one epoch of this rank's rows of the
    payload's batches, with its evaluation of this rank's validation rows;
    each step's LR, loss (this rank's share), collectives and state."""
    tr = make_trainer(sc, state_dict, snap)
    out = {"lr": [], "loss": [], "digests": [], "values": [], "collectives": []}
    step = tr.step

    def recorded(images, labels, lr):
        distributed.reset_counts()
        loss = step(images, labels, lr)
        out["collectives"].append(dict(distributed.COUNTS))
        out["lr"].append(lr)
        out["loss"].append(float(loss))
        tensors = {**{f"params.{k}": v for k, v in tr.params.items()},
                   **{f"batch_stats.{k}": v for k, v in tr.batch_stats.items()},
                   **{f"momentum.{k}": v for k, v in tr.momentum_buf.items()}}
        out["digests"].append({k: digest(v) for k, v in tensors.items()})
        out["values"].append({k: thin(v.detach()).clone() for k, v in tensors.items()
                              if not k.startswith("momentum.")} if rank == 0 else {})
        return loss

    tr.step = recorded

    def rows(batches):
        return [{k: local_rows(nchw(v) if k == "image" else torch.tensor(v), rank, world)
                 for k, v in b.items()} for b in batches]

    tr.train({"src": rows(sc["steps"])}, {"v": rows(sc["val"])})
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


KINDS = {"adversarial": run_adversarial, "segment": run_segment, "evaluation": run_evaluation}


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
        run = KINDS.get(sc.get("kind"), run_scenario)
        state_dict = payload["state_dicts"][sc["model"]] if "model" in sc else payload["state_dict"]
        results["scenarios"][name] = run(sc, state_dict, rank, world, snap)
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    distributed.destroy()


if __name__ == "__main__":
    main()
