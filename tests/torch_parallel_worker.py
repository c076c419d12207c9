"""One rank of the port's data-parallel step, for tests/test_torch_parallel.py.

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
its rows of each global batch (rank-major: rows [r·b, (r+1)·b)), bootstraps
the prototypes, evaluates, and takes the steps. It writes `rank<r>.pt`: per
scenario the evaluation, the logs of each step, a digest of every tensor of
the state after each step (for bit-identity across ranks), selected tensors
(rank 0 only: for the comparisons with JAX and with one process) and its
local valid-pixel counts. Imports no JAX.
"""

import hashlib
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from onda_torch import registry  # noqa: E402
from onda_torch.config import cfg_from_file  # noqa: E402
from onda_torch.methods.proto_online import ProtoOnlineAdapter  # noqa: E402
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
        results["scenarios"][name] = run_scenario(sc, payload["state_dict"], rank, world, snap)
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    distributed.destroy()


if __name__ == "__main__":
    main()
