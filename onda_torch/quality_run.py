"""The full-resolution adaptation-quality run on the card (the port of
`tools/tpu_quality_run.py`):

    python -m onda_torch.quality_run                 # bf16, on the card
    ONDA_QUALITY_PRECISION=f32 python -m onda_torch.quality_run   # the f32 control

1. writes a synthetic shift storm at 1024x512 (`data/synthetic.py`: the
   clear source, then the colours shifted by 0.6 and 0.3, seeds 0, 1, 2, one
   `metadata.json` over the three);
2. pretrains DeepLab-v2 R50 with the ProDA head on the clear train frames
   with Adam (`pretrain_adam`) and writes it as a reference-layout `.pth`.
   This is experiment tooling, not the product path: the published SGD
   recipe leaves the deep dilated R50 on the ln(4) plateau of this colour
   task at any tested rate;
3. drives the real CLI (`train_ouda.main`) from that `.pth` over the storm
   [[60], [30]] with configs/hybrid_switch.yml and OTHERS.PRECISION;
4. reports whether the heavy domain recovers under adaptation, one JSON line:
   {"precision", "src_miou_pretrained", "source_pre", "heavy_pre",
    "heavy_post", "source_post", "recovered", "steps", "wall_s"}.

Knobs, from the environment (the JAX tool's names and defaults):
ONDA_QUALITY_BATCH (8), ONDA_QUALITY_NTRAIN (48) and ONDA_QUALITY_NVAL (8)
frames a domain, ONDA_QUALITY_PRETRAIN_EPOCHS (30), ONDA_QUALITY_UDA_EPOCHS
(20), ONDA_QUALITY_PRECISION (bf16; anything else computes in f32),
ONDA_QUALITY_REUSE_PTH (1: a `source_<precision>.pth` already in the run's
directory is adapted from without pretraining), ONDA_QUALITY_DIR (the run's
directory, default `onda_torch_quality` under the temporary directory) and
ONDA_QUALITY_OUT (the file the result's JSON goes to; default
`quality_<precision>.json` in the run's directory, "" for none).

It runs on the card; without one it stops, unless asked for the CPU with
`--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

W, H = 1024, 512
NUM_CLASSES = 19
STORM = (0.0, 0.6, 0.3)  # colour shifts of the source, the heavy and the light domain
LR = 1e-3                # Adam's rate in pretraining
CONFIG = Path(__file__).resolve().parents[1] / "configs" / "hybrid_switch.yml"


def knobs(env=os.environ) -> dict:
    """The run's settings from the environment (read at call time)."""
    precision = env.get("ONDA_QUALITY_PRECISION", "bf16")
    root = env.get("ONDA_QUALITY_DIR", os.path.join(tempfile.gettempdir(), "onda_torch_quality"))
    return {"batch": int(env.get("ONDA_QUALITY_BATCH", 8)),
            "n_train": int(env.get("ONDA_QUALITY_NTRAIN", 48)),
            "n_val": int(env.get("ONDA_QUALITY_NVAL", 8)),
            "pretrain_epochs": int(env.get("ONDA_QUALITY_PRETRAIN_EPOCHS", 30)),
            "uda_epochs": int(env.get("ONDA_QUALITY_UDA_EPOCHS", 20)),
            "precision": precision,
            "reuse_pth": env.get("ONDA_QUALITY_REUSE_PTH", "1") == "1",
            "root": root,
            "out": env.get("ONDA_QUALITY_OUT", os.path.join(root, f"quality_{precision}.json"))}


def make_storm(ds_root: str, n_train: int, n_val: int, size_wh=(W, H)):
    """The three domains' frames under `ds_root` and their `metadata.json`;
    returns the table."""
    from .data.metadata import Table, save_table
    from .data.synthetic import make_shift_dataset

    table = Table.concat(make_shift_dataset(ds_root, n_train=n_train, n_val=n_val,
                                            size_wh=size_wh, shift=s, seed=i)
                         for i, s in enumerate(STORM))
    save_table(table, os.path.join(ds_root, "metadata.json"))
    return table


def build_model(layers, precision: str, droprate: float = 0.1):
    """DeepLab-v2 with the ProDA head and `layers` bottlenecks a stage, its
    weights drawn with the global generator seeded to 0 (as
    `registry.get_model` draws them); bf16 compute over f32 parameters under
    "bf16"."""
    from .models import build_deeplab_v2

    dtype = torch.bfloat16 if precision == "bf16" else None
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return build_deeplab_v2(NUM_CLASSES, tuple(layers), "ProDA", dtype=dtype,
                                droprate=droprate)


def unused_params(model) -> list:
    """The parameters no pretraining loss reaches: the structural aux head
    (`layer5` beside `layer6`) that a model without MULTI_LEVEL never runs."""
    if getattr(model, "layer6", None) is None or model.multi_level:
        return []
    return [k for k, _ in model.named_parameters() if k.startswith("layer5.")]


def adam_step(model, params: dict, opt: dict, images, labels, generator=None, unused=()):
    """One pretraining step (`tools/tpu_quality_run.py:83-96`): a train-mode
    forward that updates the BatchNorm running statistics, dropout drawn from
    `generator` (None: off), the CE of the logits upsampled bilinearly
    (align_corners) to the labels' size, and Adam at LR over `params` in
    place. The logits are cast to f32 before the upsample, as the port's
    SEGMENT step casts them under bf16. Returns (loss, gradients); the loss
    is a tensor, not read."""
    from .methods import optim
    from .ops import losses as L
    from .ops.interp import upsample_bilinear_ac

    _, main = model(images, train=True, update_stats=True, generator=generator)
    out = main["out"] if isinstance(main, dict) else main
    loss = L.cross_entropy_2d(upsample_bilinear_ac(out.float(), tuple(labels.shape[-2:])), labels)
    grads = optim.grads(loss, params, list(params), unused)
    optim.adam_update(params, grads, opt, LR)
    return loss.detach(), grads


def pretrain_adam(ds_root: str, table, pth_out: str, *, batch: int, epochs: int,
                  precision: str, layers=(3, 4, 6, 3), size_wh=(W, H), device="cuda",
                  num_workers: int = 4) -> dict:
    """Adam source pretraining (`tools/tpu_quality_run.py:45-128`) on the
    clear train frames for `epochs`, then the populated-4-class IoU on the
    clear val frames; writes the student's state_dict to `pth_out` (it loads
    with `strict=True` through MODEL.LOAD). Returns {"src_miou": the IoU,
    "epoch_seconds": [...], "steps_per_epoch": n, "model": the model}."""
    from .data import Loader, SegmentationDataset
    from .data.loader import to_device
    from .data.metadata import load_dataset_info
    from .methods import optim
    from .native import BatchExecutor
    from .ops import metrics as M
    from .ops.interp import upsample_bilinear_ac
    from .utils.checkpoint import save_atomic

    info = load_dataset_info()
    label2train = dict(tuple(p) for p in info["label2train"])
    executor = BatchExecutor(num_workers)
    device = torch.device(device)

    def dl(frame, shuffle):
        ds = SegmentationDataset(ds_root + "/", frame, label2train, list(size_wh),
                                 mean=np.asarray(info["mean"]), std=np.asarray(info["std"]),
                                 executor=executor)
        return Loader(ds, batch_size=batch, shuffle=shuffle, seed=0, drop_last=True,
                      num_threads=num_workers, pin_memory=device.type == "cuda")

    clear = table.where("intensity", [0])
    src_train, src_val = clear.where("set", ["train"]), clear.where("set", ["val"])
    model = build_model(layers, precision).to(device)
    params = dict(model.named_parameters())
    opt = optim.adam_init(params)
    unused = unused_params(model)
    generator = torch.Generator(device=device).manual_seed(0)

    loader = dl(src_train, True)
    epoch_seconds = []
    for epoch in range(epochs):
        t = time.perf_counter()
        for b in loader:
            loss, _ = adam_step(model, params, opt, to_device(b["image"], device),
                                to_device(b["label"], device).long(), generator, unused)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        epoch_seconds.append(time.perf_counter() - t)
        if epoch % 5 == 4:
            print(f"# pretrain epoch {epoch}: loss {float(loss):.4f}", file=sys.stderr)

    hist = torch.zeros((NUM_CLASSES, NUM_CLASSES), dtype=torch.long, device=device)
    with torch.no_grad():
        for b in dl(src_val, False):
            _, main = model(to_device(b["image"], device), train=False)
            out = main["out"] if isinstance(main, dict) else main
            pred = upsample_bilinear_ac(out.float(), (size_wh[1], size_wh[0])).argmax(dim=1)
            hist += M.fast_hist(to_device(b["label"], device), pred, NUM_CLASSES)
    iou = M.per_class_iu(hist)
    pop = float(np.nanmean(iou[:4]))
    save_atomic({k: v.detach().cpu() for k, v in model.state_dict().items()}, pth_out)
    print(f"# pretrain done: populated IoU {pop:.4f}, nanmean19 {np.nanmean(iou):.4f}",
          file=sys.stderr)
    return {"src_miou": pop, "epoch_seconds": epoch_seconds, "steps_per_epoch": len(loader),
            "model": model}


def quality_config(ds_root: str, snaps: str, pth: str, *, batch: int, uda_epochs: int,
                   precision: str, size_wh=(W, H)) -> dict:
    """configs/hybrid_switch.yml with the JAX tool's edits
    (`tools/tpu_quality_run.py:164-178`), as a plain dict."""
    import yaml

    with open(CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg["SCHEME"].update(PATH=ds_root + "/", RESOLUTION=list(size_wh),
                         SOURCE=[[0]], DOMAIN_ORDER=[[60], [30]])
    cfg["TRAINING"].update(BATCH_SIZE=batch, REPLAY_BUFFER=16, SHUFFLE=True, RANDOM_SEED=123)
    cfg["MODEL"].update(NAME="DeepLabv2-Resnet50", LOAD=pth, MULTI_LEVEL=False)
    cfg["METHOD"]["PRETRAIN"]["SEGMENT"]["EPOCHS"] = 0
    spec = cfg["METHOD"]["ADAPTATION"][cfg["METHOD"]["ADAPTATION"]["NAME"]]
    spec.update(EPOCHS=uda_epochs, SKIP_CALC=False, LOAD_PROTO=None)
    # GENERATE_SAMPLES_EVERY 0 is the opt-out: a positive value renders
    # samples every epoch. OTHERS.AOT_CACHE (the JAX tool sets it true) has no
    # counterpart: the port compiles no step, and its kernels' build
    # directory is its warm start
    cfg["OTHERS"].update(SNAPSHOT_DIR=snaps, NUM_WORKERS=4, PRECISION=precision,
                         GENERATE_SAMPLES_EVERY=0)
    return cfg


def result_of(records: list, precision: str, src_miou, uda_epochs: int, wall_s: float) -> dict:
    """The run's result from its `metrics.jsonl` records
    (`tools/tpu_quality_run.py:188-206`): the heavy domain's mIoU before
    adaptation (the first evaluation) and its best over the first
    `uda_epochs` evaluations after it, the source's at the same points, and
    the recovery gate heavy_post > max(2·heavy_pre, heavy_pre + 0.01)."""
    heavy = [r["Val mIoU model of (60,)"] for r in records if "Val mIoU model of (60,)" in r]
    source = [r["Val mIoU model of (0,)"] for r in records if "Val mIoU model of (0,)" in r]
    steps = sum(1 for r in records if "Total target loss" in r)
    heavy_pre = heavy[0]
    heavy_post = max(heavy[1:uda_epochs + 1]) if len(heavy) > 1 else float("nan")
    return {
        "precision": precision,
        "src_miou_pretrained": round(src_miou, 4) if src_miou is not None else None,
        "source_pre": round(source[0], 4),
        "heavy_pre": round(heavy_pre, 4),
        "heavy_post": round(heavy_post, 4),
        "source_post": round(source[uda_epochs], 4) if len(source) > uda_epochs else None,
        # on the 19-class nanmean scale: the heavy domain must at least double
        # from its degraded floor and clear it by an absolute margin
        "recovered": bool(heavy_post > max(2 * heavy_pre, heavy_pre + 0.01)),
        "steps": steps,
        "wall_s": round(wall_s, 1),
    }


def run(device="cuda", size_wh=(W, H), layers=None, env=os.environ) -> dict:
    """The whole run with the settings of `env`; returns the result. `layers`
    (default: the registry's R50) is the pretrained model's depth, which must
    be the one `registry.get_model` builds for the CLI."""
    import yaml

    from . import registry, train_ouda

    k = knobs(env)
    precision = k["precision"]
    layers = registry.LAYERS["DeepLabv2-Resnet50"] if layers is None else layers
    t0 = time.time()
    ds_root = os.path.join(k["root"], "ds")
    snaps = os.path.join(k["root"], f"snaps_{precision}")
    os.makedirs(ds_root, exist_ok=True)
    shutil.rmtree(snaps, ignore_errors=True)
    table = make_storm(ds_root, k["n_train"], k["n_val"], size_wh)
    print(f"# dataset ready in {time.time() - t0:.0f}s", file=sys.stderr)

    pth = os.path.join(k["root"], f"source_{precision}.pth")
    if os.path.exists(pth) and k["reuse_pth"]:
        src_miou = None
        print(f"# reusing {pth}", file=sys.stderr)
    else:
        src_miou = pretrain_adam(ds_root, table, pth, batch=k["batch"],
                                 epochs=k["pretrain_epochs"], precision=precision,
                                 layers=layers, size_wh=size_wh, device=device)["src_miou"]

    cfg = quality_config(ds_root, snaps, pth, batch=k["batch"], uda_epochs=k["uda_epochs"],
                         precision=precision, size_wh=size_wh)
    cfg_path = os.path.join(k["root"], f"cfg_{precision}.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    train_ouda.main(["--cfg", cfg_path, "--device", str(device)])

    with open(os.path.join(snaps, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    result = result_of(records, precision, src_miou, k["uda_epochs"], time.time() - t0)
    print(json.dumps(result))
    if k["out"]:
        with open(k["out"], "w") as f:
            json.dump(result, f, indent=1)
        print(f"# wrote {k['out']}", file=sys.stderr)
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run on a card, or pass --device cpu")
    run(args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
