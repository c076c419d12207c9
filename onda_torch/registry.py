"""Registries: dataset, model and adaptation-method resolution (`onda_tpu/registry.py`).

Mirrors the reference handler layer (reference framework/handlers/): name
whitelists act as schema checks.
"""

from __future__ import annotations

import os

import torch

from .config import unset
from .utils import checkpoint

DATABASE_NAMES = [
    "rainy_cityscapes_video",
    "external_video",
    "rainy_cityscapes",
    "fog_cityscapes",
]

METADATA_FILES = {
    "rainy_cityscapes": "metadata.json",
    "fog_cityscapes": "metadata_fog.json",
    "rainy_cityscapes_video": "metadata_video.json",
    "external_video": "metadata_bern.json",
}

MODEL_NAMES = [
    "DeepLabv2-Resnet50",
    "DeepLabv2-Resnet101",
    "DeepLabv2-Resnet101-ProDA",
    "DeepLabv2-Resnet50-GN",
]

ADAPTATION_METHOD_NAMES = [
    "PROTO_ONLINE",
    "ADVENT",
    "PROTO_ONLINE_VSWITCH",
    "PROTO_ONLINE_HSWITCH",
    "PROTO_ADVENT",
    "PROTO_ONLINE_HYBRIDSWITCH",
]


# backbone depths (bottlenecks per stage) of each model name
LAYERS = {
    "DeepLabv2-Resnet50": (3, 4, 6, 3),
    "DeepLabv2-Resnet101": (3, 4, 23, 3),
    "DeepLabv2-Resnet101-ProDA": (3, 4, 23, 3),
    "DeepLabv2-Resnet50-GN": (3, 4, 6, 3),
}


def variables_of(model) -> dict:
    """{"params": name → tensor, "batch_stats": name → buffer}, detached."""
    return {"params": {k: v.detach() for k, v in model.named_parameters()},
            "batch_stats": {k: v.detach() for k, v in model.named_buffers()}}


def load_state_dict(path: str) -> dict:
    """Unpickle a `.pth`: a bare state_dict, a whole-module pickle, or
    Microsoft ProDA's training container `{"ResNet101": {"model_state": sd}}`
    (reference deeplabv2_proda.py:525-527)."""
    sd = checkpoint.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if isinstance(sd, dict) and isinstance(sd.get("ResNet101"), dict):
        inner = sd["ResNet101"]
        if "model_state" not in inner:
            raise ValueError(
                f"{path!r} has a top-level 'ResNet101' entry (Microsoft-ProDA training-container "
                f"layout) but no ['ResNet101']['model_state'] weights inside it; found keys "
                f"{sorted(inner)[:8]}")
        sd = inner["model_state"]
    return dict(sd)


def _load_checkpoint(model, path: str, sd: dict | None = None) -> None:
    """Load a reference `.pth` (`sd` when it is already unpickled); ImageNet
    checkpoints get the reference's prefix surgery and a partial load
    (reference model_handler.py:41-57)."""
    if sd is None:
        sd = load_state_dict(path)
    if "imagenet" in str(path).lower():
        out = {}
        for key, value in sd.items():
            parts = key.split(".")
            if parts[0] in ("Scale", "module"):
                parts = parts[1:]
            if parts[0] not in ("layer5", "fc"):
                out[".".join(parts)] = value
        model.load_state_dict(out, strict=False)
        return
    if hasattr(model, "layer6") and not any(k.startswith("layer5.") for k in sd):
        # a checkpoint of a model built without the structural aux head keeps
        # the initialised (frozen, unused) layer5; under the ProDA layout
        # layer5 is the head and must be in the checkpoint
        sd = {**{k: v for k, v in model.state_dict().items() if k.startswith("layer5.")}, **sd}
    model.load_state_dict(sd, strict=True)


def _given(value) -> bool:
    return value is not None and not unset(value) and value != "None"


def get_model(cfg, n_classes: int, device="cuda"):
    """Build the model on `device` and return (model, variables).

    Without MODEL.LOAD the weights are PyTorch's default init drawn with the
    global generator seeded to 0, so every run starts from the same model;
    with it, the `.pth` is loaded (reference model_handler.py:14-60).
    OTHERS.PRECISION "bf16"/"bfloat16" computes in bf16 over f32 parameters,
    anything else in f32; OTHERS.REMAT `true` rematerialises each bottleneck
    (`onda_tpu/registry.py:38-109`). `DeepLabv2-Resnet101-ProDA` forces
    MODEL.MULTI_LEVEL off, builds its `bn_pretrain` when the checkpoint has
    one (ImageNet checkpoints excepted) and unpickles it once."""
    from .models import build_deeplab_v2

    name = cfg.MODEL.NAME
    if name not in MODEL_NAMES:
        raise ValueError(f"cfg.MODEL.NAME should be in {MODEL_NAMES}, got {name!r}")
    classifier = cfg.MODEL.CLASSIFIER if not unset(cfg.MODEL.CLASSIFIER) else "normal"
    dtype = torch.bfloat16 if cfg.OTHERS.PRECISION in ("bf16", "bfloat16") else None
    remat = isinstance(cfg.OTHERS.REMAT, bool) and cfg.OTHERS.REMAT
    load = cfg.MODEL.LOAD
    sd, options = None, {}
    if name == "DeepLabv2-Resnet101-ProDA":
        # Microsoft ProDA's R101 (reference model_handler.py:28-30,
        # deeplabv2_proda.py:310-419,499-529): the reference's handler
        # hardcodes bn_clr=False; it is read off the checkpoint here
        cfg.MODEL.MULTI_LEVEL = False
        bn_clr = False
        if _given(load) and "imagenet" not in str(load).lower():
            sd = load_state_dict(str(load))
            bn_clr = any(k.startswith("bn_pretrain.") for k in sd)
        classifier, options = "ProDA", {"proda_layout": True, "bn_clr": bn_clr}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_deeplab_v2(n_classes, LAYERS[name], classifier, bool(cfg.MODEL.MULTI_LEVEL),
                                 group_norm_backbone=name == "DeepLabv2-Resnet50-GN", dtype=dtype,
                                 remat=remat, **options)
    if _given(load):
        _load_checkpoint(model, str(load), sd)
    model = model.to(device)
    return model, variables_of(model)


def get_db(cfg) -> dict:
    """Split the metadata table per domain (reference database_handler.py:12-73).

    Returns {"domains_src": [...], "domains_trg": [...], "db_info": info}, each
    domain a {"train": {set_: Table}, "val": {set_: Table}} bucket. The table
    is SCHEME.METADATA, or the dataset's file under SCHEME.PATH."""
    from .data import metadata as MD
    from .data.splits import get_split

    name = cfg.SCHEME.DATASET
    if name not in DATABASE_NAMES:
        raise ValueError(f"cfg.SCHEME.DATASET not in {DATABASE_NAMES}: {name!r}")
    info = MD.load_dataset_info()
    table_path = cfg.SCHEME.METADATA if not unset(cfg.SCHEME.METADATA) else None
    if table_path is None:
        table_path = os.path.join(str(cfg.SCHEME.PATH), METADATA_FILES[name])
    if not os.path.exists(table_path):
        raise FileNotFoundError(f"metadata table {table_path} not found (the reference's "
                                "metadata JSONs are not distributed; tools/make_metadata.py "
                                "writes one from a dataset tree)")
    table = MD.load_table(table_path)
    # the video datasets are train-only streams: no "val" buckets at all
    labeled_val = name not in ("external_video", "rainy_cityscapes_video")
    domains = list(cfg.SCHEME.SOURCE) + list(cfg.SCHEME.DOMAIN_ORDER)
    dbs = [get_split(table, cfg.SCHEME.COLUMN, [domain], [domain] if labeled_val else [],
                     cfg.SCHEME.FILTERS or {})
           for domain in domains]
    n_src = len(list(cfg.SCHEME.SOURCE))
    return {"domains_src": dbs[:n_src], "domains_trg": dbs[n_src:], "db_info": info}


def get_adapt_method(cfg):
    """Adaptation-method class by name (reference adaptation_method_handler.py:11-40)."""
    name = cfg.METHOD.ADAPTATION.NAME
    if name not in ADAPTATION_METHOD_NAMES:
        raise ValueError(f"cfg.METHOD.ADAPTATION.NAME not in {ADAPTATION_METHOD_NAMES}: {name!r}")
    if name == "ADVENT":
        from .methods.advent import AdventAdapter

        return AdventAdapter
    if name == "PROTO_ADVENT":
        from .methods.proto_advent import ProtoAdventAdapter

        return ProtoAdventAdapter
    from .methods.proto_online import ProtoOnlineAdapter

    return ProtoOnlineAdapter
