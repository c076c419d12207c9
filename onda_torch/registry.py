"""Registries: model and adaptation-method resolution (`onda_tpu/registry.py`).

Mirrors the reference handler layer (reference framework/handlers/): name
whitelists act as schema checks.
"""

from __future__ import annotations

import torch

from .config import unset

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


def variables_of(model) -> dict:
    """{"params": name → tensor, "batch_stats": name → buffer}, detached."""
    return {"params": {k: v.detach() for k, v in model.named_parameters()},
            "batch_stats": {k: v.detach() for k, v in model.named_buffers()}}


def _load_checkpoint(model, path: str) -> None:
    """Load a reference `.pth` (bare state_dict or whole-module pickle); ImageNet
    checkpoints get the reference's prefix surgery and a partial load
    (reference model_handler.py:41-57)."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
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
    if not any(k.startswith("layer5.") for k in sd):
        # a checkpoint of a model built without the structural aux head keeps
        # the initialised (frozen, unused) layer5
        sd = {**{k: v for k, v in model.state_dict().items() if k.startswith("layer5.")}, **sd}
    model.load_state_dict(sd, strict=True)


def get_model(cfg, n_classes: int, device="cuda"):
    """Build the model on `device` and return (model, variables).

    Without MODEL.LOAD the weights are PyTorch's default init drawn with the
    global generator seeded to 0, so every run starts from the same model;
    with it, the `.pth` is loaded (reference model_handler.py:14-60)."""
    from .models import build_deeplab_v2

    name = cfg.MODEL.NAME
    if name not in MODEL_NAMES:
        raise ValueError(f"cfg.MODEL.NAME should be in {MODEL_NAMES}, got {name!r}")
    classifier = cfg.MODEL.CLASSIFIER if not unset(cfg.MODEL.CLASSIFIER) else "normal"
    multi_level = bool(cfg.MODEL.MULTI_LEVEL)
    layers = {"DeepLabv2-Resnet50": (3, 4, 6, 3), "DeepLabv2-Resnet101": (3, 4, 23, 3)}.get(name)
    if layers is None:
        raise NotImplementedError(f"{name} is not ported yet")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_deeplab_v2(n_classes, layers, classifier, multi_level)
    load = cfg.MODEL.LOAD
    if load is not None and not unset(load) and load != "None":
        _load_checkpoint(model, str(load))
    model = model.to(device)
    return model, variables_of(model)


def get_adapt_method(cfg):
    """Adaptation-method class by name (reference adaptation_method_handler.py:11-40)."""
    name = cfg.METHOD.ADAPTATION.NAME
    if name not in ADAPTATION_METHOD_NAMES:
        raise ValueError(f"cfg.METHOD.ADAPTATION.NAME not in {ADAPTATION_METHOD_NAMES}: {name!r}")
    if name in ("ADVENT", "PROTO_ADVENT"):
        raise NotImplementedError(f"{name} is not ported yet")
    from .methods.proto_online import ProtoOnlineAdapter

    return ProtoOnlineAdapter
