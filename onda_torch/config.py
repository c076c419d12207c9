"""Config system: its own copy of `onda_tpu/config.py`.

Reproduces the semantics the reference builds on ``addict.Dict`` + YAML merge
(reference framework/domain_adaptation/config_ouda.py:24-115):

* attribute-style access, arbitrarily deep;
* a *missing* key returns an empty ``Config`` that compares equal to ``{}`` and is
  falsy (the reference's ``if x == {}`` "unset" idiom), so the tree keeps the
  tri-state unset / None / value;
* ``cfg_from_file`` recursively merges a YAML file over the defaults with no key
  validation (unknown keys are accepted silently).
"""

from __future__ import annotations

import copy
from datetime import datetime
from pathlib import Path

import yaml

class Config(dict):
    """addict-style attribute dict with `{} == unset` semantics.

    Missing attribute/key access returns an empty child Config that compares equal
    to `{}` and is falsy; the child carries a parent link so that *writing* into it
    attaches the whole path (`cfg.A.B.C = 1` vivifies A and B), while pure reads
    leave the tree unmodified — exactly addict's behavior, which the reference's
    `if x == {}` unset idiom depends on.
    """

    def __init__(self, *args, **kwargs):
        super().__init__()
        for arg in args:
            if arg is None:
                continue
            for key, val in dict(arg).items():
                self[key] = self._wrap(val)
        for key, val in kwargs.items():
            self[key] = self._wrap(val)

    @classmethod
    def _wrap(cls, value):
        if isinstance(value, Config):
            return value
        if isinstance(value, dict):
            return cls(value)
        if isinstance(value, (list, tuple)):
            return type(value)(cls._wrap(v) for v in value)
        return value

    # --- attribute access -------------------------------------------------
    def __getattr__(self, name):
        if name.startswith("__"):  # keep pickling/copy protocols sane
            raise AttributeError(name)
        return self[name]

    def __setattr__(self, name, value):
        self[name] = self._wrap(value)

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    # --- item access ------------------------------------------------------
    def __getitem__(self, key):
        if key not in self:
            child = Config()  # empty node: falsy, == {}; attaches on first write
            object.__setattr__(child, "_parent", self)
            object.__setattr__(child, "_parent_key", key)
            return child
        return super().__getitem__(key)

    def __setitem__(self, key, value):
        super().__setitem__(key, self._wrap(value))
        # attach this node to its parent chain on first write (addict vivification)
        try:
            parent = object.__getattribute__(self, "_parent")
            parent_key = object.__getattribute__(self, "_parent_key")
        except AttributeError:
            return
        object.__delattr__(self, "_parent")
        object.__delattr__(self, "_parent_key")
        parent[parent_key] = self

    # --- misc -------------------------------------------------------------
    def __deepcopy__(self, memo):
        out = Config()
        memo[id(self)] = out
        for key, val in self.items():
            out[copy.deepcopy(key, memo)] = copy.deepcopy(val, memo)
        return out

    def copy(self):
        return copy.deepcopy(self)

    def to_dict(self):
        out = {}
        for key, val in self.items():
            if isinstance(val, Config):
                out[key] = val.to_dict()
            elif isinstance(val, (list, tuple)):
                out[key] = type(val)(
                    v.to_dict() if isinstance(v, Config) else v for v in val
                )
            else:
                out[key] = val
        return out


def unset(value) -> bool:
    """True when a config value is the `{}`-unset sentinel (reference idiom `x == {}`)."""
    return isinstance(value, (dict, Config)) and len(value) == 0


def value_or(value, default):
    """Return `default` when `value` is unset-or-None, else `value`."""
    if value is None or unset(value):
        return default
    return value


# ---------------------------------------------------------------------------
# Default tree (reference: config_ouda.py:26-79)
# ---------------------------------------------------------------------------


def default_config() -> Config:
    cfg = Config()

    cfg.SCHEME.DATASET = "rainy_cityscapes"
    cfg.SCHEME.FILTERS = {}
    cfg.SCHEME.COLUMN = "intensity"
    cfg.SCHEME.SOURCE = [0]
    cfg.SCHEME.DOMAIN_ORDER = [[5], [25]]
    cfg.SCHEME.UNDERSAMPLE = True
    cfg.SCHEME.PATH = "/data/datasets/weather_datasets/weather_cityscapes/"
    cfg.SCHEME.RESOLUTION = [1024, 512]

    cfg.TRAINING.SOURCE_EPOCHS = 0
    cfg.TRAINING.DOMAIN_EPOCH = 1
    cfg.TRAINING.RANDOM_SEED = 123

    # default hyperparameter blocks, stamped per train-type as in the reference
    # (config_ouda.py:43-68)
    cfg.DEFAULT.ADVENT.LEARNING_RATE = 2.5e-4
    cfg.DEFAULT.ADVENT.MOMENTUM = 0.9
    cfg.DEFAULT.ADVENT.WEIGHT_DECAY = 0.0005
    cfg.DEFAULT.ADVENT.POWER = 0.9
    cfg.DEFAULT.ADVENT.LAMBDA_SEG_MAIN = 1.0
    cfg.DEFAULT.ADVENT.LAMBDA_SEG_AUX = 0.1
    cfg.DEFAULT.ADVENT.LEARNING_RATE_D = 1e-4
    cfg.DEFAULT.ADVENT.LAMBDA_ADV_MAIN = 0.001
    cfg.DEFAULT.ADVENT.LAMBDA_ADV_AUX = 0.0002

    cfg.DEFAULT.SEGMENT.LEARNING_RATE = 2.5e-4
    cfg.DEFAULT.SEGMENT.MOMENTUM = 0.9
    cfg.DEFAULT.SEGMENT.WEIGHT_DECAY = 0.0005

    for method in ("ADVENT", "SEGMENT"):
        for tr_type in ("PRETRAIN", "ADAPTATION"):
            cfg.METHOD[tr_type][method] = cfg.DEFAULT[method].copy()

    cfg.MODEL.LOAD = None
    cfg.MODEL.MULTI_LEVEL = False
    cfg.MODEL.NAME = "DeepLabv2-Resnet50"

    cfg.OTHERS.NUM_WORKERS = 8
    cfg.OTHERS.SNAPSHOT_DIR = str(
        Path("OUDA_TEST") / datetime.now().strftime("%y%m%d-%H:%M")
    )
    cfg.OTHERS.GENERATE_SAMPLES_EVERY = 10
    cfg.OTHERS.DEVICE = "cuda"

    return cfg


def merge_into(src, dst: Config) -> None:
    """Recursively merge `src` over `dst`, clobbering scalars/lists.

    Mirrors reference `_merge_a_into_b` (config_ouda.py:85-106): unknown keys are
    accepted silently; nested dicts merge recursively; everything else replaces.
    """
    if not isinstance(src, (dict, Config)):
        return
    for key, val in src.items():
        if isinstance(val, (dict, Config)):
            # recurse into EVERY mapping value like the reference
            # (config_ouda.py:99-104): an empty mapping merges nothing, so
            # `TRAINING: {}` in user YAML preserves the default subtree
            # instead of wiping it
            node = dst[key]
            if not isinstance(node, Config):
                dst[key] = Config()
            elif key not in dst:
                dst[key] = node  # attach the detached empty node
            merge_into(val, dst[key])
        else:
            dst[key] = val


def cfg_from_file(filename, cfg: Config | None = None) -> Config:
    """Load a YAML file and merge it over the defaults (reference config_ouda.py:112-115)."""
    if cfg is None:
        cfg = default_config()
    with open(filename, "r") as f:
        yaml_cfg = yaml.safe_load(f)
    merge_into(yaml_cfg or {}, cfg)
    return cfg
