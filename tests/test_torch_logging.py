"""The port's Logger (`onda_torch/utils/logging_.py`) against the JAX
package's (`onda_tpu/utils/logging_.py`): wandb when asked for, by the
argument or by `ONDA_WANDB=1`, with the reference's key names and mask
overlays; `metrics.jsonl` alone when wandb cannot be imported or its run
cannot start. A fake `wandb` module records what reaches it."""

import json
import sys
import types

import numpy as np
import pytest

from onda_torch.utils.logging_ import Logger
from onda_torch.utils.viz import MaskSample


class _FakeImage:
    def __init__(self, data, masks=None, caption=None):
        self.data = data
        self.masks = masks
        self.caption = caption


def _fake_wandb(records, fail_init=False):
    mod = types.ModuleType("wandb")
    mod.Image = _FakeImage
    mod.run = types.SimpleNamespace(name=None)

    def init(**kw):
        if fail_init:
            raise RuntimeError("no network")
        records["init"] = kw

    mod.init = init
    mod.log = lambda payload, step=None: records.setdefault("logs", []).append((payload, step))
    return mod


def _sample(tmp_path):
    png = tmp_path / "sample.png"
    png.write_bytes(b"not-a-real-png")
    return MaskSample(image_rgb=np.zeros((4, 6, 3), np.uint8), pred=np.ones((4, 6), np.int32),
                      label=np.full((4, 6), 255, np.int32),
                      class_labels={0: "road", 1: "sidewalk"}, caption="Sample from clear",
                      path=str(png))


def _jsonl(tmp_path):
    return [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]


@pytest.mark.parametrize("asked", ["argument", "ONDA_WANDB=1"])
def test_logger_wandb_mask_sample(tmp_path, monkeypatch, asked):
    """The twin of tests/test_logging.py::test_logger_wandb_mask_sample: the
    sample reaches wandb as an Image with both overlays under the reference's
    key, the JSONL keeps its PNG's path; asked for by `use_wandb=True`, or by
    `ONDA_WANDB=1` with `use_wandb` left None (the CLI without --wandb)."""
    records = {"logs": []}
    monkeypatch.setitem(sys.modules, "wandb", _fake_wandb(records))
    monkeypatch.setenv("ONDA_WANDB", "1" if asked == "ONDA_WANDB=1" else "0")
    sample = _sample(tmp_path)
    logger = Logger(log_dir=str(tmp_path), config={"a": 1}, run_name="run7",
                    use_wandb=True if asked == "argument" else None)
    logger.log({"Total target loss": 1.5, "Condition clear sample 0": sample})
    logger.close()

    assert records["init"] == {"project": "OUDA", "config": {"a": 1}}
    assert sys.modules["wandb"].run.name == "run7"
    payload, step = records["logs"][0]
    assert step == 0
    img = payload["Condition clear sample 0"]
    assert isinstance(img, _FakeImage) and img.caption == "Sample from clear"
    assert set(img.masks) == {"predictions", "ground_truth"}
    np.testing.assert_array_equal(img.masks["predictions"]["mask_data"], sample.pred)
    assert img.masks["predictions"]["class_labels"] == {0: "road", 1: "sidewalk"}
    assert payload["Total target loss"] == 1.5
    rec = _jsonl(tmp_path)[0]
    assert rec["Condition clear sample 0"] == sample.path and rec["Total target loss"] == 1.5


def test_onda_wandb_unset_or_zero_keeps_wandb_off(tmp_path, monkeypatch):
    """use_wandb None reads ONDA_WANDB: unset or 0 starts no run."""
    records = {"logs": []}
    monkeypatch.setitem(sys.modules, "wandb", _fake_wandb(records))
    for value in (None, "0"):
        if value is None:
            monkeypatch.delenv("ONDA_WANDB", raising=False)
        else:
            monkeypatch.setenv("ONDA_WANDB", value)
        logger = Logger(log_dir=str(tmp_path))
        logger.log({"Total target loss": 2.0})
        logger.close()
    assert "init" not in records and records["logs"] == []
    assert [r["Total target loss"] for r in _jsonl(tmp_path)] == [2.0, 2.0]


@pytest.mark.parametrize("failure", ["unimportable", "init raises"])
def test_wandb_failure_falls_back_to_jsonl(tmp_path, monkeypatch, capsys, failure):
    """Asked for wandb (ONDA_WANDB=1) where the module cannot be imported or
    its run cannot start: the logger says so once and writes metrics.jsonl
    alone, as the JAX package's does, instead of stopping the run."""
    records = {"logs": []}
    monkeypatch.setenv("ONDA_WANDB", "1")
    monkeypatch.setitem(sys.modules, "wandb", None if failure == "unimportable"
                        else _fake_wandb(records, fail_init=True))
    logger = Logger(log_dir=str(tmp_path))
    logger.log({"Total target loss": 3.0, "Condition clear sample 0": _sample(tmp_path)})
    logger.close()
    assert "wandb unavailable" in capsys.readouterr().out
    assert records["logs"] == []
    rec = _jsonl(tmp_path)[0]
    assert rec["Total target loss"] == 3.0 and rec["Condition clear sample 0"].endswith(".png")
