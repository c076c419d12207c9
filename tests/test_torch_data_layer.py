"""The rest of the port's data layer against the JAX package's: RGB-coded
label maps (`LabelMapper`, `SegmentationDataset`'s RGB path), stored soft
predictions (`predictions_dir`) and the metadata scanner with its entry point
(`python -m onda_torch.make_metadata` against `tools/make_metadata.py`).

RGB batches are held bit for bit in their labels (PIL's nearest rule, at the
flagship's 2048x1024 files to 1024x512 and 129x65, and at a non-integral
scale); their images come from the C++ prep beside the JAX package's PIL
path, byte-exact pixels whose normalisation rounds the last f32 bit
otherwise (1e-6, as tests/test_torch_data.py holds that path).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from onda_tpu.data import metadata as jax_metadata
from onda_tpu.data.loader import collate as jax_collate
from onda_tpu.data.segmentation import LabelMapper as JaxLabelMapper
from onda_tpu.data.segmentation import SegmentationDataset as JaxDataset
from onda_torch import native
from onda_torch.data import metadata
from onda_torch.data.metadata import Table, load_dataset_info
from onda_torch.data.segmentation import LabelMapper, SegmentationDataset, pil_nearest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN = np.array([123.675, 116.28, 103.53])
STD = np.array([58.395, 57.12, 57.375])


@pytest.fixture(scope="module")
def executor():
    ex = native.BatchExecutor(2)
    yield ex
    ex.close()


@pytest.fixture(scope="module")
def rgb_map():
    """Cityscapes' palette colour → train id, and one colour left unmapped."""
    return {tuple(int(v) for v in colour): i
            for i, colour in enumerate(load_dataset_info()["palette"])}


# ---------------------------------------------------------------------------
# RGB-coded label maps
# ---------------------------------------------------------------------------


def test_rgb_label_mapper_matches_jax_on_the_pinned_case():
    """tests/test_data.py::test_label_mapper_rgb's case."""
    mapping = {(10, 20, 30): 5, (0, 0, 0): 1}
    img = np.zeros((2, 2, 3), np.uint8)
    img[0, 0] = (10, 20, 30)
    got, want = LabelMapper(mapping), JaxLabelMapper(mapping)
    assert got.rgb and want.rgb
    np.testing.assert_array_equal(got(img), want(img))
    assert got(img)[0, 0] == 5 and got(img)[1, 1] == 1
    np.testing.assert_array_equal(got.lut, want.lut)


def test_rgb_label_mapper_matches_jax_on_random_keys():
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 256, size=(200, 3))
    mapping = {tuple(int(v) for v in k): int(i) for k, i in zip(keys, rng.integers(0, 19, 200))}
    got, want = LabelMapper(mapping), JaxLabelMapper(mapping)
    np.testing.assert_array_equal(got.lut, want.lut)
    img = np.concatenate([keys, rng.integers(0, 256, size=(56, 3))]).astype(np.uint8)
    img = img.reshape(16, 16, 3)
    np.testing.assert_array_equal(got(img), want(img))


@pytest.mark.parametrize("n_in,n_out", [(2048, 1024), (1024, 129), (100, 64), (60, 40), (7, 9),
                                        (1024, 65), (33, 33)])
def test_pil_nearest_matches_pil(n_in, n_out):
    rng = np.random.default_rng(n_in + n_out)
    a = rng.integers(0, 256, size=(n_in, 5, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(a).resize((5, n_out), Image.NEAREST))
    np.testing.assert_array_equal(pil_nearest(a, (n_out, 5)), want)


def _rgb_tree(root, file_wh, rgb_map, n=2):
    """n frames of file_wh with RGB-coded labels (palette colours and some
    colours no class has), and a table of them in both packages' forms."""
    rng = np.random.default_rng(file_wh[0])
    colours = np.array(list(rgb_map) + [(1, 2, 3), (250, 0, 250)], np.uint8)
    rows = []
    w, h = file_wh
    for i in range(n):
        img_rel, lbl_rel = f"img/{i}_leftImg8bit.png", f"lbl/{i}_gtFine_color.png"
        for rel in (img_rel, lbl_rel):
            os.makedirs(os.path.join(root, os.path.dirname(rel)), exist_ok=True)
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8), "RGB").save(
            os.path.join(root, img_rel))
        Image.fromarray(colours[rng.integers(0, len(colours), (h, w))], "RGB").save(
            os.path.join(root, lbl_rel))
        rows.append({"image_path": img_rel, "label_path": lbl_rel, "set": "train",
                     "intensity": 0})
    return Table(rows, list(rows[0])), pd.DataFrame(rows)


@pytest.mark.parametrize("file_wh,size_wh", [((2048, 1024), (1024, 512)), ((100, 60), (64, 40))],
                         ids=["flagship", "non-integral"])
def test_rgb_batch_matches_jax(tmp_path, rgb_map, executor, file_wh, size_wh):
    table, frame = _rgb_tree(str(tmp_path), file_wh, rgb_map)
    jds = JaxDataset(str(tmp_path), frame, rgb_map, size_wh, MEAN, STD, original_label=True)
    tds = SegmentationDataset(str(tmp_path), table, rgb_map, size_wh, MEAN, STD,
                              original_label=True, executor=executor)
    want = jax_collate([jds[i] for i in range(len(frame))])
    got = tds.prepare_batch(range(len(table)))
    for key in ("label", "label_res", "label_raw"):
        assert got[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["label_res"].shape[1:] == tuple(x // 8 + 1 for x in size_wh[::-1])
    assert (got["label"] == 0).any() and (got["label"] == 18).any()
    np.testing.assert_allclose(got["image"], want["image"].transpose(0, 3, 1, 2), rtol=0,
                               atol=1e-6)


def test_soft_predictions_match_jax(tmp_path, rgb_map, executor):
    """`predictions_dir`: every row's soft_path, and its stored array where
    it exists; a batch with the file for some rows only raises in both."""
    table, frame = _rgb_tree(str(tmp_path / "ds"), (32, 16), rgb_map, n=3)
    preds = tmp_path / "preds"
    rng = np.random.default_rng(0)
    for row in table.rows[:2]:
        path = preds / row["image_path"].replace(".png", "_soft.npy")
        path.parent.mkdir(parents=True, exist_ok=True)
        np.save(path, rng.random((19, 3, 5)).astype(np.float32))
    kw = dict(predictions_dir=str(preds))
    jds = JaxDataset(str(tmp_path / "ds"), frame, rgb_map, (32, 16), MEAN, STD, **kw)
    tds = SegmentationDataset(str(tmp_path / "ds"), table, rgb_map, (32, 16), MEAN, STD,
                              executor=executor, **kw)
    for i in range(3):
        want, got = jds[i], tds[i]
        assert set(got) == set(want), i
        assert got["soft_path"] == want["soft_path"]
        if "soft_predictions" in want:
            np.testing.assert_array_equal(got["soft_predictions"], want["soft_predictions"])
    batch = tds.prepare_batch([0, 1])
    np.testing.assert_array_equal(batch["soft_predictions"],
                                  jax_collate([jds[0], jds[1]])["soft_predictions"])
    with pytest.raises(ValueError, match="inconsistent batch"):
        jax_collate([jds[1], jds[2]])
    with pytest.raises(ValueError, match="inconsistent batch"):
        tds.prepare_batch([1, 2])


# ---------------------------------------------------------------------------
# the metadata scanner
# ---------------------------------------------------------------------------


def _weather_tree(root):
    """An empty-file weather-Cityscapes layout: clear, rain 25/50 mm and fog
    750/150 m frames in train and val, two cities, some frames unlabeled,
    and entries the scanner must skip."""
    files = []
    for set_ in ("train", "val"):
        for domain in ("clear", "rain/25mm", "rain/50mm", "fog/750m", "fog/150m"):
            for city in ("bonn", "aachen"):
                for i in range(2):
                    files.append(f"leftImg8bit/{set_}/{domain}/{city}/"
                                 f"{city}_{i:06d}_leftImg8bit.png")
        for city in ("bonn", "aachen"):
            files.append(f"gtFine/{set_}/{city}/{city}_000000_gtFine_labelIds.png")
    files += ["leftImg8bit/train/rain/heavy/x/x_leftImg8bit.png",
              "leftImg8bit/train/snow/bonn/bonn_000000_leftImg8bit.png",
              "leftImg8bit/train/clear/bonn/notes.txt"]
    for rel in files:
        os.makedirs(os.path.join(root, os.path.dirname(rel)), exist_ok=True)
        open(os.path.join(root, rel), "w").close()


@pytest.mark.parametrize("require_labels", [True, False])
@pytest.mark.parametrize("kind", ["rain", "fog"])
def test_scanner_matches_jax(tmp_path, kind, require_labels):
    _weather_tree(str(tmp_path))
    want = jax_metadata.scan_weather_cityscapes(str(tmp_path), kind, require_labels)
    got = metadata.scan_weather_cityscapes(str(tmp_path), kind, require_labels)
    assert got.columns == list(want.columns)
    # pandas holds the missing label paths as NaN
    records = [{k: None if isinstance(v, float) and np.isnan(v) else v for k, v in r.items()}
               for r in want.to_dict("records")]
    assert got.rows == records and len(got) > 0
    assert any(r["label_path"] is None for r in got.rows) == (not require_labels)
    got.to_json(str(tmp_path / "port.json"))
    jax_metadata.save_table(want, str(tmp_path / "jax.json"))
    pd.testing.assert_frame_equal(pd.read_json(tmp_path / "port.json"),
                                  pd.read_json(tmp_path / "jax.json"))


def test_make_metadata_entry_point_matches_the_jax_tool(tmp_path):
    """Both write their default file, and pandas reads back the same frame;
    both print the same row count and counts by (set, intensity)."""
    _weather_tree(str(tmp_path / "tree"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    outs = {}
    for name, cmd in (("port", [sys.executable, "-m", "onda_torch.make_metadata"]),
                      ("jax", [sys.executable, "tools/make_metadata.py"])):
        out_path = str(tmp_path / f"{name}.json")
        run = subprocess.run(cmd + ["--root", str(tmp_path / "tree"), "--kind", "fog",
                                    "--allow-unlabeled", "--out", out_path],
                             cwd=ROOT, capture_output=True, text=True, env=env, timeout=120)
        assert run.returncode == 0, run.stderr
        outs[name] = run.stdout.splitlines()
        assert outs[name][0] == f"wrote 24 rows to {out_path}"
    pd.testing.assert_frame_equal(pd.read_json(tmp_path / "port.json"),
                                  pd.read_json(tmp_path / "jax.json"))

    def counts(lines):
        """{(set, intensity): rows} of the printed table (pandas leaves a
        set's name blank on its later rows)."""
        out, set_ = {}, None
        for line in lines[2:]:
            words = line.split()
            if len(words) == 3 and words[0] in ("train", "val"):
                set_, words = words[0], words[1:]
            if len(words) == 2 and all(w.isdigit() for w in words) and set_:
                out[(set_, int(words[0]))] = int(words[1])
        return out

    assert counts(outs["port"]) == counts(outs["jax"])
    assert sum(counts(outs["port"]).values()) == 24
    default = subprocess.run([sys.executable, "-m", "onda_torch.make_metadata", "--root",
                              str(tmp_path / "tree")], cwd=ROOT, capture_output=True, text=True,
                             env=env, timeout=120)
    assert default.returncode == 0, default.stderr
    assert json.load(open(tmp_path / "tree" / "metadata.json"))["set"]
