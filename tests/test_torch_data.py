"""The port's data layer (`onda_torch/data`, `onda_torch/native`,
`onda_torch/utils`) against the JAX package's on the same synthetic datasets
(`tests/synthetic.py`): splits, buffer rows, prepared batches, loader order,
replay-buffer draws, buffer insertions and sample rendering."""

import os
import struct
import types
import zlib

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

import jax.numpy as jnp
from onda_tpu.config import cfg_from_file as jax_cfg_from_file
from onda_tpu.data import Loader as JaxLoader
from onda_tpu.data import ReplayBuffer as JaxReplayBuffer
from onda_tpu.data import SegmentationDataset as JaxDataset
from onda_tpu.methods.proto_online import ProtoOnlineAdapter as JaxAdapter
from onda_tpu.registry import get_db as jax_get_db
from onda_tpu.utils import viz as jax_viz
from onda_torch import native
from onda_torch.config import cfg_from_file
from onda_torch.data import LabelMapper, Loader, ReplayBuffer, SegmentationDataset
from onda_torch.data import loader as loader_mod
from onda_torch.data.loader import DeviceFeeder
from onda_torch.data.metadata import Table, load_dataset_info, load_table
from onda_torch.methods.proto_online import ProtoOnlineAdapter
from onda_torch.registry import get_db
from onda_torch.utils import viz
from onda_torch.utils.checkpoint import checkpoints_by_mtime, save_atomic
from onda_torch.utils.logging_ import Logger
from onda_torch.utils.spans import SpanRecorder

from .synthetic import make_synthetic_dataset

SIZE_WH = (64, 32)
MEAN = np.array([123.675, 116.28, 103.53])
STD = np.array([58.395, 57.12, 57.375])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("weather_cs"))
    make_synthetic_dataset(path, intensities=(0, 25, 50), per_domain=5, size_wh=SIZE_WH)
    return path


@pytest.fixture(scope="module")
def label2train():
    return dict(tuple(p) for p in load_dataset_info()["label2train"])


@pytest.fixture(scope="module")
def executor():
    ex = native.BatchExecutor(2)
    yield ex
    ex.close()


def _cfgs(root):
    out = []
    for load in (jax_cfg_from_file, cfg_from_file):
        cfg = load("configs/hybrid_switch.yml")
        cfg.SCHEME.PATH = root + "/"
        cfg.SCHEME.DOMAIN_ORDER = [[25], [50]]
        out.append(cfg)
    return out


# ---------------------------------------------------------------------------
# metadata, splits, buffer rows
# ---------------------------------------------------------------------------


def test_get_db_splits_match_jax(root):
    jcfg, tcfg = _cfgs(root)
    jdb, tdb = jax_get_db(jcfg), get_db(tcfg)
    assert tdb["db_info"]["label2train"] == jdb["db_info"]["label2train"]
    for group in ("domains_src", "domains_trg"):
        assert len(tdb[group]) == len(jdb[group])
        for jdom, tdom in zip(jdb[group], tdb[group]):
            for bucket in ("train", "val"):
                assert list(tdom[bucket]) == list(jdom[bucket])
                for set_, frame in jdom[bucket].items():
                    got = tdom[bucket][set_]
                    assert got.column("image_path") == list(frame["image_path"])
                    assert got.column("label_path") == list(frame["label_path"])


def test_load_table_keeps_pandas_row_order_and_nulls(tmp_path):
    # index labels out of order (a sampled table) and a null label_path:
    # "10" must not sort before "2", and null reads back as None
    df = pd.DataFrame({"image_path": ["a.png", "b.png", "c.png"],
                       "label_path": ["a_l.png", None, "c_l.png"],
                       "set": ["train", "val", "train"], "intensity": [0, 25, 0]},
                      index=[10, 2, 7])
    path = str(tmp_path / "meta.json")
    df.to_json(path)
    table = load_table(path)
    back = pd.read_json(path)
    assert table.column("image_path") == list(back["image_path"])
    assert table.column("label_path") == ["a_l.png", None, "c_l.png"]
    assert table.column("intensity") == list(back["intensity"])


def test_table_to_json_reads_back_in_pandas(tmp_path):
    rows = [{"image_path": f"f{i}.png", "label_path": None if i == 3 else f"l{i}.png",
             "set": "train", "intensity": 25} for i in range(12)]
    path = str(tmp_path / "meta.json")
    Table(rows, ["image_path", "label_path", "set", "intensity"]).to_json(path)
    back = pd.read_json(path)
    assert list(back["image_path"]) == [r["image_path"] for r in rows]
    assert load_table(path).rows == rows


@pytest.mark.parametrize("draw", [{"frac": 0.5}, {"frac": 0.3}, {"frac": 1.0}, {"n": 3},
                                  {"n": 15}], ids=str)
def test_buffer_rows_match_pandas_sample(root, draw):
    jcfg, tcfg = _cfgs(root)
    jframe = pd.concat([next(iter(d["train"].values())) for d in jax_get_db(jcfg)["domains_src"]])
    ttable = Table.concat(next(iter(d["train"].values())) for d in get_db(tcfg)["domains_src"])
    if "n" in draw:
        draw = {"n": min(draw["n"], len(jframe))}
    want = jframe.sample(random_state=123, **draw)
    got = ttable.sample(random_state=123, **draw)
    assert got.column("image_path") == list(want["image_path"])


# ---------------------------------------------------------------------------
# the C++ prep: PNG decoding, prepared batches, failures
# ---------------------------------------------------------------------------


def _png(path, raw, w, h, depth, color, palette=None):
    """A PNG with filter-0 rows of raw bytes, for formats PIL does not write."""
    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    rowbytes = len(raw) // h
    body = b"".join(b"\x00" + raw[y * rowbytes:(y + 1) * rowbytes] for y in range(h))
    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
    if palette is not None:
        data += chunk(b"PLTE", bytes(palette))
    data += chunk(b"IDAT", zlib.compress(body)) + chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)
    return str(path)


def _smooth(rng, h, w, c):
    y, x = np.mgrid[0:h, 0:w]
    base = 120 + 60 * np.sin(x / 7.0)[..., None] * np.cos(y / 5.0)[..., None] * np.ones(c)
    return np.clip(base + rng.normal(0, 3, (h, w, c)), 0, 255).astype(np.uint8)


PIL_MODES = ["RGB-noise", "RGB-smooth", "RGBA", "L", "LA", "P", "P4", "1"]


@pytest.mark.parametrize("mode", PIL_MODES)
def test_decode_png_matches_pil(tmp_path, mode):
    # PIL writes each row with the filter that suits it best, so noise and
    # smooth content between them exercise every filter type
    rng = np.random.default_rng(PIL_MODES.index(mode))
    h, w = 23, 37
    if mode == "RGB-noise":
        img = Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), "RGB")
    elif mode in ("RGB-smooth", "RGBA", "LA"):
        img = Image.fromarray(_smooth(rng, h, w, 3), "RGB")
        img = img if mode == "RGB-smooth" else img.convert(mode)
    elif mode == "L":
        img = Image.fromarray(_smooth(rng, h, w, 1)[..., 0], "L")
    elif mode in ("P", "P4"):
        img = Image.fromarray(rng.integers(0, 16 if mode == "P4" else 200, (h, w), dtype=np.uint8), "P")
        img.putpalette(rng.integers(0, 256, 768, dtype=np.uint8).tolist())
    else:
        img = Image.fromarray(rng.integers(0, 2, (h, w), dtype=np.uint8) * 255, "L").convert("1")
    path = str(tmp_path / "x.png")
    img.save(path, bits=4) if mode == "P4" else img.save(path)
    np.testing.assert_array_equal(native.decode_png(path, rgb=True),
                                  np.asarray(Image.open(path).convert("RGB")))
    if mode in ("L", "P", "P4"):
        np.testing.assert_array_equal(native.decode_png(path, rgb=False), np.asarray(Image.open(path)))


@pytest.mark.parametrize("depth,color", [(16, 2), (16, 6), (2, 0), (4, 0), (2, 3)], ids=str)
def test_decode_png_other_depths(tmp_path, depth, color):
    rng = np.random.default_rng(depth * 10 + color)
    h, w = 9, 13
    channels = {0: 1, 2: 3, 3: 1, 6: 4}[color]
    if depth == 16:
        values = rng.integers(0, 65536, (h, w, channels)).astype(">u2")
        raw, want = values.tobytes(), (values >> 8).astype(np.uint8)[..., :3]
    else:
        values = rng.integers(0, 1 << depth, (h, w), dtype=np.uint8)
        per = 8 // depth
        padded = np.zeros((h, -(-w // per) * per), np.uint8)
        padded[:, :w] = values
        packed = sum(padded[:, k::per] << (8 - depth * (k + 1)) for k in range(per)).astype(np.uint8)
        raw = packed.tobytes()
        if color == 0:
            want = np.repeat((values.astype(int) * 255 // ((1 << depth) - 1)).astype(np.uint8)[..., None], 3, 2)
        else:
            palette = rng.integers(0, 256, 3 << depth, dtype=np.uint8)
            want = palette.reshape(-1, 3)[values]
    path = _png(tmp_path / "x.png", raw, w, h, depth, color,
                palette=palette if color == 3 else None)
    got = native.decode_png(path, rgb=True)
    np.testing.assert_array_equal(got, want)
    if depth == 16 and color == 2:  # PIL reads 16-bit RGB as its high bytes too
        np.testing.assert_array_equal(got, np.asarray(Image.open(path).convert("RGB")))


def test_decode_png_refuses_bad_files(tmp_path):
    interlaced = tmp_path / "interlaced.png"
    path = _png(tmp_path / "plain.png", bytes(12), 4, 1, 8, 2)
    data = bytearray(open(path, "rb").read())
    data[28] = 1  # IHDR interlace method: Adam7 (CRC left stale: it is not checked)
    interlaced.write_bytes(bytes(data))
    with pytest.raises(RuntimeError, match="unsupported PNG"):
        native.decode_png(str(interlaced), rgb=True)
    truncated = tmp_path / "truncated.png"
    truncated.write_bytes(bytes(data[:40]))
    with pytest.raises(RuntimeError):
        native.decode_png(str(truncated), rgb=True)
    with pytest.raises(RuntimeError, match="cannot open"):
        native.decode_png(str(tmp_path / "missing.png"), rgb=True)


def _datasets(root, label2train, executor, size_wh):
    table = load_table(os.path.join(root, "metadata.json"))
    frame = pd.read_json(os.path.join(root, "metadata.json"))
    jds = JaxDataset(root, frame, label2train, size_wh, mean=MEAN, std=STD)
    tds = SegmentationDataset(root, table, label2train, size_wh, mean=MEAN, std=STD,
                              executor=executor)
    return jds, tds


@pytest.mark.parametrize("size_wh", [(40, 24), (64, 32), (96, 56)], ids=str)
def test_prepared_batch_matches_jax_native_exactly(root, label2train, executor, size_wh):
    jds, tds = _datasets(root, label2train, executor, size_wh)
    rows = [0, 7, 3, 12]
    want = jds.prepare_batch(rows)
    got = tds.prepare_batch(rows)
    assert want is not None, "the JAX package's native prep did not run"
    np.testing.assert_array_equal(got["image"], want["image"].transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(got["label"], want["label"])
    np.testing.assert_array_equal(got["label_res"], want["label_res"])
    assert got["image_path"] == want["image_path"] and got["label_path"] == want["label_path"]
    assert got["image"].dtype == np.float32 and got["label"].dtype == np.int32


@pytest.mark.parametrize("size_wh", [(40, 24), (96, 56), (32, 16)], ids=str)
def test_prepared_samples_match_jax_pil_path(root, label2train, executor, size_wh, monkeypatch):
    monkeypatch.setenv("ONDA_NATIVE", "0")  # the JAX package's PIL path
    jds, tds = _datasets(root, label2train, executor, size_wh)
    for i in (0, 9):
        want, got = jds[i], tds[i]
        # byte-exact pixels; the normalize rounds differently in the last f32 bit
        np.testing.assert_allclose(got["image"], want["image"].transpose(2, 0, 1), rtol=0, atol=1e-6)
        if SIZE_WH[0] % size_wh[0] == 0:
            # PIL's NEAREST steps through a fixed-point affine map, which picks
            # another source pixel than floor((x + 0.5) * scale) where that
            # product lands on an integer: at scales like 64 -> 40 the JAX
            # package's native prep (and its copy here) differ from PIL there
            np.testing.assert_array_equal(got["label"], want["label"])
            np.testing.assert_array_equal(got["label_res"], want["label_res"])


def test_label_prep_matches_pil_at_cityscapes_size(tmp_path, label2train):
    # the flagship's label sizes: 2048x1024 files to 1024x512 and 129x65
    rng = np.random.default_rng(4)
    raw = rng.integers(0, 34, (1024, 2048), dtype=np.uint8)
    path = str(tmp_path / "l.png")
    Image.fromarray(raw, "L").save(path)
    lut = LabelMapper(label2train).lut
    ex = native.BatchExecutor(1)
    for w, h in ((1024, 512), (129, 65)):
        full, res = np.empty((1, h, w), np.int32), np.empty((1, h, w), np.int32)
        ex.wait(ex.submit_labels([path], (h, w), (h, w), lut, full, res), [path])
        want = lut[np.asarray(Image.fromarray(raw).resize((w, h), Image.NEAREST))]
        np.testing.assert_array_equal(full[0], want)
        np.testing.assert_array_equal(res[0], want)
    ex.close()


def test_prepare_batch_names_the_file_it_cannot_read(root, label2train, executor, tmp_path):
    table = load_table(os.path.join(root, "metadata.json"))
    rows = [dict(r) for r in table.rows[:3]]
    rows[1]["image_path"] = "leftImg8bit/train/missing_leftImg8bit.png"
    ds = SegmentationDataset(root, Table(rows, table.columns), label2train, SIZE_WH, mean=MEAN,
                             std=STD, executor=executor)
    with pytest.raises(RuntimeError, match="missing_leftImg8bit.png: cannot open"):
        ds.prepare_batch([0, 1, 2])


EXIT_WHILE_WAITING = """
import sys, threading, time
import numpy as np
sys.path.insert(0, sys.argv[1])
from onda_torch.native import BatchExecutor
paths = sys.argv[2:]
ex = BatchExecutor(1)
dst = np.empty((len(paths), 3, 256, 512), np.float32)
def wait():
    job = ex.submit_images(paths, (256, 512), np.zeros(3), np.ones(3), dst)
    try:
        ex.wait(job, paths)
    except RuntimeError as exc:
        assert "stopped" in str(exc)
threading.Thread(target=wait, daemon=True).start()
time.sleep(0.1)
"""


def test_process_exits_while_a_thread_waits_on_a_prep_job(tmp_path):
    """A loader's daemon thread still waits on a batch when the process
    exits (a rank whose run ends right after its loaders started): the
    executor's finalizer wakes it and the process ends, where it used to
    hang in the condition variable's destruction."""
    import subprocess
    import sys

    data = str(tmp_path / "ds")
    make_synthetic_dataset(data, intensities=(0,), per_domain=4, size_wh=(1024, 512))
    paths = [os.path.join(data, p) for p in load_table(
        os.path.join(data, "metadata.json")).column("image_path")] * 16
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    done = subprocess.run([sys.executable, "-c", EXIT_WHILE_WAITING, root, *paths],
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr[-2000:]


def test_native_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    broken = tmp_path / "broken.cpp"
    broken.write_text("int f() { return undeclared_name; }\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="undeclared_name"):
        native.build()
    assert not any((tmp_path / "build").iterdir())  # no half-written library left behind


def test_loader_counts_executor_batches(root, label2train, executor):
    _, tds = _datasets(root, label2train, executor, SIZE_WH)
    loader_mod.reset_batches()
    batches = list(Loader(tds, batch_size=4, num_threads=2))  # 30 rows
    assert len(batches) == 8 and batches[-1]["image"].shape == (2, 3, 32, 64)
    assert dict(loader_mod.BATCHES) == {"executor": 8}


# ---------------------------------------------------------------------------
# loader, feeder, replay buffer
# ---------------------------------------------------------------------------


class _Samples:
    """A map-style dataset of small seeded samples."""

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise OSError(f"sample {i} is unreadable")
        rng = np.random.default_rng(i)
        return {"image": rng.normal(size=(3, 2, 2)).astype(np.float32),
                "label_res": rng.integers(0, 19, (2, 2)).astype(np.uint8), "name": f"s{i}"}


@pytest.mark.parametrize("opts", [dict(shuffle=False), dict(shuffle=True),
                                  dict(shuffle=True, drop_last=True),
                                  dict(shuffle=False, pad_last=True)], ids=str)
def test_loader_order_matches_jax(opts):
    ds = _Samples(11)
    jl, tl =JaxLoader(ds, 4, seed=5, num_threads=3, **opts), Loader(ds, 4, seed=5, num_threads=3, **opts)
    for _ in range(2):  # two epochs: the shuffle moves on
        want, got = list(jl), list(tl)
        assert [b["name"] for b in got] == [b["name"] for b in want]
        assert [b["valid"] for b in got] == [b["valid"] for b in want]
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g["image"], w["image"])
            np.testing.assert_array_equal(g["label_res"], w["label_res"])
    assert len(tl) == len(jl)


def test_loader_hands_worker_errors_to_the_consumer():
    with pytest.raises(OSError, match="sample 6 is unreadable"):
        list(Loader(_Samples(12, fail_at=6), batch_size=4, num_threads=2))


@pytest.mark.parametrize("ahead", [True, False])
def test_device_feeder_on_cpu(ahead):
    batches = [{"image": np.full((2, 3, 2, 2), i, np.float32), "name": [i]} for i in range(3)]
    fed = list(DeviceFeeder(iter(batches), "cpu", keys=("image",), ahead=ahead))
    assert [b["name"] for b in fed] == [[0], [1], [2]]
    assert all(isinstance(b["image"], torch.Tensor) and b["image"][0, 0, 0, 0] == i
               for i, b in enumerate(fed))


def test_replay_buffer_draws_and_evictions_match_jax():
    ds = _Samples(7)
    jb, tb = JaxReplayBuffer(ds, 3, seed=11), ReplayBuffer(ds, 3, seed=11)
    assert len(tb) == len(jb) and set(tb.keys) == set(jb.keys)
    assert [s["name"] for s in tb.buffer] == [s["name"] for s in jb.buffer]
    for step in range(8):
        want, got = next(jb), next(tb)
        assert got["name"] == want["name"]
        np.testing.assert_array_equal(got["stored_predictions"], want["stored_predictions"])
        np.testing.assert_array_equal(got["image"], want["image"])
        if step % 3 == 0:  # a queue insertion, then a random eviction
            new = {k: [v] if isinstance(v, str) else np.asarray(v)[None]
                   for k, v in ds[step].items()}
            new["name"] = [f"t{step}"]
            new["stored_predictions"] = new["label_res"]
            for buf in (jb, tb):
                buf.add_from_batch(new, 0)
                buf.add(dict(buf.buffer[0], name=f"r{step}"), policy="random")
    assert [s["name"] for s in tb.buffer] == [s["name"] for s in jb.buffer]
    assert [s["domain"] for s in tb.buffer] == [s["domain"] for s in jb.buffer]
    assert [b["name"] for b in tb.sequential()] == [b["name"] for b in jb.sequential()]


class _Recorder:
    """Stands in for a replay buffer: records what add_from_batch receives."""

    def __init__(self):
        self.keys = ("image", "image_path", "label", "label_res", "stored_predictions", "domain")
        self.added = []

    def add_from_batch(self, batch, index):
        self.added.append({k: batch[k][index] for k in self.keys if k != "domain"})


def test_buffer_update_stores_the_same_labels_as_jax():
    rng = np.random.default_rng(3)
    b, c, hh, ww, h, w = 4, 19, 9, 17, 64, 128
    soft = rng.dirichlet(np.ones(c), size=(b, hh, ww)).astype(np.float32)  # NHWC
    image = rng.normal(size=(b, h, w, 3)).astype(np.float32)
    paths = [f"f{i}.png" for i in range(b)]
    me = types.SimpleNamespace(resolution_hw=(h, w), spans=SpanRecorder("cpu"))
    jrec, trec = _Recorder(), _Recorder()
    n_j = JaxAdapter._buffer_update(me, {"image": jnp.asarray(image), "image_path": paths},
                                    jnp.asarray(soft), 0.6, jrec, np.random.default_rng(123))
    n_t = ProtoOnlineAdapter._buffer_update(
        me, {"image": torch.tensor(image.transpose(0, 3, 1, 2)), "image_path": paths},
        torch.tensor(soft.transpose(0, 3, 1, 2)), 0.6, trec, np.random.default_rng(123))
    assert n_t == n_j == len(jrec.added) == len(trec.added) > 0
    for want, got in zip(jrec.added, trec.added):
        assert got["image_path"] == want["image_path"]
        np.testing.assert_array_equal(got["image"], want["image"].transpose(2, 0, 1))
        # the argmax of the same bilinear upsample: a class may flip only
        # where two are within f32 rounding of each other
        assert (got["label"] == want["label"]).mean() >= 0.9999
        np.testing.assert_array_equal(got["label_res"], want["label_res"])
        np.testing.assert_array_equal(got["stored_predictions"], want["stored_predictions"])


# ---------------------------------------------------------------------------
# rendering, checkpoints, logger
# ---------------------------------------------------------------------------


def test_denormalize_and_colorize_match_jax():
    rng = np.random.default_rng(0)
    image = rng.normal(size=(12, 20, 3)).astype(np.float32)
    np.testing.assert_array_equal(viz.denormalize_rgb(image.transpose(2, 0, 1), MEAN, STD),
                                  jax_viz.denormalize_rgb(image, MEAN, STD))
    mask = rng.integers(0, 19, (12, 20))
    mask[0, :5] = 255
    palette = load_dataset_info()["palette"]
    np.testing.assert_array_equal(viz.colorize_mask(mask, palette), jax_viz.colorize_mask(mask, palette))


@pytest.mark.parametrize("shape", [(13, 21, 3), (13, 21)], ids=str)
def test_write_png_reads_back_in_pil_and_native(tmp_path, shape):
    array = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    path = viz.write_png(str(tmp_path / "sub" / "x.png"), array)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), array)
    np.testing.assert_array_equal(native.decode_png(path, rgb=len(shape) == 3), array)


def test_save_sample_matches_jax_rendering(tmp_path):
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 256, (10, 16, 3), dtype=np.uint8)
    pred, label = rng.integers(0, 19, (10, 16)), rng.integers(0, 19, (10, 16))
    palette = load_dataset_info()["palette"]
    got = viz.save_sample(rgb, pred, label, palette, str(tmp_path / "t.png"))
    want = jax_viz.save_sample(rgb, pred, label, palette, str(tmp_path / "j.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(got)), np.asarray(Image.open(want)))


def test_checkpoints_are_atomic_and_listed_newest_last(tmp_path):
    for i, name in enumerate(["adapt_state.pt", "model_train_[[0]]_after_src_training.pth",
                              "adapt_state_old.pt"]):
        save_atomic({"i": i}, str(tmp_path / name))
        os.utime(tmp_path / name, (100 - i, 100 - i))
    (tmp_path / ".adapt_state.pt.abc.tmp").write_bytes(b"partial")
    (tmp_path / "proto_current.pickle").write_bytes(b"")
    # AUTO_RESUME lists the full-state snapshots only, EVALUATION the .pth too
    assert [p.name for p in checkpoints_by_mtime(str(tmp_path), allow_pth=False)] == [
        "adapt_state_old.pt", "adapt_state.pt"]
    assert [p.name for p in checkpoints_by_mtime(str(tmp_path))] == [
        "adapt_state_old.pt", "model_train_[[0]]_after_src_training.pth", "adapt_state.pt"]
    assert torch.load(tmp_path / "adapt_state.pt")["i"] == 0


def test_logger_writes_the_jax_record_layout(tmp_path):
    sample = viz.MaskSample(np.zeros((2, 2, 3), np.uint8), np.zeros((2, 2)), None, {0: "road"},
                            "c", str(tmp_path / "s.png"))
    log = Logger(log_dir=str(tmp_path))
    log.log({"Total target loss": torch.tensor(1.5), "Condition (0,) sample 0": sample,
             "text": "ignored"})
    log.log({"Val mIoU model of (0,)": 0.25})
    log.close()
    import json

    records = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["_step"] for r in records] == [0, 1]
    assert records[0]["Total target loss"] == 1.5
    assert records[0]["Condition (0,) sample 0"] == str(tmp_path / "s.png")
    assert "text" not in records[0] and "_t" in records[1]


@pytest.mark.parametrize("intervals,ms", [([], 0.0), ([(0, 10), (5, 20), (30, 40), (35, 36)], 0.03),
                                          ([(5, 9), (0, 100)], 0.1)], ids=str)
def test_profile_busy_time_is_the_union_of_kernel_intervals(intervals, ms):
    from onda_torch.methods.proto_online import _union_ms

    assert _union_ms(intervals) == pytest.approx(ms)
