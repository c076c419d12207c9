"""OTHERS.ASYNC_SAVE in the port (`onda_torch/utils/checkpoint.py`, the
counterpart of `onda_tpu/utils/checkpoint.py::save_state(wait=False)`), on the
CPU: the save returns once the host has a snapshot, the write goes on in a
thread, one write is in flight per path, loads and listings wait for it or
never see it half written, and a failed write is raised. Then the CLI with
OTHERS.ASYNC_SAVE against the same run without it, at each save site."""

import json
import os
import shutil
import threading
import time

import pytest
import torch

from onda_torch import registry
from onda_torch.utils import checkpoint as ckpt

from .synthetic import make_synthetic_dataset
from .test_torch_cli import PER_DOMAIN, _main, _records
from .test_torch_workflow import _workflow_cfg

TINY = (1, 1, 1, 1)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Torch on two threads in this file: the test run's workers share the
    host's cores, and one torch thread per core in each oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """The `.pt`, `.pth` and prototype pickles a test writes go when it ends;
    no write of a test outlives it."""
    yield
    try:
        ckpt.wait_for_saves()
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)


def _state(seed=0):
    """A payload shaped like the adapter's: nested dicts of tensors of several
    types, a generator state and plain values."""
    g = torch.Generator().manual_seed(seed)
    return {"params": {f"w{i}": torch.randn(256, 1024, generator=g) for i in range(4)},
            "batch_stats": {"mean": torch.randn(64, generator=g),
                            "count": torch.arange(7, dtype=torch.int64)},
            "switch": {"current": torch.tensor(1), "flags": torch.rand(5, generator=g) > 0.5},
            "generator": g.get_state(), "step": 3, "tags": ["a", ("b", 2.5)]}


def _assert_equal(got, want):
    if isinstance(want, torch.Tensor):
        # bit for bit (a prototype of a class never seen is nan)
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype
        assert got.shape == want.shape
        assert torch.equal(got.cpu().reshape(-1).view(torch.uint8),
                           want.cpu().reshape(-1).view(torch.uint8))
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_equal(a, b)
    else:
        assert got == want


def _mutate(tree):
    """Change every tensor of tree in place, as the step, the model EMA and
    the prototype EMA do right after a save."""
    for v in tree.values() if isinstance(tree, dict) else tree:
        if isinstance(v, torch.Tensor):
            if v.dtype == torch.bool:
                v.logical_not_()
            elif v.dtype == torch.uint8:
                v.add_(1)
            else:
                v.mul_(-2).add_(1)
        elif isinstance(v, (dict, list)):
            _mutate(v)


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree


@pytest.fixture
def held_writer(monkeypatch):
    """torch.save that waits until released before it serializes anything: a
    write held in flight, its temporary open. Yields (release, started, the
    real torch.save)."""
    real_save = torch.save
    release, started = threading.Event(), threading.Event()

    def held(obj, f, *args, **kwargs):
        started.set()
        assert release.wait(30), "the held write was never released"
        real_save(obj, f, *args, **kwargs)

    monkeypatch.setattr(torch, "save", held)
    return release, started, real_save


def test_async_file_equals_the_sync_one_after_in_place_changes(tmp_path, held_writer):
    release, started, _ = held_writer
    state = _state()
    before = _clone(state)
    ckpt.save_atomic(state, str(tmp_path / "async.pt"), wait=False)
    assert started.wait(30)
    _mutate(state)  # while the write is held
    assert not torch.equal(state["params"]["w0"], before["params"]["w0"])
    release.set()
    ckpt.wait_for_saves()
    got = torch.load(tmp_path / "async.pt", weights_only=False)
    _assert_equal(got, before)
    ckpt.save_atomic(before, str(tmp_path / "sync.pt"))
    _assert_equal(got, torch.load(tmp_path / "sync.pt", weights_only=False))


def test_a_sync_save_after_an_async_one_leaves_its_own_contents(tmp_path, monkeypatch):
    """JAX tests/test_step.py:138-150: the later synchronous save drains the
    async write first, so its file is the one that stays."""
    real_save = torch.save

    def slow(obj, f, *args, **kwargs):
        time.sleep(0.3)
        real_save(obj, f, *args, **kwargs)

    monkeypatch.setattr(torch, "save", slow)
    path = str(tmp_path / "adapt_state.pt")
    first, second = _state(0), _state(1)
    ckpt.save_atomic(first, path, wait=False)
    ckpt.save_atomic(second, path, wait=True)
    _assert_equal(torch.load(path, weights_only=False), second)
    ckpt.wait_for_saves()
    _assert_equal(torch.load(path, weights_only=False), second)
    assert os.listdir(tmp_path) == ["adapt_state.pt"]


def test_a_load_waits_for_the_write_in_flight(tmp_path, held_writer):
    release, started, real_save = held_writer
    path = str(tmp_path / "adapt_state.pt")
    real_save({"old": torch.zeros(3)}, path)  # the file a listing would find
    new = _state()
    ckpt.save_atomic(new, path, wait=False)
    assert started.wait(30)
    loaded = []
    reader = threading.Thread(target=lambda: loaded.append(ckpt.load(path, weights_only=False)))
    reader.start()
    reader.join(0.5)
    assert reader.is_alive() and not loaded  # held at the barrier
    release.set()
    reader.join(30)
    assert not reader.is_alive()
    _assert_equal(loaded[0], new)


def test_the_listing_never_shows_a_half_written_checkpoint(tmp_path, held_writer):
    release, started, _ = held_writer
    path = tmp_path / "adapt_state.pt"
    ckpt.save_atomic(_state(), str(path), wait=False)
    assert started.wait(30)
    hidden = [p for p in os.listdir(tmp_path) if p.startswith(".adapt_state.pt.")]
    assert len(hidden) == 1  # the temporary being written
    assert ckpt.checkpoints_by_mtime(str(tmp_path)) == []
    assert not path.exists()
    release.set()
    ckpt.wait_for_saves()
    assert ckpt.checkpoints_by_mtime(str(tmp_path)) == [path]
    assert os.listdir(tmp_path) == ["adapt_state.pt"]


@pytest.mark.parametrize("barrier", ["wait_for_saves", "next save"])
def test_a_failed_write_is_raised(tmp_path, monkeypatch, barrier):
    called = threading.Event()

    def broken(obj, f, *args, **kwargs):
        called.set()
        f.write(b"partial")
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(torch, "save", broken)
    path = str(tmp_path / "adapt_state.pt")
    ckpt.save_atomic(_state(), path, wait=False)  # returns: the write fails in its thread
    assert called.wait(30)
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="background write of .*adapt_state.pt failed") as info:
        if barrier == "wait_for_saves":
            ckpt.wait_for_saves()
        else:
            ckpt.save_atomic(_state(), path, wait=False)  # the loop's next checkpoint
    assert isinstance(info.value.__cause__, OSError)
    assert not [p for p in os.listdir(tmp_path) if "adapt_state" in p]  # no file, no temporary
    ckpt.wait_for_saves()  # raised once: nothing is left to raise


@pytest.mark.parametrize("wait", [True, False])
@pytest.mark.parametrize("umask", [0o022, 0o027])
def test_the_file_has_the_mode_a_plain_save_gives(tmp_path, wait, umask):
    old = os.umask(umask)
    try:
        torch.save({"x": torch.ones(2)}, tmp_path / "plain.pt")
        ckpt.save_atomic({"x": torch.ones(2)}, str(tmp_path / "atomic.pt"), wait=wait)
        ckpt.wait_for_saves()
    finally:
        os.umask(old)
    mode = os.stat(tmp_path / "atomic.pt").st_mode & 0o777
    assert mode == 0o666 & ~umask == os.stat(tmp_path / "plain.pt").st_mode & 0o777


# ---------------------------------------------------------------------------
# the CLI with OTHERS.ASYNC_SAVE against the same run without it
# ---------------------------------------------------------------------------

WALL_KEYS = ("_t", "Step compile+run seconds", "Adaptation frames per second")


CLI_CONFIGS = {
    # a prototype adapter, with a checkpoint after every step
    "proto_online": ("configs/hybrid_switch.yml", {"OTHERS.SAVE_EVERY": 1}),
    "advent": ("configs/advent.yml", {}),
    # one epoch of SEGMENT pretraining before its adaptation
    "segment": ("configs/training_fog.yml", {"METHOD.PRETRAIN.SEGMENT.EPOCHS": 1}),
}


@pytest.mark.parametrize("kind", ["proto_online", "advent", "segment"])
def test_async_save_run_equals_the_sync_run(tmp_path, monkeypatch, kind):
    for name in registry.LAYERS:
        monkeypatch.setitem(registry.LAYERS, name, TINY)
    root = str(tmp_path / "ds")
    if kind == "segment":
        make_synthetic_dataset(root, intensities=(0, 25), per_domain=2, size_wh=(128, 64))
        os.rename(os.path.join(root, "metadata.json"), os.path.join(root, "metadata_fog.json"))
    else:
        make_synthetic_dataset(root, intensities=(0, 25), per_domain=PER_DOMAIN, size_wh=(64, 32))
    files, records = {}, {}
    for async_save in (False, True):
        snap = str(tmp_path / f"snaps_{async_save}")
        config, over = CLI_CONFIGS[kind]
        _main(_workflow_cfg(tmp_path / f"{kind}_{async_save}.yml", config, root, snap,
                            **over, **{"OTHERS.ASYNC_SAVE": async_save}))
        assert not [f for f in os.listdir(snap) if f.startswith(".")]
        files[async_save] = {f: torch.load(os.path.join(snap, f), weights_only=False)
                             for f in os.listdir(snap) if f.endswith((".pt", ".pth"))}
        records[async_save] = json.dumps(
            [{k: v for k, v in r.items() if k not in WALL_KEYS and not k.startswith("time/")}
             for r in _records(snap)], sort_keys=True).replace(snap, "<SNAPSHOT_DIR>")
    want = {"proto_online": {"adapt_state.pt"}, "advent": {"advent_state.pt"},
            "segment": {"adapt_state.pt", "model_train_[[0]].pth"}}[kind]
    assert want <= set(files[True])
    assert set(files[True]) == set(files[False])
    for name, sync_payload in files[False].items():
        _assert_equal(files[True][name], sync_payload)
    assert records[True] == records[False]
