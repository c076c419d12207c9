"""The port's span recorder (`onda_torch/utils/spans.py`): off it is the
shared null context and records nothing; its OTHERS.SCHEDULE `time/*` keys
are the interval averages of the stage meter it replaced; the prototype and
adversarial loops record their phases, their steps' stages and their host
reads under OTHERS.SCHEDULE, and no span, `record_function` or CUDA event
without it; the benchmark's five readers of it (`benchmark/metrics/`) keep
the traced window's steps, take their median and read nothing where there
is no span. Tiny R50 (one block a stage), b1 at 32x64."""

import importlib.util
import shutil
from collections import deque
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from onda_torch import registry
from onda_torch.config import cfg_from_file
from onda_torch.utils import spans as timing
from onda_torch.utils.spans import NULL, SpanRecorder

ROOT = Path(__file__).resolve().parents[1]
B, H, W, C = 1, 32, 64, 19
LOOP = ("step", "fetch", "dispatch", "host_work", "log_sync", "log")
# the stages and their parents: hybrid and ADVENT
STAGES = {"hybrid": {"teachers": "dispatch", "ema_forward": "teachers",
                     "static_forward": "teachers", "gate": "teachers",
                     "k1_prototypes": "teachers", "student": "dispatch", "update": "dispatch"},
          "advent": {"student": "dispatch", "update": "dispatch"}}
# the host reads a step and where they sit: the gate's decision, the packed logs
READS = {"hybrid": ["gate", "log_sync"], "advent": ["log_sync"]}
SITES = {"gate": "sync.gate", "log_sync": "sync.logs"}  # their labels on the profiler's clock
READERS = ("teachers_ms", "student_ms", "update_ms", "dispatch_ms", "host_reads")


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Torch on two threads in this file: the test run's workers share the
    host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_spans_off_are_the_shared_null_context():
    spans = SpanRecorder("cpu")
    assert spans.step(0) is NULL and spans.span("teachers", device=True) is NULL
    with spans.step(0):
        spans.phase("fetch")
        assert spans.sync("gate") is NULL and spans.span("x") is NULL
    assert spans.steps() == [] and spans.reads() == 0 and spans.loop_logs() == {"host reads": 0}
    on = SpanRecorder("cpu", enabled=True)
    assert on.span("teachers") is NULL  # outside a step nothing is recorded
    assert on.steps() == []


def test_loop_keys_average_as_the_stage_meter_did(monkeypatch):
    """With the clock patched to fixed readings, each `time/*` key is what
    the stage meter that the recorder replaced gave for the same marks: a
    reset at the loop's top, a mark at each stage's end, the mean of each
    stage's last 20 intervals."""
    readings = iter(np.cumsum(np.random.default_rng(0).integers(1, 1000, 400)).tolist())
    emitted = []

    def clock():
        emitted.append(next(readings))
        return emitted[-1]

    class StageMeter:
        def __init__(self):
            self.windows, self.last = {}, None

        def mark(self, stage, now):
            self.windows.setdefault(stage, deque(maxlen=20)).append(now - self.last)
            self.last = now

        def averages(self):
            return {f"time/{k}": sum(v) / len(v) for k, v in self.windows.items()}

    monkeypatch.setattr(timing.time, "perf_counter", clock)
    spans, meter = SpanRecorder("cpu", enabled=True), StageMeter()
    for i in range(25):
        with spans.step(i):
            spans.phase("fetch")
            meter.last = emitted[-1]
            for phase, stage in (("dispatch", "Batch Fetch"), ("host_work", "Step Dispatch"),
                                 ("log_sync", "Host Work"), ("log", "Log Sync")):
                spans.phase(phase)
                meter.mark(stage, emitted[-1])
            assert spans.loop_logs() == {**meter.averages(), "host reads": 0}


class FakeEvent:
    made = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made.append(self)

    def record(self, stream=None):
        pass

    def query(self):
        return True

    def elapsed_time(self, end):
        return 2.5


class Annotation:
    """`record_function`, counted."""
    names = []

    def __init__(self, name):
        Annotation.names.append(name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class Logger:
    def __init__(self):
        self.records = []

    def log(self, metrics):
        self.records.append(dict(metrics))


def tiny_adapter(monkeypatch, tmp_path, method: str, schedule: bool):
    config = {"hybrid": "configs/hybrid_switch.yml", "advent": "configs/advent.yml"}[method]
    cfg = cfg_from_file(config)
    spec = cfg.METHOD.ADAPTATION[cfg.METHOD.ADAPTATION.NAME]
    cfg.SCHEME.RESOLUTION = [W, H]
    cfg.OTHERS.update(SNAPSHOT_DIR=str(tmp_path), SCHEDULE=schedule, GENERATE_SAMPLES_EVERY=0)
    cfg.MODEL.LOAD = None
    spec.update(EPOCHS=1, SKIP_CALC=True, LOAD_PROTO=None, PSEUDO_THRESH=0.06, set_="test")
    monkeypatch.setitem(registry.LAYERS, cfg.MODEL.NAME, (1, 1, 1, 1))
    model, _ = registry.get_model(cfg, C, device="cpu")
    ad = registry.get_adapt_method(cfg)(model, registry.variables_of(model), cfg, spec, C,
                                        logger=Logger(), device="cpu")
    monkeypatch.setattr(ad, "save_model", lambda: None)
    return ad


@pytest.mark.parametrize("method", ["hybrid", "advent"])
@pytest.mark.parametrize("schedule", [False, True])
def test_loops_record_spans_only_under_schedule(monkeypatch, tmp_path, method, schedule):
    """Each loop (`ProtoOnlineAdapter.train`, `run_adversarial`) as if under
    the profiler on a card (`record_function` and CUDA events faked): with
    OTHERS.SCHEDULE each of two steps holds the loop's phases and its stages
    with their parents, its host reads, one annotation a span and two events
    a stage; without it a step makes no span, annotation or event."""
    ad = tiny_adapter(monkeypatch, tmp_path, method, schedule)
    FakeEvent.made, Annotation.names = [], []
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Annotation)
    ad.spans.cuda = True
    rng = np.random.default_rng(0)
    targets = [{"image": rng.normal(size=(B, 3, H, W)).astype(np.float32)}
               for _ in range(1 + schedule)]
    source = [{"image": rng.normal(size=(B, 3, H, W)).astype(np.float32),
               "label": rng.integers(0, C, size=(B, H, W)).astype(np.int64)}]
    ad.train(source if method == "advent" else None, targets, {})
    annotations = Annotation.names
    steps = ad.spans.steps()
    records = [r for r in ad.logger.records if r]
    assert len(records) == len(targets)
    if not schedule:
        assert steps == [] and annotations == [] and FakeEvent.made == []
        assert not [k for r in records for k in r if k.startswith("time/") or k == "host reads"]
        return
    assert [step[0].step for step in steps] == [0, 1]
    for step, record in zip(steps, records):
        parents = {s.name: s.parent.name for s in step if s.parent is not None}
        assert step[0].name == "step" and step[0].parent is None
        assert {name: parents[name] for name in LOOP[1:]} == dict.fromkeys(LOOP[1:], "step")
        assert {name: parents[name] for name in STAGES[method]} == STAGES[method]
        syncs = [s.parent.name for s in step if s.name == "sync"]
        assert syncs == READS[method] and record["host reads"] == len(READS[method])
        assert all(s.end >= s.start for s in step)
        device = [s.device_ms for s in step if s.name in ("teachers", "student", "update")]
        assert device == [2.5] * len(device) and len(device) == 3 - (method == "advent")
        assert record["time/Student device"] == record["time/Update device"] == 2.5
        assert {"time/Batch Fetch", "time/Step Dispatch", "time/Host Work",
                "time/Log Sync"} <= set(record)
    assert len(FakeEvent.made) == 2 * len(device) * 2
    labels = [SITES[s.parent.name] if s.name == "sync" else s.name for step in steps for s in step]
    assert sorted(annotations) == sorted(labels)


def test_segment_loop_keeps_its_two_time_keys(monkeypatch, tmp_path):
    """SEGMENT pretraining under OTHERS.SCHEDULE: each step a `fetch` and a
    `dispatch` phase, the logged step's loss read as a `sync` span, and the
    two keys it logged before, averaged over the last 10 steps."""
    from onda_torch.methods.segmentation import SegmentTrainer

    cfg = cfg_from_file("configs/training_fog.yml")
    spec = cfg.METHOD.PRETRAIN.SEGMENT
    cfg.SCHEME.RESOLUTION = [W, H]
    cfg.OTHERS.update(SNAPSHOT_DIR=str(tmp_path), SCHEDULE=True)
    cfg.MODEL.LOAD = None
    spec.EPOCHS = 1
    monkeypatch.setitem(registry.LAYERS, cfg.MODEL.NAME, (1, 1, 1, 1))
    model, _ = registry.get_model(cfg, C, device="cpu")
    trainer = SegmentTrainer(model, registry.variables_of(model), cfg, spec, C,
                             logger=Logger(), device="cpu")
    monkeypatch.setattr(trainer, "save_model", lambda: None)
    rng = np.random.default_rng(0)
    loader = [{"image": rng.normal(size=(B, 3, H, W)).astype(np.float32),
               "label": rng.integers(0, C, size=(B, H, W)).astype(np.int64)} for _ in range(2)]
    trainer.train({"source": loader}, {})
    steps = trainer.spans.steps()
    # the epoch's end: a last fetch finds the feed empty
    assert [[s.name for s in step] for step in steps] == [
        ["step", "fetch", "dispatch", "log_sync", "sync", "log"], ["step", "fetch", "dispatch"],
        ["step", "fetch"]]
    first = trainer.logger.records[0]
    assert set(first) == {"Segmentation loss", "learning_rate", "time/Batch Fetch",
                          "time/Fused Step (fwd+loss+bwd+update)"}
    fetch, dispatch = steps[0][1], steps[0][2]
    assert first["time/Batch Fetch"] == fetch.end - fetch.start
    assert first["time/Fused Step (fwd+loss+bwd+update)"] == dispatch.end - dispatch.start


def reader(name):
    spec = importlib.util.spec_from_file_location(f"spans_reader_{name}",
                                                  ROOT / "benchmark" / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def fake_run(spans, t0, t1):
    return SimpleNamespace(adapter=SimpleNamespace(spans=spans),
                           tracer=SimpleNamespace(t0=t0, wall_s=t1 - t0))


def recorded_steps(monkeypatch, n=10, teachers=True):
    """n steps on a clock of one tick a reading: in each, a gate read under
    `teachers` and a log read, the stages' device times 10·i (+1, +2) ms;
    returns the recorder and each step's first and last readings."""
    tick = iter(range(10**6))
    monkeypatch.setattr(timing.time, "perf_counter", lambda: next(tick))
    spans, bounds = SpanRecorder("cpu", enabled=True), []
    for i in range(n):
        with spans.step(i) as step:
            spans.phase("fetch")
            spans.phase("dispatch")
            if teachers:
                with spans.span("teachers") as s:
                    s.device_ms = 10.0 * i
                    with spans.sync("gate"):
                        next(tick)
            with spans.span("student") as s:
                s.device_ms = 10.0 * i + 1
            with spans.span("update") as s:
                s.device_ms = 10.0 * i + 2
            spans.phase("log_sync")
            with spans.sync("logs"):
                pass
            spans.phase("log")
        bounds.append((step.start, step.end))
    return spans, bounds


def test_readers_keep_the_traced_steps_and_take_the_median(monkeypatch):
    """The window opens inside step 2's log and closes inside step 8's, as
    the harness's tracer does: steps 3-8 were dispatched inside it."""
    spans, bounds = recorded_steps(monkeypatch)
    run = fake_run(spans, bounds[2][1] - 1, bounds[8][1] - 1)
    assert [s[0].step for s in spans.steps(run.tracer.t0, run.tracer.t0 + run.tracer.wall_s)] \
        == [3, 4, 5, 6, 7, 8]
    # each step's dispatch lasts 10 ticks, 2 of them in the gate's read
    got = {name: reader(name)(run) for name in READERS}
    assert got == {"teachers_ms": 55.0, "student_ms": 56.0, "update_ms": 57.0,
                   "dispatch_ms": 1e3 * (10 - 2), "host_reads": 2}


def test_readers_read_nothing_without_their_spans(monkeypatch):
    spans, bounds = recorded_steps(monkeypatch, teachers=False)
    run = fake_run(spans, bounds[2][1] - 1, bounds[8][1] - 1)
    assert reader("teachers_ms")(run) is None  # ADVENT has no teachers stage
    assert reader("student_ms")(run) == 56.0 and reader("host_reads")(run) == 1
    for step in spans.ring:  # on the CPU no stage has a device time
        for s in step:
            s.device_ms = None
    assert reader("student_ms")(run) is None and reader("update_ms")(run) is None
    before = fake_run(None, 0.0, 1.0)
    before.adapter = SimpleNamespace()  # a program without a recorder
    assert {name: reader(name)(before) for name in READERS} == dict.fromkeys(READERS)
    empty = fake_run(spans, bounds[-1][1] + 1, bounds[-1][1] + 2)
    assert {name: reader(name)(empty) for name in READERS} == dict.fromkeys(READERS)
