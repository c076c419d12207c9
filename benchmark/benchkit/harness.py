"""One run of one cell: set-up, the measured window, the traced steps and the
judgement of what the timed path produced.

The program is driven through its public entries, as its CLI drives it:
`registry.get_model` and `registry.get_adapt_method` on the cell's
configuration, a `data.ReplayBuffer` of the source in host memory, and the
adapter's own `train` loop (`ProtoOnlineAdapter.train`, or
`AdventAdapter.train`, which runs `run_adversarial`). The benchmark hands
`train` its logger (the adapters' `logger=`), called once a step with the
step's logs: it reads the step's losses (the one host read a user's logger
makes) and stamps the time. The first `warmup_steps` steps are set-up; the
window then runs for `seconds`, and at the deadline the logger ends the loop
by raising `WindowClosed`. The target stream reports a length far beyond the
window's steps, so no epoch end falls inside it.

Everything cell-specific comes from files found by name: the cell in
`BENCHMARK.json`, its configuration in `benchmark/configs/`, the
configuration's reference model in `benchmark/models/` (its layout,
forward, feature grid, heads and SGD multiplicities), its method in
`benchmark/methods/` (the program's side: log keys, state, faults) and
`benchmark/references/` (its plain reference), its traffic in
`benchmark/traffic/`, its limits in `benchmark/limits/` and each per-layer
metric's reader in `benchmark/metrics/`.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import compare, faults, frames, reference
from .trace import Tracer, top

ROOT = Path(__file__).resolve().parents[2]
COMPARED_STEPS = 3
# streams of a run's seed (frames.generator)
WEIGHTS, SOURCE_FRAMES, SOURCE_LABELS, TARGET_FRAMES, DISK_FRAMES, DISK_LABELS = range(1, 7)
FOREVER = 10**6  # the in-memory stream's length in batches: no epoch end is ever reached


class WindowClosed(Exception):
    """Raised by the benchmark's logger at the deadline, to end `train`."""


# ---------------------------------------------------------------------------
# The cell, from its files
# ---------------------------------------------------------------------------


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    def __init__(self, name: str, manifest_path=ROOT / "BENCHMARK.json"):
        manifest = load_json(manifest_path)
        self.root = root = Path(manifest_path).resolve().parent
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
        self.name, entry = name, cells[name]
        self.chips = int(entry["chips"])
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config = load_json(root / configs[entry["config"]]["file"])
        self.traffic = load_json(root / "benchmark" / "traffic" / f"{entry['traffic']}.json")
        self.traffic_name = entry["traffic"]
        self.limits = load_json(root / "benchmark" / "limits" / f"{name}.json")
        self.end_to_end = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in manifest["per_layer"]
                          if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
        self.model = Model(root, self.config)
        self.method = load_module(root, "methods", self.config["method"])
        self.reference = load_module(root, "references", self.config["method"])
        self.batch = int(self.traffic["batch"])
        self.hw = tuple(self.traffic["frame_hw"])


def frozen(value):
    """A configuration's value with its lists as tuples, to hash."""
    return tuple(map(frozen, value)) if isinstance(value, list) else value


class Model:
    """A configuration's reference model: the file `benchmark/models/<model>.py`
    that its "model" names, with the configuration's values of the file's
    `SHAPE_KEYS` bound. The file gives `shapes(<keys>, classes)` (name →
    shape, the program's layout), `Net(<keys>, compute, observe)` (its
    forward, a `benchkit.reference.Net`), `FEATURES` (the prototypes' width
    F), `feature_grid(hw)`, `HEADS` (the prefixes of the leaves stepped at
    the head's LR), `multiplicity(name, aux_trained)` (the chained SGD
    updates a step gives a leaf; 0: frozen) and, where the default draw of
    `benchkit.reference.seeded_weights` gets a leaf wrong, `drawn(<keys>)`
    (leaf → the fan_in it is drawn at). Two models are equal, and hash
    alike, where the file's name and those values are: the counts of
    `benchkit.counts` are cached on it."""

    def __init__(self, root, config: dict):
        self.name = config["model"]
        self.module = load_module(root, "models", self.name)
        self.shape = {k: frozen(config[k]) for k in self.module.SHAPE_KEYS}
        self.FEATURES, self.HEADS = int(self.module.FEATURES), tuple(self.module.HEADS)

    def key(self):
        return self.name, tuple(self.shape.items())

    def __eq__(self, other):
        return isinstance(other, Model) and self.key() == other.key()

    def __hash__(self):
        return hash(self.key())

    def shapes(self, classes: int = 19) -> dict:
        return self.module.shapes(**self.shape, classes=classes)

    def Net(self, compute=None, observe=None):
        return self.module.Net(**self.shape, compute=compute, observe=observe)

    def feature_grid(self, hw):
        return tuple(self.module.feature_grid(tuple(hw)))

    def multiplicity(self, name: str, aux_trained: bool) -> int:
        return self.module.multiplicity(name, aux_trained)

    def drawn(self) -> dict:
        drawn = getattr(self.module, "drawn", None)
        return drawn(**self.shape) if drawn else {}


def load_module(root, folder: str, name: str):
    """`benchmark/<folder>/<name>.py`, loaded by its path."""
    path = Path(root) / "benchmark" / folder / f"{name}.py"
    key = f"bench_{folder}_{name.replace('.', '_')}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules[key] = module
    return sys.modules[key]


def metric_reader(name: str, root=ROOT):
    """`benchmark/metrics/<name>.py`'s `read`. A metric split by cells
    (`<quantity>.<part>`, as `mfu.host`) is read by its quantity's reader
    unless it has a file of its own."""
    if not (Path(root) / "benchmark" / "metrics" / f"{name}.py").exists():
        name = name.split(".")[0]
    return load_module(root, "metrics", name).read


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


class FrameSet:
    """The source frames as a map-style dataset (image, label, label_res)."""

    def __init__(self, image, label, label_res):
        self.image, self.label, self.label_res = image, label, label_res

    def __len__(self):
        return len(self.image)

    def __getitem__(self, i):
        return {"image": self.image[i], "label": self.label[i], "label_res": self.label_res[i]}


class FrameStream:
    """Pre-decoded target frames in host memory, handed over a batch at a
    time in stream order, cycling over the distinct frames."""

    def __init__(self, images: torch.Tensor, batch: int, length: int = FOREVER):
        self.images, self.batch, self.length = images, batch, length

    def __len__(self):
        return self.length

    def __iter__(self):
        n = len(self.images)
        for k in range(self.length):
            i = (k * self.batch) % n
            yield {"image": self.images[i:i + self.batch]}


def source_frames(seed, n, hw, grid, device):
    """(FrameSet of host arrays) of n seeded source frames and labels, and
    the labels resized by nearest to the model's feature grid."""
    g = frames.generator(seed, SOURCE_FRAMES, device)
    image = torch.cat([frames.normalize(frames.frame_batch(g, min(8, n - i), hw, device))
                       for i in range(0, n, 8)])
    label = frames.label_batch(frames.generator(seed, SOURCE_LABELS, device), n, hw, device)
    label_res = frames.pil_nearest(label, grid)
    return FrameSet(image.cpu().numpy(), label.cpu().numpy(), label_res.cpu().numpy())


def target_frames(seed, n, hw, device, pin: bool) -> torch.Tensor:
    g = frames.generator(seed, TARGET_FRAMES, device)
    out = torch.empty((n, 3, *hw), pin_memory=pin)
    for i in range(0, n, 8):
        out[i:i + 8] = frames.normalize(frames.frame_batch(g, min(8, n - i), hw, device)).cpu()
    return out


def disk_dataset(traffic: dict, traffic_name: str, device) -> tuple[str, list]:
    """The disk stream's PNGs (frames and raw label ids at the file size),
    written on the first run into a fixed directory inside the checkout and
    reused after; returns (root, rows of the stream's table)."""
    from concurrent.futures import ThreadPoolExecutor

    n, fh = int(traffic["distinct_frames"]), tuple(traffic["file_hw"])
    root = ROOT / "build" / "bench_data" / traffic_name
    stamp = {"distinct_frames": n, "file_hw": list(fh), "data_seed": traffic["data_seed"]}
    marker = root / "written.json"
    if not (marker.exists() and load_json(marker) == stamp):
        shutil.rmtree(root, ignore_errors=True)
        g_img = frames.generator(traffic["data_seed"], DISK_FRAMES, device)
        g_lbl = frames.generator(traffic["data_seed"], DISK_LABELS, device)
        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
            jobs = []
            for i in range(0, n, 8):
                rgb = frames.frame_batch(g_img, min(8, n - i), fh, device).cpu().numpy()
                ids = frames.label_batch(g_lbl, len(rgb), fh, device, classes=34,
                                         ignore=False).to(torch.uint8).cpu().numpy()
                for j in range(len(rgb)):
                    image_rel, label_rel = disk_paths(i + j)
                    jobs.append(pool.submit(frames.write_png, str(root / image_rel), rgb[j]))
                    jobs.append(pool.submit(frames.write_png, str(root / label_rel), ids[j]))
            for job in jobs:
                job.result()
        with open(marker, "w") as f:
            json.dump(stamp, f)
    return str(root), disk_table(traffic)


def disk_paths(i: int):
    frame = f"bench_{i:03d}"
    return (f"leftImg8bit/train/rain/bench/{frame}_leftImg8bit.png",
            f"gtFine/train/bench/{frame}_gtFine_labelIds.png")


def shuffled_order(n_rows: int, seed: int) -> np.ndarray:
    """The first epoch's row order of a shuffling `Loader` seeded `seed`
    (`np.random.default_rng(seed).permutation`)."""
    return np.random.default_rng(seed).permutation(n_rows)


def disk_table(traffic: dict) -> list:
    """The stream's rows, `stream_rows` of them over the distinct files,
    laid out so that the loader's shuffled first epoch reads the files in
    turn: stream position i reads file i mod distinct_frames."""
    n_rows, n = int(traffic["stream_rows"]), int(traffic["distinct_frames"])
    file_of = np.empty(n_rows, np.int64)
    file_of[shuffled_order(n_rows, int(traffic["loader_seed"]))] = np.arange(n_rows) % n
    return [dict(zip(("image_path", "label_path"), disk_paths(int(f)))) for f in file_of]


def replay_order(n: int, batch: int, seed: int, steps: int) -> list:
    """The rows `data.ReplayBuffer` draws for its first `steps` batches: a
    permutation from `np.random.default_rng(seed)`, drawn anew each time it
    runs out."""
    rng = np.random.default_rng(seed)
    perm, pos, out = rng.permutation(n), 0, []
    for _ in range(steps):
        rows = []
        for _ in range(batch):
            rows.append(int(perm[pos]))
            pos += 1
            if pos >= n:
                pos, perm = 0, rng.permutation(n)
        out.append(rows)
    return out


def weight_shapes(method, model: Model) -> dict:
    """The model's leaves and those the method keeps beside it."""
    return {**model.shapes(), **method.extra_shapes(model)}


# ---------------------------------------------------------------------------
# The logger that marks the steps
# ---------------------------------------------------------------------------


class StepLogger:
    def __init__(self, run):
        self.run = run
        self.n = 0
        self.losses, self.stamps, self.fired = [], [], []
        self.snap = {}
        self.t_start = self.deadline = self.t_setup = None
        self.fetch_s = self.summary = None
        self.trace_steps = None

    def log(self, metrics):
        run = self.run
        keys = run.cell.method.READ_KEYS
        if keys[0] not in metrics:  # the loop's log of its evaluation before the steps
            return
        values = {k: float(metrics[k]) for k in keys if k in metrics}
        now = time.perf_counter()
        self.n += 1
        n, warmup = self.n, int(run.cell.traffic["warmup_steps"])
        if n <= COMPARED_STEPS:
            self.losses.append({k: values[k] for k in run.cell.method.LOSS_KEYS})
        if n == 1:
            run.marks["first_step"] = now
            self.snap["momentum"] = run.program_tree("momentum")
        if n == COMPARED_STEPS:
            self.snap["params"] = run.program_tree("params")
        if n == warmup:
            if run.cuda:
                torch.cuda.reset_peak_memory_stats(run.device)
            self.t_setup = now
            self.k_launches = run.launches()
            self.t_start, self.deadline = now, now + run.seconds
            return
        if n < warmup:
            return
        self.stamps.append(now)
        gate = run.cell.config["step_flops"].get("gate_log_key")
        self.fired.append(gate is not None and values.get(gate, 0.0) > 0.5)
        w = n - warmup
        if run.trace:
            traffic = run.cell.traffic
            meter, traced = int(traffic["meter_steps"]), int(traffic["trace_steps"])
            if w == meter:
                self.fetch_s = values.get("time/Batch Fetch")
                run.tracer.start()
            elif w == meter + traced:
                self.summary = run.tracer.stop()
                self.trace_steps = (w - traced, w)
                self.close()
        elif now >= self.deadline:
            self.close()

    def close(self):
        run = self.run
        if run.cuda:
            self.peak = torch.cuda.max_memory_allocated(run.device)
        else:
            self.peak = 0
        after = run.launches()
        self.window_launches = {k: after[k] - self.k_launches[k] for k in after}
        raise WindowClosed()


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------


class Run:
    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
                 fault: str | None = None, t0: float | None = None, others=None):
        self.cell, self.seed = cell, int(seed)
        self.seconds, self.trace = float(seconds), bool(trace)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.fault = fault
        self.others = others or {}
        self.t0 = time.perf_counter() if t0 is None else t0
        self.tracer = Tracer(self.device)
        self.logger = StepLogger(self)
        self.restore = None

    # --- the program ---------------------------------------------------
    def launches(self) -> dict:
        from onda_torch.ops import kernels

        return dict(kernels.launches)

    def weights(self) -> dict:
        """Both sides' weights: one seeded draw of every leaf, each leaf the
        configuration's `weight_scale` names multiplied by its factor."""
        cell = self.cell
        out = reference.seeded_weights(weight_shapes(cell.method, cell.model),
                                       frames.generator(self.seed, WEIGHTS, self.device),
                                       self.device, cell.model.drawn())
        for name, factor in cell.config.get("weight_scale", {}).items():
            out[name] = out[name] * float(factor)
        return out

    def prepare(self):
        """The configuration as run, and the benchmark's data: the source
        frames and the target stream."""
        from onda_torch.config import default_config, merge_into

        cell, traffic = self.cell, self.cell.traffic
        cfg = default_config()
        merge_into(cell.config["config"], cfg)
        cfg.TRAINING.BATCH_SIZE = cell.batch
        cfg.SCHEME.RESOLUTION = [cell.hw[1], cell.hw[0]]
        self.snapshot_dir = tempfile.mkdtemp(prefix="onda_bench_")
        cfg.OTHERS.SNAPSHOT_DIR = self.snapshot_dir
        cfg.OTHERS.SCHEDULE = self.trace
        for key, value in self.others.items():  # the control's switches (OTHERS.PRECISION)
            cfg.OTHERS[key] = value
        spec = cfg.METHOD.ADAPTATION[cfg.METHOD.ADAPTATION.NAME]
        spec.set_ = cell.traffic_name
        self.cfg, self.spec = cfg, spec
        seed_cfg = int(cfg.TRAINING.RANDOM_SEED)

        dev = self.device
        self.source = source_frames(self.seed, int(cfg.TRAINING.REPLAY_BUFFER), cell.hw,
                                    cell.model.feature_grid(cell.hw), dev)
        if traffic["feed"] == "mem":
            self.target_images = target_frames(self.seed, int(traffic["distinct_frames"]),
                                               cell.hw, dev, pin=self.cuda)
            self.target = FrameStream(self.target_images, cell.batch)
        else:
            self.target = self.disk_loader(cfg, seed_cfg)
        self.lrs = self.base_lrs()

    def build(self):
        """The program: the model and the adapter as the CLI builds them, on
        the seeded weights, and the source replay in host memory."""
        from onda_torch import registry
        from onda_torch.data import ReplayBuffer

        self.marks = {"imports": time.perf_counter()}
        self.prepare()
        self.marks["data"] = time.perf_counter()
        cell, cfg, spec, dev = self.cell, self.cfg, self.spec, self.device
        replay = ReplayBuffer(self.source, cell.batch, seed=int(cfg.TRAINING.RANDOM_SEED))
        model, _ = registry.get_model(cfg, 19, device=dev)
        shapes = {k: tuple(v.shape) for k, v in model.named_parameters()}
        shapes.update(cell.method.extra_shapes(cell.model))
        if shapes != weight_shapes(cell.method, cell.model):
            raise RuntimeError("the program's parameters are not the reference's layout")
        weights = self.weights()
        with torch.no_grad():
            for k, v in model.named_parameters():
                v.copy_(weights[k])
        adapter = registry.get_adapt_method(cfg)(model, registry.variables_of(model), cfg, spec,
                                                 19, logger=self.logger, device=dev)
        cell.method.load_extra(adapter, weights)
        del weights
        self.restore = faults.plant(self.fault, cell.method, adapter) if self.fault else None
        self.adapter, self.replay = adapter, replay

    def disk_loader(self, cfg, seed_cfg):
        from onda_torch.data import Loader, SegmentationDataset, Table
        from onda_torch.data.metadata import load_dataset_info
        from onda_torch.native import BatchExecutor

        traffic = self.cell.traffic
        if int(traffic["loader_seed"]) != seed_cfg or not cfg.TRAINING.SHUFFLE:
            raise ValueError("the disk stream's table is laid out for a loader shuffled with "
                             "TRAINING.RANDOM_SEED")
        root, rows = disk_dataset(traffic, self.cell.traffic_name, self.device)
        self.disk_root, self.disk_rows = root, rows
        info = load_dataset_info()
        workers = max(int(cfg.OTHERS.NUM_WORKERS), 1)
        ds = SegmentationDataset(root, Table(rows, ["image_path", "label_path"]),
                                 dict(tuple(p) for p in info["label2train"]),
                                 cfg.SCHEME.RESOLUTION, mean=np.asarray(cfg.SCHEME.MEAN),
                                 std=np.asarray(cfg.SCHEME.STD), executor=BatchExecutor(workers))
        return Loader(ds, batch_size=self.cell.batch, shuffle=True, seed=seed_cfg, drop_last=True,
                      num_threads=workers, pin_memory=self.cuda)

    def program_tree(self, which: str) -> dict:
        """A host copy of the method's `momentum` (the optimizers' state the
        first gradient is read from) or `params` tree."""
        tree = self.cell.method.program_tree(self.adapter.state, which)
        return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}

    def drive(self):
        self.marks["built"] = time.perf_counter()
        try:
            self.adapter.train(self.replay, self.target, {})
        except WindowClosed:
            pass
        else:
            raise RuntimeError("the loop ended before the window did")
        log = self.logger
        self.steps = len(log.stamps)
        self.step_s = np.diff([log.t_start] + log.stamps)
        self.window_s = log.stamps[-1] - log.t_start
        self.setup_s = log.t_setup - self.t0
        self.marks["warm"] = log.t_setup
        # set-up by phase: imports and CUDA; frames and configuration; model,
        # weights, replay and adapter; `train` up to its first step's log (its
        # evaluation, the prototype bootstrap, the first step with cuDNN's
        # algorithm choice); the other warm-up steps
        t, self.setup_phases = self.t0, {}
        for name in ("imports", "data", "built", "first_step", "warm"):
            self.setup_phases[name] = self.marks[name] - t
            t = self.marks[name]
        self.jax_modules = sorted({m.split(".")[0] for m in sys.modules}
                                  & {"jax", "jaxlib", "flax", "onda_tpu"})

    def release(self):
        """Free the program's state before the reference runs."""
        self.bootstrap = self.cell.method.read_start(self.snapshot_dir)
        self.adapter = self.replay = self.target = None
        if self.restore:
            self.restore()
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()
        shutil.rmtree(self.snapshot_dir, ignore_errors=True)

    # --- the judgement -------------------------------------------------
    def reference_inputs(self):
        cell, traffic, dev = self.cell, self.cell.traffic, self.device
        b = cell.batch
        src = {k: torch.from_numpy(getattr(self.source, k)).to(dev)
               for k in ("image", "label", "label_res")}
        if traffic["feed"] == "mem":
            n = len(self.target_images)
            targets = [self.target_images[(k * b) % n:(k * b) % n + b].to(dev)
                       for k in range(COMPARED_STEPS)]
        else:
            order = shuffled_order(len(self.disk_rows), int(traffic["loader_seed"]))
            targets = []
            for k in range(COMPARED_STEPS):
                rgb = [frames.resize_bicubic(frames.read_png(os.path.join(
                    self.disk_root, self.disk_rows[r]["image_path"])), cell.hw)
                    for r in order[k * b:(k + 1) * b]]
                targets.append(frames.normalize(torch.from_numpy(np.stack(rgb)).to(dev)))
        src_order = replay_order(len(self.source), b, int(self.cfg.TRAINING.RANDOM_SEED),
                                 COMPARED_STEPS)
        return src, targets, src_order

    def base_lrs(self):
        spec = self.spec
        base, power = float(spec.LEARNING_RATE), float(spec.POWER)
        steps = int(spec.EPOCHS) * len(self.target)
        return [base * (1.0 - k / steps) ** power if power else base for k in range(COMPARED_STEPS)]

    def reference_readings(self, compute=None) -> dict:
        """The reference's losses, step-1 gradient norms and change norms
        over the compared steps, in f32 with TF32 off (or in `compute`)."""
        cell, dev = self.cell, self.device
        flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            return self._reference_readings(compute)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags

    def _reference_readings(self, compute):
        cell, dev = self.cell, self.device
        weights = self.weights()
        src, targets, src_order = self.reference_inputs()
        spec = {**dict(self.spec), "LR_RATIO": str(self.cfg.MODEL.LR_RATIO or "1:10")}
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(self.cfg.TRAINING.RANDOM_SEED))
        return cell.reference.adapt_steps(spec, cell.model, weights, src, targets, src_order,
                                          self.lrs, gen, compute)

    def program_readings(self) -> dict:
        """The program's losses, the gradient of its first step as its
        optimizers hold it after that step, and its change over the compared
        steps, with the same leaves as the reference's."""
        cell = self.cell
        p0 = {k: v.cpu() for k, v in self.weights().items()}
        spec = self.spec
        r0, r1 = (float(v) for v in str(self.cfg.MODEL.LR_RATIO or "1:10").split(":"))
        grads = compare.first_gradients(self.logger.snap["momentum"], p0, cell.model,
                                        cell.method.AUX_TRAINED,
                                        self.lrs[0] * r0, self.lrs[0] * r1,
                                        float(spec.MOMENTUM), float(spec.WEIGHT_DECAY))
        after = self.logger.snap["params"]
        out = {"losses": self.logger.losses, "grad": reference.leaf_norms(grads),
               "grad_tensors": grads,
               "change": reference.change_norms({k: after[k] for k in grads}, p0)}
        if self.bootstrap is not None:
            out["proto"] = self.bootstrap
        return out

    def judge(self, want=None) -> dict:
        """The numbers compared, each with its limit; `want`: the reference's
        readings of this seed, if already computed."""
        got = self.program_readings()
        if want is None:
            want = self.reference_readings()
        limits = self.cell.limits["limits"]
        readings = compare.gaps(got, want, self.cell.model.HEADS)
        checks = {k: readings.pop(k) for k in limits}
        self.worst = readings  # read, not compared
        # the kernels run on the card; on the CPU their plain versions, which launch nothing
        per_step = self.cell.config["launches_per_step"] if self.cuda else {}
        want_launches = {k: per_step.get(k, 0) * self.steps for k in self.logger.window_launches}
        checks["launch_count_gap"] = float(sum(abs(self.logger.window_launches.get(k, 0) - v)
                                               for k, v in want_launches.items()))
        limits = dict(limits, launch_count_gap=0.0)
        self.readings = {"program": got, "reference": want, "worst": self.worst}
        for side in ("program", "reference"):  # the norms stay; the tensors go
            self.readings[side] = {k: v for k, v in self.readings[side].items()
                                   if k not in ("grad_tensors", "proto")}
        return {k: {"value": checks[k], "limit": limits[k]} for k in checks}


# ---------------------------------------------------------------------------
# The result
# ---------------------------------------------------------------------------


def end_to_end(run: Run) -> dict:
    step_ms = 1e3 * np.asarray(run.step_s)
    frames_per_s = run.steps * run.cell.batch / run.window_s
    return {"frames_per_s": {"value": frames_per_s, "unit": "frames/s"},
            "step_ms_p90": {"value": float(np.quantile(step_ms, 0.9, method="linear")),
                            "unit": "ms"},
            "peak_mem_gib": {"value": run.logger.peak / 2**30, "unit": "GiB"},
            "setup_s": {"value": run.setup_s, "unit": "s"}}


def window_halves(run: Run) -> list:
    """frames/s over the steps that ended in the window's first half and over
    the rest: the spread inside one run, beside the spread between runs."""
    log, b = run.logger, run.cell.batch
    mid = log.t_start + 0.5 * run.window_s
    n1 = sum(t <= mid for t in log.stamps)
    if not 0 < n1 < len(log.stamps):
        return []
    t1 = log.stamps[n1 - 1]
    return [n1 * b / (t1 - log.t_start), (len(log.stamps) - n1) * b / (log.stamps[-1] - t1)]


def per_layer(run: Run) -> dict:
    out = {}
    for metric in run.cell.per_layer:
        value = metric_reader(metric["name"], run.cell.root)(run)
        if value is not None:
            out[metric["name"]] = {"value": float(value), "unit": metric["unit"]}
    return out


def breakdown(summary: dict) -> dict:
    return {"device_ops": top(summary["kernel_s"]), "idle_gaps": top(summary["gap_s"])}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda", fault=None,
             t0=None, cell: Cell | None = None) -> dict:
    """One run of the cell; returns the result line's object (with the
    readings compared under "readings", which the caller drops)."""
    cell = cell or Cell(name)
    run = Run(cell, seed, seconds, trace, device, fault, t0)
    run.build()
    run.drive()
    if run.jax_modules:
        raise SystemExit(f"the run loaded {run.jax_modules}: the port must not load JAX")
    if trace:
        metrics = per_layer(run)
    else:  # a metric split by cells (`frames_per_s.host`) is its quantity's value
        values = end_to_end(run)
        metrics = {m["name"]: values[m["name"].split(".")[0]] for m in cell.end_to_end}
    device_info = {"platform": "gpu" if run.cuda else "cpu",
                   "kind": torch.cuda.get_device_name(run.device) if run.cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(run.logger.peak)}
    result = {"correct": None, "attempted": run.steps, "failed": 0, "metrics": metrics,
              "device": device_info}
    if trace:
        summary = run.logger.summary
        device_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = breakdown(summary)
    run.release()
    checks = run.judge()
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values()
                            if math.isfinite(c["value"])) and all(
        math.isfinite(c["value"]) for c in checks.values())
    result["readings"] = run.readings
    result["diagnostics"] = {"setup_phases_s": run.setup_phases,
                             "window_halves_frames_per_s": [] if trace else window_halves(run)}
    result["checks"] = checks
    return result

