"""CPU tests of the benchmark's harness (`python -m pytest -q benchmark/test_bench_harness.py`;
the card's test: `-m cuda`).

A cell runs here end to end at a tiny size (64x32 frames, one bottleneck a
stage) with the kernels' plain versions: the result line, the reference
against the port, and each planted fault turning `correct` false. The
arithmetic of the yardstick is pinned against hand counts and against the
exact values it gave at the cells' sizes before the reference model became
a file of its own; a toy model file shows that a new architecture is taken
through new files alone; the imports of every module under `benchmark/`
are checked.
"""

from __future__ import annotations

import ast
import hashlib
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

from benchkit import compare, counts, frames, harness, reference  # noqa: E402

TINY = (1, 1, 1, 1)
TINY_HW = (32, 64)
R50_HW = (512, 1024)


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def tiny_cell(name: str) -> harness.Cell:
    cell = harness.Cell(name)
    cell.config = dict(cell.config, layers=list(TINY))
    cell.model, cell.hw = harness.Model(cell.root, cell.config), TINY_HW
    cell.traffic = dict(cell.traffic, frame_hw=list(TINY_HW), distinct_frames=8,
                        file_hw=[64, 128], stream_rows=64)
    cell.config["config"]["TRAINING"]["REPLAY_BUFFER"] = 8
    return cell


def run_tiny(monkeypatch, name, fault=None, seed=2**31 + 12345):
    from onda_torch import registry

    monkeypatch.setitem(registry.LAYERS, "DeepLabv2-Resnet50", TINY)
    return harness.run_cell(name, seed, 0.5, False, "cpu", fault, cell=tiny_cell(name))


@pytest.fixture(scope="module")
def hybrid_result():
    mp = pytest.MonkeyPatch()
    try:
        with torch.random.fork_rng():
            torch.set_num_threads(2)
            yield run_tiny(mp, "r50_hybrid.mem_b4")
    finally:
        mp.undo()


def test_result_line_keys(hybrid_result):
    line = json.loads(json.dumps({k: v for k, v in hybrid_result.items()
                                  if k not in ("readings", "diagnostics")}))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"frames_per_s", "step_ms_p90", "peak_mem_gib", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    limits = json.loads((HERE / "limits" / "r50_hybrid.mem_b4.json").read_text())["limits"]
    assert set(line["checks"]) == set(limits) | {"launch_count_gap"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    assert line["attempted"] >= 1 and line["failed"] == 0


@pytest.mark.parametrize("name", ["r50_hybrid.mem_b4", "r50_advent.mem_b4", "r50_hybrid.disk_b4"])
def test_reference_agrees_with_the_port(monkeypatch, name, hybrid_result):
    result = hybrid_result if name == "r50_hybrid.mem_b4" else run_tiny(monkeypatch, name)
    # both sides in float32 on the CPU: every number far under its limit
    for name, check in result["checks"].items():
        assert check["value"] <= 0.1 * check["limit"] or check["value"] == 0, (name, check)
    assert result["correct"] is True


@pytest.mark.parametrize("name,fault", [("r50_hybrid.mem_b4", "unchanged"),
                                        ("r50_hybrid.mem_b4", "half_batch"),
                                        ("r50_hybrid.mem_b4", "altered"),
                                        ("r50_hybrid.mem_b4", "head_lr"),
                                        ("r50_advent.mem_b4", "half_batch"),
                                        ("r50_advent.mem_b4", "altered"),
                                        ("r50_advent.mem_b4", "head_lr")])
def test_a_planted_fault_is_not_correct(monkeypatch, name, fault):
    result = run_tiny(monkeypatch, name, fault)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("name", ["r50_hybrid.mem_b4", "r50_advent.mem_b4"])
def test_the_bfloat16_control_is_not_correct(monkeypatch, name):
    # the reference in bfloat16 in the program's place, judged against itself in float32
    cell = tiny_cell(name)
    run = harness.Run(cell, 2**31 + 54321, 0.0, False, "cpu")
    run.prepare()
    got, want = run.reference_readings(torch.bfloat16), run.reference_readings()
    readings = compare.gaps(got, want, cell.model.HEADS)
    failed = [k for k, limit in cell.limits["limits"].items() if readings[k] > limit]
    assert failed, {k: readings[k] for k in cell.limits["limits"]}


def test_disk_frames_read_back_as_the_port_prepares_them(tmp_path):
    from onda_torch.data import SegmentationDataset, Table
    from onda_torch.data.metadata import load_dataset_info
    from onda_torch.native import BatchExecutor

    g = frames.generator(7, 1, "cpu")
    rgb = frames.frame_batch(g, 2, (64, 128), "cpu").numpy()
    ids = frames.label_batch(g, 2, (64, 128), "cpu", classes=34, ignore=False).to(torch.uint8)
    rows = []
    for i in range(2):
        frames.write_png(str(tmp_path / f"f{i}.png"), rgb[i])
        frames.write_png(str(tmp_path / f"l{i}.png"), ids[i].numpy())
        rows.append({"image_path": f"f{i}.png", "label_path": f"l{i}.png"})
    info = load_dataset_info()
    ds = SegmentationDataset(str(tmp_path), Table(rows, ["image_path", "label_path"]),
                             dict(tuple(p) for p in info["label2train"]), [64, 32],
                             mean=frames.MEAN, std=frames.STD, executor=BatchExecutor(2))
    got = ds.prepare_batch([0, 1])["image"]
    for i in range(2):
        assert (frames.read_png(str(tmp_path / f"f{i}.png")) == rgb[i]).all()
    mine = frames.normalize(torch.from_numpy(
        __import__("numpy").stack([frames.resize_bicubic(rgb[i], (32, 64)) for i in range(2)])))
    # the same u8 pixels; float32 normalisation to an ulp or two
    assert torch.allclose(torch.from_numpy(got), mine, rtol=0, atol=1e-5)


def test_flops_and_bytes_against_hand_counts():
    # one discriminator at a 19 x 32 x 32 map: five 4x4 stride-2 convs with padding 1
    widths, side, hand = (19, 64, 128, 256, 512, 1), 32, 0
    for i in range(5):
        side //= 2
        hand += 2 * widths[i] * widths[i + 1] * 16 * side * side
    assert counts.disc_flops((32, 32)) == hand
    # the stem alone of the model at 32 x 64: 2·64·3·7·7·16·32, part of the forward
    tiny, r50 = tiny_cell("r50_hybrid.mem_b4").model, harness.Cell("r50_hybrid.mem_b4").model
    stem = 2 * 64 * 3 * 49 * 16 * 32
    f = counts.forward_flops(tiny, TINY_HW, False)
    assert f > stem
    assert counts.forward_flops(tiny, TINY_HW, True) > f  # the aux head adds its convs
    # hybrid: 3 teacher forwards on B, student forward + backward on 2B = 9 forward-equivalents
    hybrid = harness.Cell("r50_hybrid.mem_b4").config["step_flops"]
    assert counts.step_flops(hybrid, tiny, TINY_HW, 4, True) == 4 * f * 9
    assert counts.step_flops(hybrid, tiny, TINY_HW, 4, False) == 4 * f * 8
    # advent: the multi-level student's two passes (6) and 12 of one discriminator an image
    advent = harness.Cell("r50_advent.mem_b4").config["step_flops"]
    f_aux, d = counts.forward_flops(tiny, TINY_HW, True), counts.disc_flops(TINY_HW)
    assert counts.step_flops(advent, tiny, TINY_HW, 4) == 4 * (6 * f_aux + 12 * d)
    # K2: the input read once, mean and variance written once
    assert counts.k2_bytes((4, 64, 10, 20)) == 4 * 4 * 64 * 200 + 2 * 64 * 4
    assert len(counts.bn_input_shapes(r50, R50_HW, 4)) == 53
    # K1 at P pixels, F = 256, C = 19, bound by its bytes at the main path's P
    p = 4 * 65 * 129
    assert counts.k1_bytes(p, 256) == 4 * (p * 256 + 19 * 256 + 2 * p * 19 + 256 + 1 + 2 * p)
    assert counts.k1_step_bound_s(2, r50, R50_HW, 4) == 2 * counts.k1_bytes(p, 256) / 3.35e12
    # K2 bound by its bytes: 159 calls' inputs of a hybrid step at b4
    shapes = counts.bn_input_shapes(r50, R50_HW, 4)
    assert math.isclose(counts.k2_step_bound_s(3, r50, R50_HW, 4),
                        3 * sum(map(counts.k2_bytes, shapes)) / 3.35e12)
    # the published model: DeepLab-v2 R50 + ProDA head at 1024 x 512, about 0.78 TFLOP a frame
    assert 0.6e12 < counts.forward_flops(r50, R50_HW, False) < 1.0e12


def r50_bn_inputs(batch: int) -> list:
    """The BatchNorm inputs of DeepLab-v2 R50 at 1024 x 512: the stem's, then
    each bottleneck's bn1, bn2, bn3 and, in a stage's first, its downsample's."""
    out = [(batch, 64, 256, 512)]
    for planes, blocks, grid in ((64, 3, (129, 257)), (128, 4, (65, 129)), (256, 6, (65, 129)),
                                 (512, 3, (65, 129))):
        for j in range(blocks):
            out += [(batch, planes, *grid)] * 2 + [(batch, 4 * planes, *grid)] * (1 + (j == 0))
    return out


def checksum(tree: dict) -> str:
    h = hashlib.sha256()
    for name in sorted(tree):
        h.update(name.encode())
        h.update(tree[name].contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name,leaves,layout,weights", [
    ("r50_hybrid.mem_b4", 217, "fa00e2da004449cd31fd863ec9c5721073455fef55e5a51cb69fd7e708a78f71",
     "f604f7cd09f92fdf22ce3b5b213e8653627e1e10bde20489c7ac3f4536f6e892"),
    ("r50_advent.mem_b4", 237, "bb3f5f64f582ec4412a709f54f6c7bd62facec032d3ce3e7f6123a475576db17",
     "4dd8ef38f4e8a77df15f7f43207e685611adcb3147a92a67da1dc05b4b383672")])
def test_the_r50_cells_give_the_pinned_counts_layout_and_weights(name, leaves, layout, weights):
    # exact values at the cells' sizes from before the model became a file of its own: moving
    # DeepLab-v2 into `models/deeplabv2.py` changed no count, leaf or drawn weight by a bit
    cell = harness.Cell(name)
    model = cell.model
    assert model.feature_grid(R50_HW) == (65, 129)
    assert counts.forward_flops(model, R50_HW, False) == 781052306944.0
    assert counts.forward_flops(model, R50_HW, True) == 993248758784.0
    assert counts.disc_flops(R50_HW) == 30878466048.0
    assert counts.k2_step_bound_s(3, model, R50_HW, 4) == 0.0038033794674626866  # hybrid
    assert counts.k2_step_bound_s(2, model, R50_HW, 4) == 0.002535586311641791   # ADVENT
    assert counts.k1_step_bound_s(2, model, R50_HW, 4) == 2.3720503880597017e-05
    assert list(counts.bn_input_shapes(model, R50_HW, 4)) == r50_bn_inputs(4)
    want_flops = {"r50_hybrid.mem_b4": (28117883049984.0, 24993673822208.0),
                  "r50_advent.mem_b4": (25320136581120.0, 25320136581120.0)}[name]
    assert tuple(counts.step_flops(cell.config["step_flops"], model, R50_HW, 4, fired)
                 for fired in (True, False)) == want_flops
    shapes = harness.weight_shapes(cell.method, model)
    assert len(shapes) == leaves
    assert hashlib.sha256(json.dumps(sorted((k, list(v)) for k, v in shapes.items()))
                          .encode()).hexdigest() == layout
    drawn = reference.seeded_weights(shapes, frames.generator(2**31 + 12345, harness.WEIGHTS,
                                                              "cpu"), "cpu", model.drawn())
    assert checksum(drawn) == weights


def test_sgd_chain_gives_back_the_gradient():
    g, p0 = torch.randn(10, dtype=torch.float64), torch.randn(10, dtype=torch.float64)
    for k in (1, 3, 4):
        params, buf = {"w": p0.clone()}, {"w": torch.zeros(10, dtype=torch.float64)}
        reference.sgd(params, buf, {"w": g}, {"w": k}, 0.01, 0.01, 0.9, 1e-4, ("head.",))
        a, c = compare.chain(k, 0.01, 0.9, 1e-4)
        assert torch.allclose((buf["w"] - c * p0) / a, g)


def test_union_of_intervals_and_idle_gaps():
    assert counts.union_seconds([(0, 2), (1, 3), (5, 6)]) == 4
    assert counts.union_seconds([]) == 0
    from benchkit import trace

    host = {"pid": 1, "tid": 1}
    events = [{"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 0, "dur": 2, **host},
              {"cat": "cpu_op", "name": "aten::conv", "ts": 0, "dur": 10, **host},
              {"cat": "kernel", "name": "k", "ts": 3, "dur": 2},
              {"cat": "cpu_op", "name": "aten::item", "ts": 12, "dur": 8, **host},
              {"cat": "kernel", "name": "k", "ts": 21, "dur": 4}]
    summary = trace.summarize(events, 1.0)
    assert summary["busy_s"] == 6e-6 and summary["kernel_s"] == {"k": 6e-6}
    assert summary["gap_s"] == {"cudaLaunchKernel": 3e-6, "aten::item": 16e-6}


@pytest.mark.parametrize("name", ["r50_hybrid.mem_b4", "r50_advent.mem_b4"])
def test_the_reference_layout_is_the_programs(name):
    from onda_torch.models import build_deeplab_v2

    model = harness.Cell(name).model
    for multi in (False, True):
        with torch.device("meta"):
            program = build_deeplab_v2(19, model.shape["layers"], "ProDA", multi_level=multi)
        got = {k: tuple(v.shape) for k, v in program.named_parameters()}
        assert got == model.shapes()
    # the grid the model declares is its forward's
    P = counts.meta_params(model)
    _, (feat, logits) = model.Net()(P, torch.empty(1, 3, *R50_HW, device="meta"), False)
    assert tuple(feat.shape[1:]) == (model.FEATURES, *model.feature_grid(R50_HW))


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_imports():
    banned = {"jax", "jaxlib", "flax", "orbax", "onda_tpu"}
    sources = sorted(HERE.rglob("*.py"))
    assert sources
    for path in sources:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & banned, (path, tops & banned)
    # the yardstick, every reference model and every method's plain reference import nothing
    # of the program
    yardstick = [HERE / "benchkit" / f"{name}.py"
                 for name in ("reference", "frames", "counts", "compare", "trace")]
    models = sorted((HERE / "models").glob("*.py"))
    assert models
    for path in yardstick + models + sorted((HERE / "references").glob("*.py")):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert "onda_torch" not in tops, path


def test_a_new_traffic_file_and_metric_reader_are_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE.parent / "BENCHMARK.json", root / "BENCHMARK.json")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    (root / "benchmark" / "traffic" / "mem_b2.json").write_text(json.dumps(
        {**json.loads((HERE / "traffic" / "mem_b4.json").read_text()), "batch": 2}))
    (root / "benchmark" / "metrics" / "steps_traced.py").write_text(
        "def read(run):\n    return len(run.logger.stamps)\n")
    (root / "benchmark" / "limits" / "r50_hybrid.mem_b2.json").write_text(
        (HERE / "limits" / "r50_hybrid.mem_b4.json").read_text())
    manifest["workloads"].append({"name": "r50_hybrid.mem_b2", "config": "deeplabv2_r50_hybrid",
                                  "traffic": "mem_b2", "chips": 1, "why": "b2"})
    manifest["per_layer"].append({"name": "steps_traced", "unit": "steps", "better": "higher",
                                  "source": "program_counter", "layer": "step",
                                  "moves": "frames_per_s", "workloads": ["r50_hybrid.mem_b2"]})
    # a new configuration whose method is new: its own method and reference files
    for folder in ("methods", "references"):
        shutil.copy(HERE / folder / "hybrid.py", root / "benchmark" / folder / "hybrid_copy.py")
    config = json.loads((HERE / "configs" / "deeplabv2_r50_hybrid.json").read_text())
    (root / "benchmark" / "limits" / "copy.mem_b2.json").write_text(
        (HERE / "limits" / "r50_hybrid.mem_b4.json").read_text())
    (root / "benchmark" / "configs" / "copy.json").write_text(
        json.dumps({**config, "name": "copy", "method": "hybrid_copy"}))
    manifest["configs"].append({"name": "copy", "source": "https://example.org",
                                "file": "benchmark/configs/copy.json", "reduced": [], "why": "a"})
    manifest["workloads"].append({"name": "copy.mem_b2", "config": "copy", "traffic": "mem_b2",
                                  "chips": 1, "why": "b2"})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = harness.Cell("r50_hybrid.mem_b2", root / "BENCHMARK.json")
    assert cell.batch == 2 and cell.method.LOSS_KEYS == ("Total target loss", "buff_loss")
    assert "steps_traced" in [m["name"] for m in cell.per_layer]
    copy = harness.Cell("copy.mem_b2", root / "BENCHMARK.json")
    assert copy.method.__file__.endswith("hybrid_copy.py")
    assert copy.reference.__file__.endswith("hybrid_copy.py")

    class Fake:
        class logger:
            stamps = [1.0, 2.0]
    assert harness.metric_reader("steps_traced", root)(Fake) == 2


TOY_MODEL = """
import torch.nn.functional as F

from benchkit import reference

SHAPE_KEYS = ("width",)
FEATURES = 48
HEADS = ("decode.",)


def feature_grid(hw):
    return hw[0] // 4, hw[1] // 4


def shapes(width, classes=19):
    return {"stem.weight": (width, 3, 3, 3), "stem.bias": (width,), "stem.scale": (width,),
            "bn.weight": (width,), "bn.bias": (width,), "ln.weight": (width,), "ln.bias": (width,),
            "decode.proj.weight": (FEATURES, width, 4, 4), "decode.proj.bias": (FEATURES,),
            "decode.cls.weight": (classes, FEATURES, 1, 1), "decode.cls.bias": (classes,)}


def drawn(width):
    return {"stem.scale": 1}  # a layer scale: neither a norm's affine nor a bias


def multiplicity(name, aux_trained):
    return 1


class Net(reference.Net):
    def __init__(self, width, compute=None, observe=None):
        super().__init__(compute, observe)

    def __call__(self, P, x, train, gen=None, aux=False):
        h = self.conv(x, P["stem.weight"], P["stem.bias"], padding=1)
        h = F.relu(self.bn(P, "bn", h * P["stem.scale"][:, None, None], train)).permute(0, 2, 3, 1)
        h = F.layer_norm(h, h.shape[-1:], P["ln.weight"], P["ln.bias"]).permute(0, 3, 1, 2)
        feat = self.conv(h, P["decode.proj.weight"], P["decode.proj.bias"], stride=4)
        if train and gen is not None:
            feat = self.dropout(feat, gen)
        return None, (feat, self.conv(feat, P["decode.cls.weight"], P["decode.cls.bias"]))
"""


def test_a_new_model_file_is_taken_with_no_edit(tmp_path):
    # a second architecture, with its own layout, norms, grid, width, heads and multiplicities,
    # enters through a model file and a configuration that names it: no file of the harness
    # knows it
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    (root / "benchmark" / "models" / "toy.py").write_text(TOY_MODEL)
    config = json.loads((HERE / "configs" / "deeplabv2_r50_hybrid.json").read_text())
    config = {k: v for k, v in config.items() if k not in ("layers", "weight_scale")}
    (root / "benchmark" / "configs" / "toy.json").write_text(
        json.dumps({**config, "name": "toy", "model": "toy", "width": 8}))
    (root / "benchmark" / "limits" / "toy.mem_b4.json").write_text(
        (HERE / "limits" / "r50_hybrid.mem_b4.json").read_text())
    manifest["configs"].append({"name": "toy", "source": "https://example.org",
                                "file": "benchmark/configs/toy.json", "reduced": [], "why": "a"})
    manifest["workloads"].append({"name": "toy.mem_b4", "config": "toy", "traffic": "mem_b4",
                                  "chips": 1, "why": "b4"})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = harness.Cell("toy.mem_b4", root / "BENCHMARK.json")
    model, hw, batch = cell.model, TINY_HW, 4
    assert model.module.__file__.endswith("toy.py")
    assert (model.name, model.shape, model.FEATURES, model.HEADS) == ("toy", {"width": 8}, 48,
                                                                      ("decode.",))
    assert model == harness.Model(root, {"model": "toy", "width": 8}) != harness.Model(
        root, {"model": "toy", "width": 16})
    # the layout and the seeded draw: the listed layer scale drawn, the norms' affines 1 and 0
    shapes = harness.weight_shapes(cell.method, model)
    assert shapes == model.module.shapes(8)
    w = reference.seeded_weights(shapes, frames.generator(5, harness.WEIGHTS, "cpu"), "cpu",
                                 model.drawn())
    assert w["stem.scale"].std() > 0.1
    assert (w["ln.weight"] == 1).all() and (w["bn.bias"] == 0).all()
    # the grid, the counts and the norms' inputs follow the file: one BatchNorm, not the
    # LayerNorm; the head's width 48 at a stride of 4
    assert model.feature_grid(hw) == (8, 16)
    conv = 2 * 8 * 3 * 9 * 32 * 64 + 2 * 48 * 8 * 16 * 8 * 16 + 2 * 19 * 48 * 8 * 16
    assert counts.forward_flops(model, hw, False) == conv
    assert counts.bn_input_shapes(model, hw, batch) == ((batch, 8, 32, 64),)
    assert counts.k2_step_bound_s(2, model, hw, batch) == 2 * counts.bound_s(
        counts.k2_bytes((batch, 8, 32, 64)), 3.0 * batch * 8 * 32 * 64)
    p = batch * 8 * 16
    assert counts.k1_step_bound_s(2, model, hw, batch) == 2 * counts.bound_s(
        counts.k1_bytes(p, 48), 2.0 * p * 19 * 48 + p * 48)
    # SGD and the first gradient: one update a leaf, the head's LR on its prefix alone
    gen = torch.Generator().manual_seed(0)
    g = {k: torch.randn(v, generator=gen, dtype=torch.float64) for k, v in shapes.items()}
    p0 = {k: v.double() for k, v in w.items()}
    params, buf = dict(p0), {k: torch.zeros_like(v) for k, v in p0.items()}
    mult = {k: model.multiplicity(k, False) for k in shapes}
    reference.sgd(params, buf, g, mult, 0.01, 0.1, 0.9, 1e-4, model.HEADS)
    step = {k: (p0[k] - params[k]).norm() / buf[k].norm() for k in shapes}
    assert all(math.isclose(step[k], 0.1 if k.startswith("decode.") else 0.01) for k in shapes)
    got = compare.first_gradients(buf, p0, model, False, 0.01, 0.1, 0.9, 1e-4)
    assert set(got) == set(shapes)
    assert all(torch.allclose(got[k], g[k]) for k in shapes)
    # the plain reference steps the toy from the harness's seeded inputs
    run = harness.Run(cell, 2**31 + 99, 0.0, False, "cpu")
    cell.hw = hw
    cell.traffic = dict(cell.traffic, frame_hw=list(hw), distinct_frames=8)
    cell.config["config"]["TRAINING"]["REPLAY_BUFFER"] = 8
    run.prepare()
    assert run.source.label_res.shape == (8, 8, 16)
    want = run.reference_readings()
    assert set(want["grad"]) == set(shapes) and want["proto"]["mean"].shape == (19, 48)
    assert all(math.isfinite(v) for losses in want["losses"] for v in losses.values())
    gaps = compare.gaps(want, want, model.HEADS)
    assert gaps["grad_diff_head"] == 0 and gaps["loss_gap"] == 0


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "r50_hybrid.mem_b4",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=HERE.parent, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
def test_a_short_run_on_the_card(card, tmp_path):
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "r50_hybrid.mem_b4",
                          "--seed", str(2**31 + 7), "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, cwd=HERE.parent, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and math.isfinite(line["metrics"]["frames_per_s"]["value"])
