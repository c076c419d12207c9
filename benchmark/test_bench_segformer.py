"""CPU tests of the SegFormer cell (`python -m pytest -q benchmark/test_bench_segformer.py`).

The cell `mitb5_hybrid.mem_b4` runs here end to end through the harness at a
tiny size (embed dims 8/16/24/32, depths 1/1/2/1, the published decoder
width 768, 64x32 frames) with the kernels' plain versions: the reference
model `models/segformer.py` against the port, each planted fault and the
bfloat16 control turning `correct` false. The yardstick's arithmetic at the
published B5 is pinned against hand counts: the forward's operations, the
attention's least time, K1's and K2's; the cell's three readers are held to
what they read.
"""

from __future__ import annotations

import math
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

from benchkit import compare, counts, harness  # noqa: E402

CELL = "mitb5_hybrid.mem_b4"
TINY = {"embed_dims": [8, 16, 24, 32], "depths": [1, 1, 2, 1], "heads": [1, 2, 3, 4],
        "sr_ratios": [8, 4, 2, 1], "mlp_ratio": 4}
TINY_HW = (32, 64)
B5_HW = (512, 1024)
B5 = {"embed_dims": (64, 128, 320, 512), "depths": (3, 6, 40, 3), "heads": (1, 2, 5, 8),
      "sr_ratios": (8, 4, 2, 1)}


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def tiny_cell() -> harness.Cell:
    cell = harness.Cell(CELL)
    cell.config = dict(cell.config, **TINY)
    cell.model, cell.hw = harness.Model(cell.root, cell.config), TINY_HW
    cell.traffic = dict(cell.traffic, frame_hw=list(TINY_HW), distinct_frames=8)
    cell.config["config"]["TRAINING"]["REPLAY_BUFFER"] = 8
    return cell


def run_tiny(monkeypatch, fault=None, seed=2**31 + 12345):
    from onda_torch import registry

    monkeypatch.setitem(registry.SEGFORMER, "SegFormer-B5",
                        {**{k: tuple(v) if isinstance(v, list) else v for k, v in TINY.items()},
                         "decoder": 768})
    return harness.run_cell(CELL, seed, 0.5, False, "cpu", fault, cell=tiny_cell())


def test_the_reference_agrees_with_the_port(monkeypatch):
    result = run_tiny(monkeypatch)
    # both sides in float32 on the CPU: every number far under its limit
    for name, check in result["checks"].items():
        assert check["value"] <= 0.1 * check["limit"] or check["value"] == 0, (name, check)
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["readings"]["reference"]["fired"] == [True] * 3


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered", "head_lr"])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    result = run_tiny(monkeypatch, fault)
    assert result["correct"] is False, result["checks"]


def test_the_bfloat16_control_is_not_correct():
    # the reference in bfloat16 in the program's place, judged against itself in float32
    cell = tiny_cell()
    run = harness.Run(cell, 2**31 + 54321, 0.0, False, "cpu")
    run.prepare()
    got, want = run.reference_readings(torch.bfloat16), run.reference_readings()
    readings = compare.gaps(got, want, cell.model.HEADS)
    failed = [k for k, limit in cell.limits["limits"].items() if readings[k] > limit]
    assert failed, {k: readings[k] for k in cell.limits["limits"]}


def b5_hand_count():
    """Multiply-adds ×2 of one image's B5 forward at 1024x512, block by block:
    the patch embedding; per block q, the reduction conv, kv, QKᵀ and PV,
    proj, fc1, the depthwise 3×3 and fc2; the decoder's four projections,
    its 3072 → 768 fuse and the classifier, on the 128 × 256 grid."""
    total, (h, w), cin = 0, (128, 256), 3
    for s, (c, depth, sr) in enumerate(zip(B5["embed_dims"], B5["depths"], B5["sr_ratios"])):
        k = 7 if s == 0 else 3
        if s:
            h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        n, m = h * w, (h // sr) * (w // sr)
        total += 2 * c * cin * k * k * n
        block = 2 * n * c * c + 2 * m * c * 2 * c + 4 * n * m * c + 2 * n * c * c
        block += 2 * c * c * sr * sr * m if sr > 1 else 0
        block += 2 * n * c * 4 * c * 2 + 2 * n * 4 * c * 9
        total += depth * block
        cin = c
    grid = 128 * 256
    total += sum(2 * (grid >> 2 * s) * c * 768 for s, c in enumerate(B5["embed_dims"]))
    return total + 2 * grid * 3072 * 768 + 2 * grid * 768 * 19


def test_the_b5_cell_gives_the_pinned_counts():
    cell = harness.Cell(CELL)
    model = cell.model
    assert model.shape == {**B5, "mlp_ratio": 4} and model.FEATURES == 768
    assert model.feature_grid(B5_HW) == (128, 256)
    assert sum(math.prod(s) for s in model.shapes().values()) == 84607955
    f = counts.forward_flops(model, B5_HW, False)
    assert f == b5_hand_count() == 479981469696.0  # 0.48 TFLOP a frame
    assert counts.step_flops(cell.config["step_flops"], model, B5_HW, 4, True) == 4 * 9 * f
    assert counts.bn_input_shapes(model, B5_HW, 4) == ((4, 768, 128, 256),)  # linear_fuse's BN
    assert counts.k2_step_bound_s(3, model, B5_HW, 4) == 3 * counts.bound_s(
        counts.k2_bytes((4, 768, 128, 256)), 3.0 * 4 * 768 * 128 * 256)
    p = 4 * 128 * 256  # K1 at F = 768 on the 1/4 grid
    assert counts.k1_step_bound_s(2, model, B5_HW, 4) == 2 * counts.k1_bytes(p, 768) / 3.35e12
    assert cell.config["launches_per_step"] == {"pseudo_labels_kernel": 2, "bn_stats_kernel": 3}


def test_the_attention_bound_against_a_hand_count():
    module = harness.Cell(CELL).model.module
    calls = module.attention_shapes(**B5, mlp_ratio=4, hw=B5_HW)
    assert len(calls) == 52
    # stage by stage: (heads, queries, keys after the reduction, width 64)
    stages = [(1, 32768, 512), (2, 8192, 512), (5, 2048, 512), (8, 512, 512)]
    assert calls == tuple((h, q, k, 64) for (h, q, k), depth in zip(stages, B5["depths"])
                          for _ in range(depth))
    peak, hbm = 495e12 / 3, 3.35e12
    hand = 0.0
    for (h, q, k), depth in zip(stages, B5["depths"]):
        flops = 2 * (2 * h * q * k * 64)     # QKᵀ and PV
        nbytes = 4 * h * 64 * (q + k + k + q)  # Q, K, V read, O written, f32
        assert flops / peak > nbytes / hbm   # every stage is bound by its operations
        hand += depth * flops / peak
    assert math.isclose(module.attention_bound_s(calls, peak, hbm), hand, rel_tol=1e-12)
    assert sum(4 * h * q * k * d for h, q, k, d in calls) == 81067507712  # 0.08 TFLOP a frame


def span(name, device_ms):
    return SimpleNamespace(name=name, device_ms=device_ms)


class Recorder:
    def __init__(self, steps):
        self.ring = steps

    def steps(self, start, end):
        return self.ring


def test_the_readers_of_the_cell():
    cell = harness.Cell(CELL)
    steps = [[span("step", None), span("encoder", 10.0 * i), span("decoder", 1.0),
              span("encoder", 5.0), span("decoder", 2.0 * i)] for i in range(1, 4)]
    log = SimpleNamespace(summary={"kernel_s": {"fmha_cutlassF_f32_aligned_64x64_rf_sm80": 0.3,
                                                "fmha_cutlassB_f32_aligned_64x64_k64_sm80": 0.5,
                                                "elementwise": 9.0}},
                          trace_steps=(1, 3), fired=[True, True, False])
    run = SimpleNamespace(adapter=SimpleNamespace(spans=Recorder(steps)), cell=cell, logger=log,
                          tracer=SimpleNamespace(t0=0.0, wall_s=1.0))
    read = {name: harness.metric_reader(name) for name in ("encoder_ms", "decoder_ms",
                                                           "attn_roofline")}
    assert read["encoder_ms"](run) == 25.0 and read["decoder_ms"](run) == 5.0
    calls = cell.model.module.attention_shapes(**cell.model.shape, hw=B5_HW)
    per_image = cell.model.module.attention_bound_s(calls, 495e12 / 3, 3.35e12)
    # traced steps 2 and 3: 9 forward-equivalents and 8, each of 4 images, over 0.8 s
    assert math.isclose(read["attn_roofline"](run), 100 * (9 + 8) * 4 * per_image / 0.8)
    # nothing to read without the spans, their device times or the kernels
    steps[0][1].device_ms = None
    run.adapter.spans.ring = steps[:1]
    assert read["encoder_ms"](run) is None
    run.adapter = SimpleNamespace()
    assert read["encoder_ms"](run) is None and read["decoder_ms"](run) is None
    log.summary = {"kernel_s": {"elementwise": 1.0}}
    assert read["attn_roofline"](run) is None
    r50 = harness.Cell("r50_hybrid.mem_b4")
    assert read["attn_roofline"](SimpleNamespace(cell=r50, logger=log)) is None
