"""SegFormer (`onda_torch/models/segformer.py`) against the benchmark's plain
reference of it (`benchmark/models/segformer.py`, loaded by its path) on
seeded weights, at a tiny preset on the CPU: embed dims 8/16/24/32, depths
1/1/2/1, heads 1/2/3/4, sequence reduction 8/4/2/1, the published decoder
width 768 (the reference's F), 64x32 images. The forward in eval and train
mode (the same generator's drop-path and dropout draws on both sides), one
backward, the parameter labels of the method's SGD, the registry's build and
an mmseg checkpoint, OTHERS.PRECISION bf16 and the model's spans; the
published B5 layout on the meta device.

Tolerances: both sides compute in float32 on the CPU, the port through
fused kernels (`F.layer_norm`, `scaled_dot_product_attention`, `F.gelu`)
and the reference through their plain expressions, so they differ by
float32 rounding, summed in other orders: a few 1e-6 of the largest value
here. `TOL` = 1e-4 leaves that room and is still fifty times under what the
reference computed in bfloat16 gives (its matmuls and convs round to 8 bits
of mantissa: about 1e-2), which each comparison checks fails it.
"""

import importlib.util
import math
import statistics
import sys
from pathlib import Path

import pytest
import torch

from onda_torch import registry
from onda_torch.config import cfg_from_file, default_config
from onda_torch.methods import optim
from onda_torch.models.segformer import SegFormer
from onda_torch.utils.spans import SpanRecorder

ROOT = Path(__file__).resolve().parents[1]
TINY = {"embed_dims": (8, 16, 24, 32), "depths": (1, 1, 2, 1), "heads": (1, 2, 3, 4),
        "sr_ratios": (8, 4, 2, 1), "mlp_ratio": 4}
HW = (32, 64)
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref():
    """The reference model file, with the benchmark's kit importable."""
    sys.path.insert(0, str(ROOT / "benchmark"))
    spec = importlib.util.spec_from_file_location("segformer_reference",
                                                  ROOT / "benchmark" / "models" / "segformer.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def tiny_registry(monkeypatch):
    monkeypatch.setitem(registry.SEGFORMER, "SegFormer-B5", {**TINY, "decoder": 768})


def seeded(ref, seed=5):
    from benchkit import frames, reference

    weights = reference.seeded_weights(ref.shapes(**TINY),
                                       frames.generator(seed, 1, "cpu"), "cpu")
    weights["decode_head.linear_pred.weight"] *= 8.0  # confident logits, as the cell draws them
    return weights


def tiny_model(weights, dtype=None):
    model = SegFormer(19, **TINY, decoder=768, dtype=dtype)
    with torch.no_grad():
        for k, v in model.named_parameters():
            v.copy_(weights[k])
    return model


def rel(got, want):
    return float((got.detach().float() - want.detach()).abs().max() / want.detach().abs().max())


def images(n=2, seed=0):
    return torch.randn(n, 3, *HW, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_matches_the_reference(ref, train):
    weights = seeded(ref)
    model, x = tiny_model(weights), images()

    def gen():
        return torch.Generator().manual_seed(11) if train else None

    aux, main = model(x, train=train, update_stats=False, generator=gen())
    _, (feat, out) = ref.Net(**TINY)(weights, x, train, gen())
    assert aux is None and model.multi_level is False
    assert main["feat"].shape == (2, 768, *ref.feature_grid(HW)) == feat.shape
    assert main["out"].shape == (2, 19, 8, 16) == out.shape
    assert rel(main["feat"], feat) < TOL and rel(main["out"], out) < TOL
    _, (feat16, out16) = ref.Net(**TINY, compute=torch.bfloat16)(weights, x, train, gen())
    assert max(rel(feat16, feat), rel(out16, out)) > TOL
    if train:  # the draws land: another generator drops other samples and channels
        _, other = model(x, train=True, update_stats=False,
                         generator=torch.Generator().manual_seed(12))
        assert rel(other["feat"], feat) > 1e-2


def test_one_backward_matches_the_reference(ref):
    weights = seeded(ref)
    model, x = tiny_model(weights), images()
    labels = torch.randint(0, 19, (2, 8, 16), generator=torch.Generator().manual_seed(1))

    def loss(feat, out):
        return torch.nn.functional.cross_entropy(out, labels) + 1e-3 * (feat**2).mean()

    _, main = model(x, train=True, update_stats=False,
                    generator=torch.Generator().manual_seed(3))
    names = [k for k, _ in model.named_parameters()]
    got = dict(zip(names, torch.autograd.grad(loss(main["feat"], main["out"]),
                                              list(model.parameters()))))

    def reference_grads(compute):
        live = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
        _, (feat, out) = ref.Net(**TINY, compute=compute)(live, x, True,
                                                          torch.Generator().manual_seed(3))
        return dict(zip(names, torch.autograd.grad(loss(feat, out), [live[k] for k in names])))

    want, low = reference_grads(None), reference_grads(torch.bfloat16)
    median = statistics.median(float(g.norm()) for g in want.values())

    def worst(grads):  # each leaf's gap over max(its norm, the median leaf's)
        return max(float((grads[k] - want[k]).norm()) / max(float(want[k].norm()), median)
                   for k in names)

    assert worst(got) < TOL
    assert worst(low) > TOL


def test_label_params_on_the_segformer_layout(ref, tiny_registry):
    labels = optim.label_params(dict.fromkeys(ref.shapes(**TINY)), aux_grad=False)
    for name, label in labels.items():
        if name.startswith("decode_head.linear_fuse.bn."):
            assert label == optim.FROZEN, name
        elif name.startswith("decode_head."):
            assert label == optim.HEAD, name
        else:  # the encoder, LayerNorms' affines included: one update a step
            assert name.startswith("backbone.") and label == optim.BACKBONE, name
        assert (label != optim.FROZEN) == bool(ref.multiplicity(name, False))
    # DeepLab's labels do not move
    r50 = optim.label_params(dict.fromkeys(["conv1.weight", "bn1.weight", "layer1.0.conv1.weight",
                                            "layer1.0.downsample.0.weight", "layer6.head.1.weight",
                                            "layer5.head.1.weight"]), aux_grad=False)
    assert list(r50.values()) == [optim.BACKBONE, optim.FROZEN, 3, 4, optim.HEAD, optim.FROZEN]
    # the adapter takes the model's width for its prototypes and hands it its spans
    cfg = cfg_from_file(str(ROOT / "configs" / "hybrid_switch.yml"))
    cfg.MODEL.NAME, cfg.MODEL.LOAD = "SegFormer-B5", None
    spec = cfg.METHOD.ADAPTATION.PROTO_ONLINE_HYBRIDSWITCH
    spec.LOAD_PROTO = None
    model, variables = registry.get_model(cfg, 19, device="cpu")
    adapter = registry.get_adapt_method(cfg)(model, variables, cfg, spec, 19, device="cpu")
    assert adapter.state.proto.mean.shape == (19, 768)
    assert adapter.model.spans is adapter.spans
    assert adapter.param_labels == labels



@pytest.mark.parametrize("yml", ["advent.yml", "training_fog.yml"])
def test_every_adapter_hands_the_model_its_spans(tiny_registry, yml):
    """ADVENT's adapter and SEGMENT's trainer attach their span recorder to
    the model, as the prototype adapter does (above)."""
    from onda_torch.methods.segmentation import SegmentTrainer

    cfg = cfg_from_file(str(ROOT / "configs" / yml))
    cfg.MODEL.NAME, cfg.MODEL.LOAD = "SegFormer-B5", None
    model, variables = registry.get_model(cfg, 19, device="cpu")
    if yml == "training_fog.yml":
        adapter = SegmentTrainer(model, variables, cfg, cfg.METHOD.PRETRAIN.SEGMENT, 19,
                                 device="cpu")
    else:
        spec = cfg.METHOD.ADAPTATION[cfg.METHOD.ADAPTATION.NAME]
        adapter = registry.get_adapt_method(cfg)(model, variables, cfg, spec, 19, device="cpu")
    assert adapter.model.spans is adapter.spans

def test_registry_builds_and_loads_an_mmseg_checkpoint(ref, tiny_registry, tmp_path):
    cfg = default_config()
    cfg.MODEL.NAME = "SegFormer-B5"
    cfg.MODEL.MULTI_LEVEL = True
    model, variables = registry.get_model(cfg, 19, device="cpu")
    assert "SegFormer-B5" in registry.MODEL_NAMES and cfg.MODEL.MULTI_LEVEL is False
    assert {k: tuple(v.shape) for k, v in variables["params"].items()} == ref.shapes(**TINY)
    again, _ = registry.get_model(cfg, 19, device="cpu")  # the seeded default init
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))
    # mmseg's layout: the state_dict under "state_dict", BaseDecodeHead's unused conv_seg in it
    weights = seeded(ref, seed=9)
    sd = {**dict(tiny_model(weights).state_dict()),
          "decode_head.conv_seg.weight": torch.zeros(19, 128, 1, 1),
          "decode_head.conv_seg.bias": torch.zeros(19)}
    torch.save({"meta": {"CLASSES": 19}, "state_dict": sd}, tmp_path / "segformer.pth")
    cfg.MODEL.LOAD = str(tmp_path / "segformer.pth")
    loaded, _ = registry.get_model(cfg, 19, device="cpu")
    assert all(torch.equal(v, weights[k]) for k, v in loaded.named_parameters())
    del sd["backbone.norm4.weight"]  # the load is strict
    torch.save({"state_dict": sd}, tmp_path / "short.pth")
    cfg.MODEL.LOAD = str(tmp_path / "short.pth")
    with pytest.raises(RuntimeError, match="backbone.norm4.weight"):
        registry.get_model(cfg, 19, device="cpu")
    cfg.MODEL.LOAD, cfg.OTHERS.REMAT = None, True
    with pytest.raises(ValueError, match="REMAT"):
        registry.get_model(cfg, 19, device="cpu")


def test_bf16_precision_computes_in_bfloat16_over_float32_parameters(ref, tiny_registry):
    weights = seeded(ref)
    cfg = default_config()
    cfg.MODEL.NAME, cfg.OTHERS.PRECISION = "SegFormer-B5", "bf16"
    model, _ = registry.get_model(cfg, 19, device="cpu")
    with torch.no_grad():
        for k, v in model.named_parameters():
            v.copy_(weights[k])
    assert model.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    x = images()
    _, main = model(x, train=True, update_stats=False, generator=torch.Generator().manual_seed(4))
    _, (feat, out) = ref.Net(**TINY)(weights, x, True, torch.Generator().manual_seed(4))
    assert main["out"].dtype == main["feat"].dtype == torch.bfloat16
    # bfloat16's rounding: off the float32 reference by more than TOL, within a few %
    assert TOL < rel(main["out"], out) < 0.05
    main["out"].float().sum().backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    assert grads and all(g.dtype == torch.float32 for g in grads)
    assert model.backbone.block3[1].mlp.fc1.weight.grad.abs().sum() > 0


def test_spans_time_the_encoder_and_decoder_and_count_the_attentions(ref):
    model, spans = tiny_model(seeded(ref)), SpanRecorder("cpu", enabled=True)
    model.attach_spans(spans)
    with spans.step(0):
        spans.phase("dispatch")
        with spans.span("student", device=True):
            model(images(), train=True, update_stats=False, generator=torch.Generator())
    got = [(s.name, s.parent.name) for s in spans.ring[-1][2:]]
    blocks = sum(TINY["depths"])
    assert got == ([("student", "dispatch"), ("encoder", "student")]
                   + [("attention", "encoder")] * blocks + [("decoder", "student")])
    model(images())  # outside a step nothing is recorded
    assert len(spans.ring) == 1


def test_the_published_b5_layout():
    with torch.device("meta"):
        model = SegFormer(19)
    shapes = {k: tuple(v.shape) for k, v in model.named_parameters()}
    assert sum(math.prod(s) for s in shapes.values()) == 84607955
    assert [len(getattr(model.backbone, f"block{s}")) for s in range(1, 5)] == [3, 6, 40, 3]
    assert shapes["backbone.patch_embed1.proj.weight"] == (64, 3, 7, 7)
    assert shapes["backbone.block3.17.attn.sr.weight"] == (320, 320, 2, 2)
    assert shapes["backbone.block1.0.mlp.dwconv.dwconv.weight"] == (256, 1, 3, 3)
    assert shapes["backbone.block4.2.attn.kv.weight"] == (1024, 512)
    assert "backbone.block4.0.attn.sr.weight" not in shapes  # no reduction in stage 4
    assert shapes["backbone.norm4.weight"] == (512,)
    assert shapes["decode_head.linear_c1.proj.weight"] == (768, 64)
    assert shapes["decode_head.linear_fuse.conv.weight"] == (768, 3072, 1, 1)
    assert shapes["decode_head.linear_pred.weight"] == (19, 768, 1, 1)
    assert "decode_head.linear_fuse.bn.running_var" in dict(model.named_buffers())
    assert model.backbone.block3[39].drop_rate == pytest.approx(0.1 * 48 / 51)
    assert model.backbone.block1[0].attn.norm.eps == 1e-5
    assert model.backbone.block1[0].norm1.eps == model.backbone.norm1.eps == 1e-6
