"""Behavioural end-to-end in the port: online adaptation must recover accuracy
under a synthetic domain shift (`tests/test_adaptation_quality.py`'s check,
with its settings, through the port's trainer and adapter).

A tiny DeepLab is source-pretrained on a colour-coded segmentation task
(`onda_torch.data.synthetic.make_shift_dataset`) through the port's
SegmentTrainer, the colours are shifted for the target domain (accuracy
drops), then hybrid-switch online adaptation runs over the unlabeled target
stream in f32 and in bf16 (OTHERS.PRECISION): the target mIoU after
adaptation must beat the frozen source model's by 0.02. Source pretraining
is shared by a module fixture.

The model starts from the JAX test's initial weights (`model.init` with
key 0, carried across by `convert.flax_to_state_dict`). The pretraining's
400 steps do not follow JAX's (other dropout draws; the backbone's
gradients, through BatchNorms whose variance is taken in one pass, move by
several % under a last-bit change of the input), so the port pretrains
another model than the JAX test does, and whether adaptation then raises
the target's mIoU depends on that model:
`test_jax_adapter_moves_the_target_the_same_way` runs JAX's adapter from
the port's pretrained weights."""

import shutil

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from onda_tpu.models import build_deeplab_v2 as jax_build

from onda_torch.config import cfg_from_file, default_config
from onda_torch.data import Loader, SegmentationDataset
from onda_torch.data.metadata import load_dataset_info
from onda_torch.data.synthetic import make_shift_dataset
from onda_torch.methods.proto_online import ProtoOnlineAdapter
from onda_torch.methods.segmentation import SegmentTrainer
from onda_torch.models import build_deeplab_v2
from onda_torch.models.convert import flax_to_state_dict

W, H = 64, 32
C = 19  # full head; only 4 classes populated


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Torch on two threads in this file: the test run's workers share the
    host's cores, and one torch thread per core in each oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def make_loader(root, table, info, batch, shuffle, train=True, seed=0):
    ds = SegmentationDataset(
        root, table, dict(tuple(p) for p in info["label2train"]), (W, H),
        mean=np.array([123.675, 116.28, 103.53]), std=np.array([58.395, 57.12, 57.375]),
    )
    return Loader(ds, batch_size=batch, shuffle=shuffle, seed=seed,
                  drop_last=train, pad_last=not train, num_threads=1)


def base_cfg(snapshot_dir):
    cfg = cfg_from_file("configs/hybrid_switch.yml", default_config())
    cfg.SCHEME.RESOLUTION = [W, H]
    cfg.OTHERS.SNAPSHOT_DIR = str(snapshot_dir)
    cfg.TRAINING.BATCH_SIZE = 4
    return cfg


def initial_model():
    """The tiny model with the JAX test's initial weights."""
    variables = jax.jit(lambda: jax_build(num_classes=C, layers=(1, 1, 1, 1)).init(
        jax.random.key(0), jnp.zeros((1, H, W, 3)), train=False))()
    model = build_deeplab_v2(C, (1, 1, 1, 1))
    model.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, dict(variables))),
                          strict=True)
    return model


def split(table, set_):
    return table.where("set", [set_])


def pretrain(tmp, model):
    """Source-pretrain `model` through the port's SegmentTrainer with the JAX
    test's settings (100 epochs at a constant 0.01); returns the data, the
    trained variables, the source mIoU and the frozen model's target mIoU
    (the no-adaptation floor), populated classes only."""
    root = str(tmp / "ds")
    info = load_dataset_info()
    src = make_shift_dataset(root, shift=0.0, seed=0)
    trg = make_shift_dataset(root, shift=0.6, seed=1)
    cfg = base_cfg(tmp / "snaps")
    variables = {"params": dict(model.named_parameters()),
                 "batch_stats": dict(model.named_buffers())}
    seg_spec = cfg.METHOD.PRETRAIN.SEGMENT
    seg_spec.EPOCHS = 100
    seg_spec.LEARNING_RATE = 0.01
    seg_spec.POWER = 0
    trainer = SegmentTrainer(model, variables, cfg, seg_spec, num_classes=C, device="cpu")
    # the per-epoch snapshot is fixture overhead; checkpointing has its own tests
    mp = pytest.MonkeyPatch()
    mp.setattr(SegmentTrainer, "save_model", lambda self: None)
    try:
        trainer.train({"src": make_loader(root, split(src, "train"), info, 4, True)}, {})
    finally:
        mp.undo()
    src_val = make_loader(root, split(src, "val"), info, 4, False, train=False)
    iu_src, _ = trainer.evaluate(src_val)
    trg_val = make_loader(root, split(trg, "val"), info, 4, False, train=False)
    iu_before, _ = trainer.evaluate(trg_val)
    return {"root": root, "info": info, "src": src, "trg": trg, "tmp": tmp,
            "variables": {k: {n: t.clone() for n, t in v.items()}
                          for k, v in trainer.variables().items()},
            "state_dict": trainer.state_dict(),
            "miou_src": float(np.nanmean(iu_src[:4])),
            "miou_before": float(np.nanmean(iu_before[:4]))}


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """Source-pretrain once from the JAX test's initial weights; both
    precision variants adapt from these weights."""
    tmp = tmp_path_factory.mktemp("adapt_quality")
    out = pretrain(tmp, initial_model())
    assert out["miou_src"] > 0.6, f"pretraining failed to learn the toy task: {out['miou_src']}"
    yield out
    shutil.rmtree(tmp, ignore_errors=True)


def adaptation_spec(cfg, tag):
    spec = cfg.METHOD.ADAPTATION.PROTO_ONLINE_HYBRIDSWITCH
    spec.LOAD_PROTO = None
    spec.set_ = tag
    spec.EPOCHS = 3
    spec.SKIP_CALC = False
    spec.AVG_MONITOR_SIZE = 8
    return spec


def port_adaptation(p, precision="f32"):
    """The target mIoU after hybrid-switch adaptation in the port."""
    cfg = base_cfg(p["tmp"] / f"snaps_{precision}")
    cfg.OTHERS.PRECISION = precision
    spec = adaptation_spec(cfg, f"shift60_{precision}")
    # the shipped hybrid_switch.yml adaptation rate, as the JAX test keeps it
    assert float(spec.LEARNING_RATE) == 1e-5
    dtype = torch.bfloat16 if precision == "bf16" else None
    adapter = ProtoOnlineAdapter(build_deeplab_v2(C, (1, 1, 1, 1), dtype=dtype), p["variables"],
                                 cfg, spec, num_classes=C, device="cpu")
    root, info, src, trg = p["root"], p["info"], p["src"], p["trg"]
    adapter.train(make_loader(root, split(src, "train"), info, 4, True),
                  make_loader(root, split(trg, "train"), info, 4, True), {})
    hist = adapter.evaluate(make_loader(root, split(trg, "val"), info, 4, False, train=False))
    return float(np.nanmean(hist["model"][:4]))


def jax_adaptation(p):
    """(target mIoU before, after) of the JAX adapter in f32 from the port's
    pretrained weights, on the same files."""
    import pandas as pd

    from onda_tpu.config import cfg_from_file as jax_cfg_from_file
    from onda_tpu.config import default_config as jax_default_config
    from onda_tpu.data import Loader as JaxLoader
    from onda_tpu.data import SegmentationDataset as JaxDataset
    from onda_tpu.methods.proto_online import ProtoOnlineAdapter as JaxAdapter
    from onda_tpu.models.import_torch import torch_state_dict_to_flax

    def loader(table, set_, shuffle, train=True):
        frame = pd.DataFrame([r for r in table.rows if r["set"] == set_])
        ds = JaxDataset(p["root"], frame, dict(tuple(x) for x in p["info"]["label2train"]),
                        (W, H), mean=np.array([123.675, 116.28, 103.53]),
                        std=np.array([58.395, 57.12, 57.375]))
        return JaxLoader(ds, batch_size=4, shuffle=shuffle, seed=0, drop_last=train,
                         pad_last=not train, num_threads=1)

    model = jax_build(num_classes=C, layers=(1, 1, 1, 1))
    template = jax.eval_shape(lambda: model.init(jax.random.key(0), jnp.zeros((1, H, W, 3)),
                                                 train=False))
    variables = torch_state_dict_to_flax({k: v.numpy() for k, v in p["state_dict"].items()},
                                         dict(template))
    cfg = jax_cfg_from_file("configs/hybrid_switch.yml", jax_default_config())
    cfg.SCHEME.RESOLUTION = [W, H]
    cfg.OTHERS.SNAPSHOT_DIR = str(p["tmp"] / "snaps_jax")
    cfg.TRAINING.BATCH_SIZE = 4
    adapter = JaxAdapter(model, variables, cfg, adaptation_spec(cfg, "shift60_jax"),
                         num_classes=C)
    val = loader(p["trg"], "val", False, train=False)
    before = float(np.nanmean(adapter.evaluate(val)["model"][:4]))
    adapter.train(loader(p["src"], "train", True), loader(p["trg"], "train", True), {})
    return before, float(np.nanmean(adapter.evaluate(val)["model"][:4]))


@pytest.mark.slow
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_online_adaptation_recovers_miou(pretrained, precision):
    """Hybrid-switch adaptation over the unlabeled target stream in f32 and
    in bf16 (the compute precision of OTHERS.PRECISION)."""
    p = pretrained
    miou_after = port_adaptation(p, precision)
    print(f"[{precision}] source mIoU {p['miou_src']:.3f}; target before "
          f"{p['miou_before']:.3f} after {miou_after:.3f}")
    assert miou_after > p["miou_before"] + 0.02, (
        precision, p["miou_src"], p["miou_before"], miou_after)


# the two packages' changes of the target mIoU over adaptation from the same
# weights may differ by this much (3 epochs of a chaotic trajectory)
ADAPTATION_GAP = 0.05


@pytest.mark.slow
def test_jax_adapter_moves_the_target_the_same_way(pretrained):
    """From the same pretrained weights and files, JAX's adapter changes the
    target mIoU as the port's does (f32): whether the check above holds
    depends on the pretrained starting point, not on the package."""
    p = pretrained
    port_after = port_adaptation(p)
    jax_before, jax_after = jax_adaptation(p)
    print(f"source mIoU {p['miou_src']:.3f}; target before {p['miou_before']:.3f} (JAX "
          f"{jax_before:.3f}); after: port {port_after:.3f}, JAX {jax_after:.3f}")
    assert abs(jax_before - p["miou_before"]) <= 1e-3
    port_change, jax_change = port_after - p["miou_before"], jax_after - jax_before
    assert np.sign(port_change) == np.sign(jax_change)
    assert abs(port_change - jax_change) <= ADAPTATION_GAP, (port_change, jax_change)
