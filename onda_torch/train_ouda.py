"""Online domain adaptation CLI: `python -m onda_torch.train_ouda --cfg <yaml>`
(the port of `train_ouda.py`; reference train_ouda.py:60-261).

* EVALUATION mode (METHOD.PRETRAIN.NAME: EVALUATION): the runner loads the
  newest checkpoint of SNAPSHOT_DIR, then dumps the logits of every target
  domain (PREDICTION_SAVE), sweeps every checkpoint (OTHERS.EVAL_SWEEP) or
  evaluates every validation set; its spec is the ADAPTATION block overlaid
  by the EVALUATION block;
* SEGMENT source pretraining trains the student for EPOCHS on the source
  (none with `EPOCHS: 0`, as every shipped adaptation config has), then
  saves it as `model_train_{SOURCE}_after_src_training.pth` and adaptation
  starts from it;
* the replay buffer is drawn from the source train rows (a float
  REPLAY_BUFFER is a fraction, an int a count);
* AUTO_RESUME restores the newest whole snapshot of the method's own
  state (`advent_state*.pt` for ADVENT, `adapt_state*.pt` otherwise);
* the ordered target-domain loop applies the per-domain overrides
  (DOMAIN_OPTIONS / ORDER_OPTIONS) and `SKIP_CALC |= f_domain`, so that
  only the first domain bootstraps prototypes and evaluates before adapting;
  model, teachers, prototypes and monitors carry over between domains.

Data parallelism (OTHERS.DATA_PARALLEL, unset meaning auto): launched as
`torchrun --nproc-per-node N -m onda_torch.train_ouda --cfg <yaml>`, one
process per rank, TRAINING.BATCH_SIZE the global batch. Each rank loads its
disjoint shard of every metadata table at the local batch size (every
world-th row, the uneven tail dropped on every rank) and, under
BUFFER_DYNAMIC, keeps its own replay buffer over its shard of the sample,
seeded with the seed plus its rank; rank 0 alone writes metrics, checkpoints,
pickles and prediction dumps. Every path runs across ranks: the PROTO_ONLINE
family, ADVENT and PROTO_ADVENT, SEGMENT training (every rank trains on its
source shard; `_after_src_training.pth` is written once and adaptation goes
on from the weights in memory on every rank) and EVALUATION mode (the
checkpoint to load, the sweep's list and AUTO_RESUME's pick are rank 0's,
taken on every rank). OTHERS.TENSOR_PARALLEL stops before anything is
written, on any number of ranks (`parallel.mesh.refuse_unported`).

Under OTHERS.ASYNC_SAVE the checkpoints are written in the background;
`main` waits for every write, and raises a failed one, before it returns. It
runs on the card (`--device cuda`, the default) unless asked for the CPU;
without a card it stops.
"""

from __future__ import annotations

import argparse
import os
from pprint import pprint

import numpy as np
import torch


def get_arguments(argv=None):
    parser = argparse.ArgumentParser(description="Online domain adaptation (OnDA), PyTorch")
    parser.add_argument("--cfg", type=str, required=True, help="config file")
    parser.add_argument("--wandb", action="store_true", help="also log to wandb")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return parser.parse_args(argv)


def getf(x):
    return next(iter(x))


def main(argv=None):
    """Run the CLI; returns the adapter after the last domain (the runner in
    EVALUATION mode). Every checkpoint write still in flight (OTHERS.ASYNC_SAVE)
    is waited for before it returns or raises; then the process leaves its
    process group, if it joined one."""
    from .parallel import distributed
    from .utils.checkpoint import wait_for_saves

    try:
        return _main(argv)
    finally:
        try:
            wait_for_saves()
        finally:
            distributed.destroy()


def _main(argv):
    args = get_arguments(argv)
    from .config import cfg_from_file, default_config, unset
    from .data import Loader, ReplayBuffer, SegmentationDataset, Table
    from .native import BatchExecutor
    from .parallel import distributed
    from .parallel.mesh import refuse_unported
    from .registry import get_adapt_method, get_db, get_model
    from .utils.logging_ import Logger

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run on a card, or pass --device cpu")
    device = distributed.initialize(device)  # a no-op outside torchrun

    cfg = cfg_from_file(args.cfg, default_config())
    if distributed.is_primary():
        print("Using config:")
        pprint(cfg.to_dict())
    # before anything trains: SEGMENT pretraining would otherwise run in full
    world = refuse_unported(cfg)
    rank = distributed.rank()
    np.random.seed(int(cfg.TRAINING.RANDOM_SEED))

    datasets = get_db(cfg)
    info = datasets["db_info"]
    cfg.classnum_to_label = info["classnum_to_label"]
    num_classes = len(info["label"])
    cfg.NUM_CLASSES = num_classes

    model, variables = get_model(cfg, num_classes, device=device)
    print("Model has been Loaded")

    logger = Logger(project="OUDA", config=cfg.to_dict(), log_dir=str(cfg.OTHERS.SNAPSHOT_DIR),
                    use_wandb=args.wandb)

    # db_std is gated on SCHEME.MEAN, not on STD, as in the reference
    # (reference train_ouda.py:101-110): STD without MEAN is ignored
    db_mean = info["mean"] if unset(cfg.SCHEME.MEAN) or cfg.SCHEME.MEAN is None else cfg.SCHEME.MEAN
    db_std = info["std"] if unset(cfg.SCHEME.MEAN) or cfg.SCHEME.MEAN is None else cfg.SCHEME.STD
    original = not (unset(cfg.SCHEME.ORIGINAL_RES) or cfg.SCHEME.ORIGINAL_RES == cfg.SCHEME.RESOLUTION)
    label2train = dict(tuple(pair) for pair in info["label2train"])
    workers = max(int(cfg.OTHERS.NUM_WORKERS), 1)
    executor = BatchExecutor(workers)

    def ds(frame, raw_labels=False):
        return SegmentationDataset(str(cfg.SCHEME.PATH), frame, label2train, cfg.SCHEME.RESOLUTION,
                                   mean=np.asarray(db_mean), std=np.asarray(db_std),
                                   original_label=original and raw_labels, executor=executor)

    def dl(frame, shuffle, train=True, raw_labels=False):
        # this rank's shard at the local batch size: every rank has as many rows
        # and batches, so their collective calls pair up
        frame = frame.take(distributed.shard_rows(len(frame)))
        return Loader(ds(frame, raw_labels), batch_size=int(cfg.TRAINING.BATCH_SIZE) // world,
                      shuffle=shuffle, seed=int(cfg.TRAINING.RANDOM_SEED), drop_last=train,
                      pad_last=not train, num_threads=workers, pin_memory=device.type == "cuda")

    def val_dl(frame):
        # under ORIGINAL_RES only validation batches carry label_raw: SEGMENT's
        # evaluation is its one reader
        return dl(frame, False, train=False, raw_labels=True)

    src_train = Table.concat(getf(db["train"].values()) for db in datasets["domains_src"])
    source_dataloader = {"src": dl(src_train, bool(cfg.TRAINING.SHUFFLE))}
    validation_sets = {}
    if datasets["domains_src"] and datasets["domains_src"][0]["val"]:
        for dom in datasets["domains_src"]:
            validation_sets[getf(dom["val"].keys())] = val_dl(getf(dom["val"].values()))
        for trg_domain in datasets["domains_trg"]:
            if trg_domain["val"]:
                validation_sets[getf(trg_domain["train"].keys())] = val_dl(
                    getf(trg_domain["val"].values()))

    if cfg.METHOD.PRETRAIN.NAME == "EVALUATION":
        from .methods.evaluation import EvaluationRunner

        cfg_spec = cfg.METHOD.PRETRAIN["EVALUATION"]
        runner = EvaluationRunner(model, variables, cfg, _with_adapt_defaults(cfg, cfg_spec),
                                  num_classes, logger, device=device)
        if "PREDICTION_SAVE" in cfg_spec:
            for trg_domain in datasets["domains_trg"]:
                runner.cfg_spec.set_ = getf(trg_domain["train"].keys())
                runner.run_predictions(dl(getf(trg_domain["train"].values()), False, train=False))
        elif isinstance(cfg.OTHERS.EVAL_SWEEP, (bool, int, float)) and cfg.OTHERS.EVAL_SWEEP:
            # a number keeps polling for new checkpoints for that many quiet seconds
            wait = 0.0 if cfg.OTHERS.EVAL_SWEEP is True else float(cfg.OTHERS.EVAL_SWEEP)
            runner.sweep_checkpoints(validation_sets, wait_seconds=wait)
        else:
            logger.log(runner.evaluate_all(validation_sets))
        logger.close()
        return runner

    if cfg.METHOD.PRETRAIN.NAME == "SEGMENT":
        variables = _segment_pretraining(cfg, model, variables, num_classes, logger, device,
                                         source_dataloader, validation_sets)

    seed = int(cfg.TRAINING.RANDOM_SEED)
    buff_size = cfg.TRAINING.REPLAY_BUFFER
    if isinstance(buff_size, float):
        src_sample = src_train.sample(frac=buff_size, random_state=seed)
    else:
        src_sample = src_train.sample(n=min(int(buff_size), len(src_train)), random_state=seed)
    if buff_size == 0:
        src_loader = None
    elif isinstance(cfg.TRAINING.BUFFER_DYNAMIC, bool) and cfg.TRAINING.BUFFER_DYNAMIC:
        # each rank keeps a disjoint buffer and draws its slice of every global
        # replay batch (JAX's per-host buffer)
        src_loader = ReplayBuffer(ds(src_sample.take(distributed.shard_rows(len(src_sample)))),
                                  int(cfg.TRAINING.BATCH_SIZE) // world, seed=seed + rank)
        print(f"Buffer size: {src_loader.nbytes() / 1024**2:.1f} MB")
    else:
        src_loader = dl(src_sample, True)
    print("Starting UDA")

    cfg_spec = cfg.METHOD.ADAPTATION[cfg.METHOD.ADAPTATION.NAME]
    adapter = get_adapt_method(cfg)(model, variables, cfg, cfg_spec, num_classes, logger,
                                    device=device)
    auto_resume = cfg.OTHERS.AUTO_RESUME
    if isinstance(auto_resume, bool) and auto_resume:
        resume(adapter, cfg)

    f_domain = False
    for order, trg_domain in enumerate(datasets["domains_trg"]):
        set_ = getf(trg_domain["train"].keys())
        trg_loader = dl(getf(trg_domain["train"].values()),
                        bool(cfg.TRAINING.SHUFFLE) or unset(cfg.TRAINING.SHUFFLE))
        validation_method = cfg.OTHERS.VALIDATION
        if validation_method == "all":
            val_set = validation_sets
        elif validation_method == "single":
            val_set = {set_: val_dl(getf(trg_domain["val"].values()))}
        elif validation_method == "none":
            val_set = {}
        else:
            raise ValueError(f"cfg.OTHERS.VALIDATION value error: {validation_method}")
        cfg_spec.set_ = set_
        if not unset(cfg.SCHEME.DOMAIN_OPTIONS) and str(set_) in cfg.SCHEME.DOMAIN_OPTIONS:
            for key, value in cfg.SCHEME.DOMAIN_OPTIONS[str(set_)].items():
                print(f"Selecting values for domain {key}:{value}")
                cfg_spec[key] = value
        if not unset(cfg.SCHEME.ORDER_OPTIONS) and order in cfg.SCHEME.ORDER_OPTIONS:
            for key, value in cfg.SCHEME.ORDER_OPTIONS[order].items():
                print(f"Selecting values for domain {key}:{value}")
                cfg_spec[key] = value
        cfg_spec.SKIP_CALC |= f_domain
        f_domain = True
        adapter.update_cfg_spec(cfg_spec)
        adapter.train(src_loader, trg_loader, val_set)
    logger.close()
    return adapter


def resume(adapter, cfg):
    """AUTO_RESUME, crash recovery: restore the newest whole snapshot of
    SNAPSHOT_DIR that the adapter's own state tree holds (an exact resume:
    `advent_state*.pt` for ADVENT, `adapt_state*.pt` otherwise); returns its
    path, or None. An adapter with prototypes then skips their bootstrap.
    Under data parallelism every rank restores rank 0's pick."""
    from .utils.checkpoint import checkpoints_by_mtime

    snap_dir = str(cfg.OTHERS.SNAPSHOT_DIR)
    prefixes = ("advent_state",) if cfg.METHOD.ADAPTATION.NAME == "ADVENT" else ("adapt_state",)
    listed = (checkpoints_by_mtime(snap_dir, prefixes, allow_pth=False)
              if os.path.isdir(snap_dir) else [])
    # rank 0's list, loaded on every rank or skipped on every rank
    cand = adapter.load_newest(listed, "AUTO_RESUME")
    if cand is not None:
        print(f"AUTO_RESUME: restoring {cand}")
        if hasattr(adapter, "skip_proto"):
            adapter.skip_proto = True
    return cand


def _segment_pretraining(cfg, model, variables, num_classes, logger, device, source_dataloader,
                         validation_sets):
    """SEGMENT: train the student on the source for EPOCHS (none with
    `EPOCHS: 0`), then save it; returns the variables adaptation starts from.
    The trainer, its momentum on the card with it, ends with the call."""
    from .utils.checkpoint import save_atomic

    if int(cfg.METHOD.PRETRAIN.SEGMENT.EPOCHS) > 0:
        from .methods.segmentation import SegmentTrainer

        trainer = SegmentTrainer(model, variables, cfg, cfg.METHOD.PRETRAIN.SEGMENT,
                                 num_classes, logger, device=device)
        # pretraining is evaluated on the source and every target val set
        # (the reference's validation dict aliases both, train_ouda.py:146-156)
        trainer.train(source_dataloader, validation_sets)
        variables = {"params": trainer.params, "batch_stats": trainer.batch_stats}
        source_model = trainer.state_dict()
    else:
        source_model = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    # after SEGMENT, even a 0-epoch one, the source model is saved as the
    # student's state_dict in the reference's key layout (reference
    # train_ouda.py:185-197); adaptation starts from it
    pth = os.path.join(str(cfg.OTHERS.SNAPSHOT_DIR),
                       f"model_train_{cfg.SCHEME.SOURCE}_after_src_training.pth")
    save_atomic(source_model, pth)
    return variables


def _with_adapt_defaults(cfg, eval_spec):
    """The EVALUATION spec: the adaptation block overlaid by the evaluation
    block (reference train_ouda.py:307-313)."""
    if cfg.METHOD.ADAPTATION.NAME:
        merged = cfg.METHOD.ADAPTATION[cfg.METHOD.ADAPTATION.NAME].copy()
        merged.update(eval_spec)
        return merged
    return eval_spec


if __name__ == "__main__":
    main()
