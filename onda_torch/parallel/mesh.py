"""OTHERS.DATA_PARALLEL and the options the port runs on one device only
(`onda_tpu/parallel/mesh.py`).

The JAX package resolves OTHERS.DATA_PARALLEL into a 1-D `data` mesh over its
devices (`data_parallel_mesh`). A port rank is a JAX process with one device
(see `distributed`), so the mesh is the world of ranks and its size the world
size, under the same rules: unset means auto, False off, True all ranks, an
int n must equal the world size, the global batch must split evenly, and the
multi-process guards hold because every rank is a process. At world size 1
every value resolves to the one-device path, as JAX's `n <= 1 → None` does.

Where the port differs: DATA_PARALLEL false under a world size above 1 raises
(JAX would let each process train alone on its shard), and `refuse_unported`
stops what the port does not run across ranks yet (ROADMAP M17): ADVENT,
PROTO_ADVENT, EVALUATION mode and SEGMENT training under more than one rank,
and OTHERS.TENSOR_PARALLEL (`tensor_parallel_shardings`) everywhere.
"""

from __future__ import annotations

from ..config import unset
from . import distributed


def data_parallel_size(option, batch_size: int | None = None, world: int | None = None) -> int:
    """The number of ranks the step spans under OTHERS.DATA_PARALLEL = option
    (None for unset) with `world` ranks (default: this run's): 1 is the
    one-device path. Raises ValueError where JAX's `data_parallel_mesh` does
    with `world` processes of one device each, and for False above one rank."""
    n = distributed.world() if world is None else world
    if option is False:
        if n > 1:
            raise ValueError(f"DATA_PARALLEL=False with {n} ranks: every rank would train "
                             "alone on its shard; run one process, or drop the option")
        return 1
    if option is None or option is True:
        want = n
        if batch_size:
            while want > 1 and batch_size % want:
                want -= 1
        if option is True and want != n:
            raise ValueError(f"DATA_PARALLEL=True: BATCH_SIZE={batch_size} does not divide "
                             f"the {n} ranks")
        if want != n and n > 1:
            raise ValueError(f"BATCH_SIZE={batch_size} does not divide the {n} ranks of this "
                             "run")
    else:
        want = int(option)
        if batch_size and want > 1 and batch_size % want:
            raise ValueError(f"DATA_PARALLEL={want} does not divide BATCH_SIZE={batch_size}")
        if n > 1 and want != n:
            raise ValueError(f"DATA_PARALLEL={want} must equal the {n} ranks of this run")
    if want <= 1 or n <= 1:
        return 1
    return min(want, n)


def refuse_unported(cfg) -> int:
    """Raise, before anything trains or is written, for what the port does
    not run: OTHERS.TENSOR_PARALLEL, an OTHERS.DATA_PARALLEL that does not
    resolve against this run's ranks, and, under more than one rank, every
    path but the PROTO_ONLINE family's adaptation. Returns the data-parallel
    size (1: one device)."""
    tp = cfg.OTHERS.TENSOR_PARALLEL
    if tp is True or (not unset(tp) and tp not in (None, False) and int(tp) > 1):
        raise NotImplementedError("OTHERS.TENSOR_PARALLEL: the port does not shard the model "
                                  "(channel-wise tensor parallelism is ROADMAP M17)")
    dp = cfg.OTHERS.DATA_PARALLEL
    size = data_parallel_size(None if unset(dp) else dp, int(cfg.TRAINING.BATCH_SIZE))
    if size == 1:
        return 1
    where = f"OTHERS.DATA_PARALLEL across {size} ranks"
    pretrain = cfg.METHOD.PRETRAIN.NAME
    if pretrain == "EVALUATION":
        raise NotImplementedError(f"{where}: EVALUATION mode runs on one rank only "
                                  "(ROADMAP M17)")
    if pretrain == "SEGMENT" and int(cfg.METHOD.PRETRAIN.SEGMENT.EPOCHS) > 0:
        raise NotImplementedError(f"{where}: SEGMENT training (EPOCHS > 0) runs on one rank "
                                  "only (ROADMAP M17)")
    method = cfg.METHOD.ADAPTATION.NAME
    if method in ("ADVENT", "PROTO_ADVENT"):
        raise NotImplementedError(f"{where}: METHOD.ADAPTATION.NAME {method} runs on one rank "
                                  "only (ROADMAP M17)")
    return size
