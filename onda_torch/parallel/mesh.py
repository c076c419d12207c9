"""OTHERS.DATA_PARALLEL and OTHERS.TENSOR_PARALLEL: the grid of ranks
(`onda_tpu/parallel/mesh.py`).

The JAX package resolves OTHERS.DATA_PARALLEL into a 1-D `data` mesh over its
devices (`data_parallel_mesh`), and OTHERS.TENSOR_PARALLEL = tp into a 2-D
(data × model) mesh (`data_parallel_setup`) whose model axis shards the
channels (`tensor_parallel_shardings`). A port rank is a JAX process with one
device (see `distributed`), so the mesh is the world of ranks:

* DATA_PARALLEL, under the JAX rules: unset means auto, False off, True all
  ranks, an int n must equal the world size, the global batch must split
  evenly, and the multi-process guards hold because every rank is a process.
  At world size 1 every value resolves to the one-device path, as JAX's
  `n <= 1 → None` does.
* TENSOR_PARALLEL = tp ≥ 2: a (world // tp) × tp grid, rank r at
  (r // tp, r % tp) (`distributed.form_grid`); DATA_PARALLEL is then ignored,
  as JAX ignores it. True raises, and so does a tp that does not divide the
  ranks, with JAX's words. 1, False or unset is the data-parallel path.

Where the port differs: DATA_PARALLEL false under a world size above 1 raises
(JAX would let each process train alone on its shard); where JAX would cap the
data axis to divide the batch and leave devices idle, the port raises (an idle
rank is a process that trains nothing); JAX's single-process rule for
TENSOR_PARALLEL is its runtime's, not the maths', and the port has none.
TENSOR_PARALLEL runs on every path of the CLI, as JAX's `data_parallel_setup`
serves every adapter: the PROTO_ONLINE family, ADVENT, PROTO_ADVENT, SEGMENT
training and EVALUATION mode.
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


def grid_shape(option, batch_size: int | None = None,
               world: int | None = None) -> tuple[int, int]:
    """(data, model) axis sizes under OTHERS.TENSOR_PARALLEL = option (None
    for unset) with `world` ranks (default: this run's); (world, 1) when the
    option asks for no model axis. Raises ValueError where JAX's
    `data_parallel_setup` does, and where JAX would cap the data axis."""
    n = distributed.world() if world is None else world
    if option is True:
        raise ValueError("TENSOR_PARALLEL must be an integer ≥ 2 (the number of model-axis "
                         "shards), not a boolean")
    tp = 0 if option in (None, False) else int(option)
    if tp <= 1:
        return n, 1
    if n % tp:
        raise ValueError(f"TENSOR_PARALLEL={tp} does not divide the {n} ranks")
    data = n // tp
    if batch_size and batch_size % data:
        raise ValueError(f"TENSOR_PARALLEL={tp}: BATCH_SIZE={batch_size} does not divide the "
                         f"data axis of {data} ({n} ranks); JAX would leave ranks idle")
    return data, tp


def _tensor_parallel_option(cfg):
    tp = cfg.OTHERS.TENSOR_PARALLEL
    return None if unset(tp) else tp


def data_axis(cfg) -> int:
    """The data axis's size (1: one device) of cfg's run on this run's
    ranks, before anything trains or is written; raises ValueError for a
    grid or an OTHERS.DATA_PARALLEL that does not resolve against them."""
    tp = _tensor_parallel_option(cfg)
    batch = int(cfg.TRAINING.BATCH_SIZE)
    data, model = grid_shape(tp, batch)
    if model > 1:
        return data
    dp = cfg.OTHERS.DATA_PARALLEL
    return data_parallel_size(None if unset(dp) else dp, batch)


def resolve(cfg) -> tuple[int, int]:
    """`data_axis`, then the grid of this run's ranks formed
    (`distributed.form_grid`, a collective every rank joins); returns the
    (data, model) axis sizes."""
    data = data_axis(cfg)
    model = grid_shape(_tensor_parallel_option(cfg))[1]
    distributed.form_grid(model)
    return data, model
