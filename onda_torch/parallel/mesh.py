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

The spatial axis has no config key, in JAX or here: JAX reaches it through
`make_mesh(shape=(d, s), axes=("data", "spatial"))`, the port through
`spatial_grid((d, s))`, which arranges torchrun's ranks as that grid before
the adapter is made (`parallel.spatial` shards the image's rows over the
spatial axis). It runs what JAX runs on it: the PROTO_ONLINE bootstrap and
fused step. `resolve` keeps the grid for the adapter that asks for it
(`spatial=True`) and raises for every other caller (the CLI, ADVENT,
PROTO_ADVENT, SEGMENT, EVALUATION) and for OTHERS.TENSOR_PARALLEL with it.
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


def spatial_grid(shape, batch_size: int | None = None) -> tuple[int, int]:
    """Arrange this run's ranks as a (data × spatial) grid of `shape` (d, s),
    JAX's `make_mesh(shape=(d, s), axes=("data", "spatial"))`: rank r at data
    index r // s and spatial index r % s (`distributed.form_grid`, a
    collective every rank joins). Each rank then takes its data index's rows
    of every global batch and its spatial index's block of their image rows
    (`spatial.shard_rows`). Raises ValueError for a grid that is not the
    ranks', and for a `batch_size` that the data axis does not divide.
    Returns (d, s)."""
    d, s = (int(v) for v in shape)
    n = distributed.world()
    if d < 1 or s < 1 or d * s != n:
        raise ValueError(f"a (data × spatial) grid of {d} × {s} needs {d * s} ranks; this run "
                         f"has {n}: the spatial axis must divide the ranks")
    if batch_size and batch_size % d:
        raise ValueError(f"BATCH_SIZE={batch_size} does not divide the data axis of {d}")
    distributed.form_grid(1, s)
    return d, s


def resolve(cfg, spatial: bool = False) -> tuple[int, int]:
    """`data_axis`, then the grid of this run's ranks formed
    (`distributed.form_grid`, a collective every rank joins); returns the
    (data, model) axis sizes. On a spatial grid (`spatial_grid`) the grid is
    kept for a caller that runs on it (`spatial`), which gets (data, 1);
    every other caller, OTHERS.TENSOR_PARALLEL and a batch the data axis
    does not divide raise ValueError."""
    if distributed.spatial_world() > 1:
        sp = distributed.spatial_world()
        if not spatial:
            raise ValueError(f"a spatial axis of {sp} runs the PROTO_ONLINE bootstrap and fused "
                             "step only (as JAX's make_mesh does): not the CLI, evaluation, "
                             "ADVENT, PROTO_ADVENT or SEGMENT")
        tp = _tensor_parallel_option(cfg)
        if tp is True or (tp not in (None, False) and int(tp) > 1):
            raise ValueError(f"OTHERS.TENSOR_PARALLEL={tp} does not combine with the spatial axis")
        data, batch = distributed.data_world(), int(cfg.TRAINING.BATCH_SIZE)
        if batch % data:
            raise ValueError(f"BATCH_SIZE={batch} does not divide the data axis of {data}")
        return data, 1
    data = data_axis(cfg)
    model = grid_shape(_tensor_parallel_option(cfg))[1]
    distributed.form_grid(model)
    return data, model
