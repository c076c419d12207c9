"""Data parallelism across ranks (`onda_tpu/parallel`): `distributed` (the
process group, the reductions, the rank-0 writer), `mesh` (OTHERS.DATA_PARALLEL
and the options that stay on one rank)."""
