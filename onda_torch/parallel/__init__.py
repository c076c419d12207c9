"""Parallelism across ranks (`onda_tpu/parallel`): `distributed` (the
process group, the (data × model) grid and its groups, the reductions, the
rank-0 writer), `mesh` (OTHERS.DATA_PARALLEL and OTHERS.TENSOR_PARALLEL
resolved against the ranks, and the paths that refuse the latter),
`tensor` (JAX's channel-sharding rule and the autograd pieces of the
sharded model) and `shared_card` (collectives of ranks that share one card,
through its memory)."""
