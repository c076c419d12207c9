"""Tensor ops: the hand-written kernels and their wrappers, losses, metrics,
monitors, resizes and the prototype engine."""
