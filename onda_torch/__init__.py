"""onda_torch — the PyTorch/CUDA port of onda_tpu, online domain adaptation for
semantic segmentation, for NVIDIA Hopper (H100).

It mirrors the module layout of `onda_tpu` (config, registry, models, ops,
methods) and imports nothing of it. Plain tensor code is PyTorch; the two
kernels the JAX package wrote in Pallas are hand-written CUDA in `csrc/`
(K1: prototype pseudo-labels, K2: BatchNorm batch statistics), built at first
use and bound through `ops/kernels.py`. Entry points run on `cuda` unless the
caller passes `device="cpu"`.
"""

__version__ = "0.1.0"
