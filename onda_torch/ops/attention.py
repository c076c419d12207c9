"""Attention of the port's transformer models.

`sr_attention` is the core of SegFormer's efficient self-attention (Xie et
al., arXiv:2105.15203, §3.1): queries at the stage's full resolution, keys
and values from the sequence-reduced tokens. It is the one function the
model calls for it, so that its kernel can change without the model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sr_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q·kᵀ / √d)·v of (B, heads, N, d) queries against (B, heads,
    M, d) keys and values: (B, heads, N, d).

    PyTorch's `scaled_dot_product_attention`, which on a card takes its
    memory-efficient kernel in float32 (`fmha_cutlassF_f32_*`, backward
    `fmha_cutlassB_f32_*`: CUTLASS's float32 products as three TF32
    tensor-core products) and its flash kernel in bfloat16; neither keeps
    the (N, M) scores for the backward."""
    return F.scaled_dot_product_attention(q, k, v)
