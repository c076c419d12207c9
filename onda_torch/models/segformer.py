"""SegFormer: the Mix Transformer encoder (MiT) and the all-MLP decoder — PyTorch.

Xie et al., "SegFormer: Simple and Efficient Design for Semantic
Segmentation with Transformers" (arXiv:2105.15203), as NVlabs/SegFormer
builds it (`mmseg/models/backbones/mix_transformer.py`,
`mmseg/models/decode_heads/segformer_head.py`). Module names follow its
checkpoints' layout (`backbone.patch_embed1.proj.weight`,
`backbone.block3.17.attn.sr.weight`, `backbone.block1.0.mlp.dwconv.dwconv.weight`,
`backbone.norm4.weight`, `decode_head.linear_c1.proj.weight`,
`decode_head.linear_fuse.conv.weight`, `decode_head.linear_fuse.bn.*`,
`decode_head.linear_pred.*`), so that a published checkpoint maps one to one
(`registry.get_model` drops BaseDecodeHead's unused `decode_head.conv_seg`).

Each of the four stages: an overlapping patch embedding (a 7×7 stride-4
conv, then 3×3 stride-2 convs, each followed by LayerNorm), pre-LN blocks
x + drop_path(attn(LN(x))), x + drop_path(mix_ffn(LN(x))), and a LayerNorm.
The attention's queries stay at the stage's resolution; its keys and values
come from an sr×sr stride-sr conv and a LayerNorm of the tokens
(`ops.attention.sr_attention`). Mix-FFN is fc1 → depthwise 3×3 conv → exact
GELU → fc2. The decoder projects every stage to `decoder` channels,
upsamples them bilinearly to the 1/4 grid, concatenates them (the last stage
first), fuses them with a 1×1 conv, BatchNorm (`TorchBatchNorm`: K2 in train
mode) and ReLU, then channel dropout and the 1×1 classifier.

The call form is DeepLab-v2's: forward(x, train, update_stats, generator,
with_aux) → (None, {"feat": the post-dropout fused features (N, decoder, H/4,
W/4), "out": the logits on the same grid}); there is no aux head
(`multi_level` False). In train mode with a generator the stochastic draws
come from it in one order: for each stage and block in turn, the drop-path
masks of the attention branch and then of the Mix-FFN branch (only where the
block's rate, linear from 0 to `drop_path_rate` over the blocks, is above 0),
then the decoder's channel dropout. `dtype` is the compute dtype of every
conv, dense layer and attention (bf16 over f32 parameters); the norms take
their statistics in f32.

The span recorder that the adapter attaches (`attach_spans`) times each
forward's `encoder` and `decoder` on the device and each call of the
attention on the host (`attention`); without one the model records none. The tokens between layers are (N, H·W, C) and
contiguous; the convs see them as channels_last views.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sr_attention
from ..parallel import spatial as S
from ..utils.spans import SpanRecorder
from .layers import Conv2d, Dropout2d, LayerNorm, Linear, TorchBatchNorm, drop_path

BLOCK_EPS, PATCH_EPS, SR_EPS = 1e-6, 1e-5, 1e-5  # LayerNorm eps of mix_transformer.py


def _image(x, h: int, w: int):
    """(N, H·W, C) tokens as (N, C, H, W): a channels_last view of
    contiguous tokens."""
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], h, w)


def _tokens(x):
    """(N, C, H, W) → (N, H·W, C); a view of a channels_last tensor."""
    return x.flatten(2).transpose(1, 2)


class OverlapPatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int, patch: int, stride: int, dtype=None):
        super().__init__()
        self.proj = Conv2d(cin, dim, patch, stride=stride, padding=patch // 2, compute_dtype=dtype)
        self.norm = LayerNorm(dim, eps=PATCH_EPS)

    def forward(self, x):
        x = self.proj(x)
        h, w = x.shape[2:]
        return self.norm(_tokens(x)), h, w


class Attention(nn.Module):
    """Efficient self-attention with sequence reduction `sr_ratio`."""

    def __init__(self, dim: int, heads: int, sr_ratio: int, dtype=None):
        super().__init__()
        self.heads, self.sr_ratio = heads, sr_ratio
        self.q = Linear(dim, dim, compute_dtype=dtype)
        self.kv = Linear(dim, 2 * dim, compute_dtype=dtype)
        self.proj = Linear(dim, dim, compute_dtype=dtype)
        if sr_ratio > 1:
            self.sr = Conv2d(dim, dim, sr_ratio, stride=sr_ratio, compute_dtype=dtype)
            self.norm = LayerNorm(dim, eps=SR_EPS)

    def forward(self, x, h: int, w: int, spans):
        n, length, c = x.shape
        d = c // self.heads
        q = self.q(x).view(n, length, self.heads, d).transpose(1, 2)
        if self.sr_ratio > 1:
            x = self.norm(_tokens(self.sr(_image(x, h, w))))
        k, v = self.kv(x).view(n, -1, 2, self.heads, d).permute(2, 0, 3, 1, 4)
        with spans.span("attention"):
            o = sr_attention(q, k, v)
        return self.proj(o.transpose(1, 2).reshape(n, length, c))


class DWConv(nn.Module):
    def __init__(self, dim: int, dtype=None):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 3, padding=1, groups=dim, compute_dtype=dtype)

    def forward(self, x, h: int, w: int):
        return _tokens(self.dwconv(_image(x, h, w)))


class MixFFN(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype=None):
        super().__init__()
        self.fc1 = Linear(dim, hidden, compute_dtype=dtype)
        self.dwconv = DWConv(hidden, dtype)
        self.fc2 = Linear(hidden, dim, compute_dtype=dtype)

    def forward(self, x, h: int, w: int):
        return self.fc2(F.gelu(self.dwconv(self.fc1(x), h, w)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int, sr_ratio: int, drop_rate: float,
                 dtype=None):
        super().__init__()
        self.drop_rate = drop_rate
        self.norm1 = LayerNorm(dim, eps=BLOCK_EPS)
        self.attn = Attention(dim, heads, sr_ratio, dtype)
        self.norm2 = LayerNorm(dim, eps=BLOCK_EPS)
        self.mlp = MixFFN(dim, dim * mlp_ratio, dtype)

    def forward(self, x, h: int, w: int, train: bool, generator, spans):
        x = x + drop_path(self.attn(self.norm1(x), h, w, spans), self.drop_rate, train, generator)
        return x + drop_path(self.mlp(self.norm2(x), h, w), self.drop_rate, train, generator)


class MixVisionTransformer(nn.Module):
    """The MiT encoder: four stages, each (N, C_s, H/2^(s+1), W/2^(s+1))."""

    def __init__(self, embed_dims: Sequence[int], depths: Sequence[int], heads: Sequence[int],
                 sr_ratios: Sequence[int], mlp_ratio: int, drop_path_rate: float, dtype=None):
        super().__init__()
        rates = torch.linspace(0, drop_path_rate, sum(depths), device="cpu").tolist()
        cin, first = 3, 0
        for s, (dim, depth) in enumerate(zip(embed_dims, depths), start=1):
            patch, stride = (7, 4) if s == 1 else (3, 2)
            setattr(self, f"patch_embed{s}", OverlapPatchEmbed(cin, dim, patch, stride, dtype))
            setattr(self, f"block{s}", nn.ModuleList(
                Block(dim, heads[s - 1], mlp_ratio, sr_ratios[s - 1], rates[first + j], dtype)
                for j in range(depth)))
            setattr(self, f"norm{s}", LayerNorm(dim, eps=BLOCK_EPS))
            cin, first = dim, first + depth
        self.stages = len(depths)

    def forward(self, x, train: bool, generator, spans):
        outs = []
        for s in range(1, self.stages + 1):
            x, h, w = getattr(self, f"patch_embed{s}")(x)
            for block in getattr(self, f"block{s}"):
                x = block(x, h, w, train, generator, spans)
            x = _image(getattr(self, f"norm{s}")(x), h, w)
            outs.append(x)
        return outs


class MLP(nn.Module):
    """A stage's projection to the decoder's width (the head's `MLP`)."""

    def __init__(self, cin: int, width: int, dtype=None):
        super().__init__()
        self.proj = Linear(cin, width, compute_dtype=dtype)

    def forward(self, x):
        n, _, h, w = x.shape
        return _image(self.proj(_tokens(x)), h, w)


class ConvModule(nn.Module):
    """mmcv's ConvModule as `linear_fuse` builds it: 1×1 conv without bias,
    BatchNorm, ReLU."""

    def __init__(self, cin: int, cout: int, dtype=None):
        super().__init__()
        self.conv = Conv2d(cin, cout, 1, bias=False, compute_dtype=dtype)
        self.bn = TorchBatchNorm(cout)

    def forward(self, x, train: bool, update_stats: bool):
        return F.relu(self.bn(self.conv(x), train, update_stats))


class SegFormerHead(nn.Module):
    def __init__(self, in_dims: Sequence[int], width: int, num_classes: int, droprate: float,
                 dtype=None):
        super().__init__()
        for s, cin in enumerate(in_dims, start=1):
            setattr(self, f"linear_c{s}", MLP(cin, width, dtype))
        self.linear_fuse = ConvModule(len(in_dims) * width, width, dtype)
        self.dropout = Dropout2d(droprate)
        self.linear_pred = Conv2d(width, num_classes, 1, compute_dtype=dtype)
        self.stages = len(in_dims)

    def forward(self, feats, train: bool, update_stats: bool, generator):
        grid = feats[0].shape[2:]
        outs = []
        for s in range(self.stages, 0, -1):
            y = getattr(self, f"linear_c{s}")(feats[s - 1])
            if s > 1:
                y = F.interpolate(y, size=grid, mode="bilinear", align_corners=False)
            outs.append(y)
        x = self.linear_fuse(torch.cat(outs, dim=1), train, update_stats)
        feat = self.dropout(x, train, generator)
        return {"feat": feat, "out": self.linear_pred(feat)}


class SegFormer(nn.Module):
    multi_level = False

    def __init__(self, num_classes: int = 19, embed_dims=(64, 128, 320, 512),
                 depths=(3, 6, 40, 3), heads=(1, 2, 5, 8), sr_ratios=(8, 4, 2, 1),
                 mlp_ratio: int = 4, decoder: int = 768, drop_path_rate: float = 0.1,
                 droprate: float = 0.1, dtype=None):
        super().__init__()
        self.compute_dtype = dtype
        self.feature_width = decoder
        self.backbone = MixVisionTransformer(embed_dims, depths, heads, sr_ratios, mlp_ratio,
                                             drop_path_rate, dtype)
        self.decode_head = SegFormerHead(embed_dims, decoder, num_classes, droprate, dtype)
        self.spans = SpanRecorder("cpu")  # off until an adapter attaches its own

    def attach_spans(self, recorder: SpanRecorder) -> None:
        self.spans = recorder

    def forward(self, x, train=False, update_stats=True, generator=None, with_aux=True):
        if S.active():
            raise ValueError("SegFormer does not run on a spatial axis")
        spans = self.spans
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        with spans.span("encoder", device=True):
            feats = self.backbone(x, train, generator, spans)
        with spans.span("decoder", device=True):
            main = self.decode_head(feats, train, update_stats, generator)
        return None, main
