"""SegFormer with the Mix Transformer encoder (MiT) and the all-MLP decoder,
the reference model of the configurations whose "model" is "segformer"
(Xie et al., arXiv:2105.15203; NVlabs/SegFormer
`mmseg/models/backbones/mix_transformer.py` and
`mmseg/models/decode_heads/segformer_head.py`). Its shape keys:
"embed_dims", "depths", "heads", "sr_ratios" (each a stage's) and
"mlp_ratio"; the decoder is FEATURES wide (B5: 64/128/320/512, 3/6/40/3,
1/2/5/8, 8/4/2/1, 4, decoder 768).

Parameter names follow NVlabs' checkpoints, which are the program's
(`onda_torch.models.segformer`). Every operation is plain torch: the
attention as q·kᵀ, softmax and ·v (so that `benchkit.counts` counts it),
LayerNorm by its mean and variance, GELU by erf, the depthwise 3×3 conv as
a grouped `F.conv2d`; each matmul and conv computes in `compute`.

One departure from the published description: drop path (0.1, linear over
the blocks) and the decoder's channel dropout (0.1) draw their masks from
the method's generator, in the program's order (for each stage and block,
the attention branch's mask and then the Mix-FFN's, where the block's rate
is above 0; then the dropout), so that both sides drop the same samples and
channels.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from benchkit import reference

SHAPE_KEYS = ("embed_dims", "depths", "heads", "sr_ratios", "mlp_ratio")
FEATURES = 768  # the decoder's width: the fused features, the prototypes' F
HEADS = ("decode_head.",)
DROP_PATH = 0.1
BLOCK_EPS, PATCH_EPS, SR_EPS = 1e-6, 1e-5, 1e-5
FUSE_BN = "decode_head.linear_fuse.bn"


def feature_grid(hw):
    """The 1/4 grid of an (H, W) input: the 7×7 stride-4 conv with padding 3."""
    return (hw[0] - 1) // 4 + 1, (hw[1] - 1) // 4 + 1


def _linear(out, cin, prefix):
    return {f"{prefix}.weight": (out, cin), f"{prefix}.bias": (out,)}


def _norm(width, prefix):
    return {f"{prefix}.weight": (width,), f"{prefix}.bias": (width,)}


def shapes(embed_dims, depths, heads, sr_ratios, mlp_ratio, classes: int = 19) -> dict:
    """name → shape of every parameter."""
    out, cin = {}, 3
    for s, (dim, depth, sr) in enumerate(zip(embed_dims, depths, sr_ratios), start=1):
        k = 7 if s == 1 else 3
        pre = f"backbone.patch_embed{s}"
        out.update({f"{pre}.proj.weight": (dim, cin, k, k), f"{pre}.proj.bias": (dim,),
                    **_norm(dim, f"{pre}.norm")})
        for j in range(depth):
            b = f"backbone.block{s}.{j}"
            out.update(_norm(dim, f"{b}.norm1"))
            out.update(_linear(dim, dim, f"{b}.attn.q"))
            out.update(_linear(2 * dim, dim, f"{b}.attn.kv"))
            out.update(_linear(dim, dim, f"{b}.attn.proj"))
            if sr > 1:
                out.update({f"{b}.attn.sr.weight": (dim, dim, sr, sr), f"{b}.attn.sr.bias": (dim,),
                            **_norm(dim, f"{b}.attn.norm")})
            out.update(_norm(dim, f"{b}.norm2"))
            hidden = dim * mlp_ratio
            out.update(_linear(hidden, dim, f"{b}.mlp.fc1"))
            out.update({f"{b}.mlp.dwconv.dwconv.weight": (hidden, 1, 3, 3),
                        f"{b}.mlp.dwconv.dwconv.bias": (hidden,)})
            out.update(_linear(dim, hidden, f"{b}.mlp.fc2"))
        out.update(_norm(dim, f"backbone.norm{s}"))
        cin = dim
    for s, dim in enumerate(embed_dims, start=1):
        out.update(_linear(FEATURES, dim, f"decode_head.linear_c{s}.proj"))
    out["decode_head.linear_fuse.conv.weight"] = (FEATURES, len(embed_dims) * FEATURES, 1, 1)
    out.update(_norm(FEATURES, FUSE_BN))
    out.update({"decode_head.linear_pred.weight": (classes, FEATURES, 1, 1),
                "decode_head.linear_pred.bias": (classes,)})
    return out


def multiplicity(name: str, aux_trained: bool) -> int:
    """One SGD update a step for every leaf, at the head's LR under
    `decode_head.`; 0 for the decoder BatchNorm's affine, frozen as every
    BatchNorm's is."""
    return 0 if name.startswith(FUSE_BN + ".") else 1


def layer_norm(x, w, b, eps):
    """LayerNorm over the last axis by its mean and biased variance."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps) * w + b


def gelu(x):
    """The exact GELU: x·Φ(x)."""
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def drop_path(x, rate, gen):
    """Each sample's residual branch dropped with probability `rate`, the
    kept ones scaled by 1/(1 − rate)."""
    keep = 1.0 - rate
    mask = torch.bernoulli(torch.full((x.shape[0],) + (1,) * (x.dim() - 1), keep,
                                      device=x.device), generator=gen)
    return x * mask / keep


def _image(x, h, w):
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], h, w)


def _tokens(x):
    return x.flatten(2).transpose(1, 2)


class Net(reference.Net):
    """The forward of one parameter set; `on_attention`, where set, is
    called with each attention's queries and keys (the attention bound's
    shapes)."""

    def __init__(self, embed_dims, depths, heads, sr_ratios, mlp_ratio, compute=None,
                 observe=None):
        super().__init__(compute, observe)
        self.embed_dims, self.depths = tuple(embed_dims), tuple(depths)
        self.heads, self.sr_ratios, self.mlp_ratio = tuple(heads), tuple(sr_ratios), mlp_ratio
        self.rates = torch.linspace(0, DROP_PATH, sum(self.depths), device="cpu").tolist()
        self.on_attention = None

    def matmul(self, a, b):
        cd = self.compute
        return a @ b if cd is None else (a.to(cd) @ b.to(cd)).float()

    def dwconv(self, x, w, b):
        cd = self.compute
        if cd is None:
            return F.conv2d(x, w, b, 1, 1, 1, x.shape[1])
        return F.conv2d(x.to(cd), w.to(cd), b.to(cd), 1, 1, 1, x.shape[1]).float()

    def attention(self, P, pre, x, h, w, heads, sr):
        n, length, c = x.shape
        d = c // heads
        q = self.linear(x, P[f"{pre}.q.weight"], P[f"{pre}.q.bias"])
        q = q.reshape(n, length, heads, d).transpose(1, 2)
        if sr > 1:
            x = _tokens(self.conv(_image(x, h, w), P[f"{pre}.sr.weight"], P[f"{pre}.sr.bias"],
                                  stride=sr))
            x = layer_norm(x, P[f"{pre}.norm.weight"], P[f"{pre}.norm.bias"], SR_EPS)
        kv = self.linear(x, P[f"{pre}.kv.weight"], P[f"{pre}.kv.bias"])
        k, v = kv.reshape(n, -1, 2, heads, d).permute(2, 0, 3, 1, 4)
        if self.on_attention is not None:
            self.on_attention(q, k)
        p = F.softmax(self.matmul(q * d**-0.5, k.transpose(-2, -1)), dim=-1)
        o = self.matmul(p, v).transpose(1, 2).reshape(n, length, c)
        return self.linear(o, P[f"{pre}.proj.weight"], P[f"{pre}.proj.bias"])

    def mix_ffn(self, P, pre, x, h, w):
        y = self.linear(x, P[f"{pre}.fc1.weight"], P[f"{pre}.fc1.bias"])
        y = _tokens(self.dwconv(_image(y, h, w), P[f"{pre}.dwconv.dwconv.weight"],
                                P[f"{pre}.dwconv.dwconv.bias"]))
        return self.linear(gelu(y), P[f"{pre}.fc2.weight"], P[f"{pre}.fc2.bias"])

    def encoder(self, P, x, train, gen):
        outs, i = [], 0
        for s, depth in enumerate(self.depths, start=1):
            pre = f"backbone.patch_embed{s}"
            k = 7 if s == 1 else 3
            x = self.conv(x, P[f"{pre}.proj.weight"], P[f"{pre}.proj.bias"], stride=4 if s == 1
                          else 2, padding=k // 2)
            h, w = x.shape[2:]
            x = layer_norm(_tokens(x), P[f"{pre}.norm.weight"], P[f"{pre}.norm.bias"], PATCH_EPS)
            for j in range(depth):
                b, rate = f"backbone.block{s}.{j}", self.rates[i]
                drop = train and gen is not None and rate > 0
                y = layer_norm(x, P[f"{b}.norm1.weight"], P[f"{b}.norm1.bias"], BLOCK_EPS)
                y = self.attention(P, f"{b}.attn", y, h, w, self.heads[s - 1], self.sr_ratios[s - 1])
                x = x + (drop_path(y, rate, gen) if drop else y)
                y = layer_norm(x, P[f"{b}.norm2.weight"], P[f"{b}.norm2.bias"], BLOCK_EPS)
                y = self.mix_ffn(P, f"{b}.mlp", y, h, w)
                x = x + (drop_path(y, rate, gen) if drop else y)
                i += 1
            x = layer_norm(x, P[f"backbone.norm{s}.weight"], P[f"backbone.norm{s}.bias"],
                           BLOCK_EPS)
            x = _image(x, h, w)
            outs.append(x)
        return outs

    def decoder(self, P, feats, train, gen):
        grid = feats[0].shape[2:]
        outs = []
        for s in range(len(feats), 0, -1):
            c = feats[s - 1]
            pre = f"decode_head.linear_c{s}.proj"
            y = _image(self.linear(_tokens(c), P[f"{pre}.weight"], P[f"{pre}.bias"]), *c.shape[2:])
            if s > 1:
                y = F.interpolate(y, size=grid, mode="bilinear", align_corners=False)
            outs.append(y)
        x = self.conv(torch.cat(outs, dim=1), P["decode_head.linear_fuse.conv.weight"])
        feat = F.relu(self.bn(P, FUSE_BN, x, train))
        if train and gen is not None:
            feat = self.dropout(feat, gen)
        return feat, self.conv(feat, P["decode_head.linear_pred.weight"],
                               P["decode_head.linear_pred.bias"])

    def __call__(self, P, x, train, gen=None, aux=False):
        """(None, (feat, logits)): there is no aux head."""
        return None, self.decoder(P, self.encoder(P, x, train, gen), train, gen)


@functools.lru_cache(maxsize=None)
def attention_shapes(embed_dims, depths, heads, sr_ratios, mlp_ratio, hw):
    """((heads, queries, keys, head width), ...) of every attention of one
    image's forward at (H, W), in call order, from the forward on the meta
    device."""
    calls = []
    net = Net(embed_dims, depths, heads, sr_ratios, mlp_ratio)
    net.on_attention = lambda q, k: calls.append((q.shape[1], q.shape[2], k.shape[2], q.shape[3]))
    P = {k: torch.empty(s, device="meta")
         for k, s in shapes(embed_dims, depths, heads, sr_ratios, mlp_ratio).items()}
    net(P, torch.empty(1, 3, *hw, device="meta"), False)
    return tuple(calls)


def attention_bound_s(calls, flops_peak: float, bytes_per_s: float, itemsize: int = 4) -> float:
    """The least time of one image's attentions: for each, the larger of
    its QKᵀ and PV operations (2·2·heads·queries·keys·width) at
    `flops_peak` and its Q, K, V and O bytes, each read or written once, at
    `bytes_per_s`; summed over the calls."""
    total = 0.0
    for heads, nq, nk, d in calls:
        flops = 4.0 * heads * nq * nk * d
        nbytes = itemsize * heads * d * (2 * nq + 2 * nk)
        total += max(flops / flops_peak, nbytes / bytes_per_s)
    return total
