"""Discriminators of the adversarial methods (`onda_tpu/models/discriminator.py`), NCHW.

`FCDiscriminator` (reference framework/model/discriminator.py:4-15): five
4×4 stride-2 convolutions with bias, C→64→128→256→512→1, LeakyReLU(0.2)
between them: a map of logits over an entropy image. `DCGANDiscriminator`
(reference :18-38; no shipped config uses it): BatchNorm between the conv
stages and a sigmoid output. Module names follow the JAX package's
(`conv0`..`conv4`, `bn1`..`bn3`), so `convert.flax_disc_to_state_dict` maps
one onto the other.

Under OTHERS.TENSOR_PARALLEL an `FCDiscriminator`'s parameters may be channel
shards (`parallel.tensor`): JAX's rule shards `conv1`-`conv3` (128, 256 and
512 channels) and leaves `conv0` (64) and `conv4` (1) whole. Each sharded
conv takes its whole input through `fan_in` and its activation is gathered
before the next conv, as the backbone's are. With whole parameters none of
it does anything.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import tensor as T
from .layers import TorchBatchNorm


class FCDiscriminator(nn.Module):
    def __init__(self, in_channels: int = 19, ndf: int = 64):
        super().__init__()
        widths = (in_channels, ndf, ndf * 2, ndf * 4, ndf * 8, 1)
        for i in range(5):
            self.add_module(f"conv{i}", nn.Conv2d(widths[i], widths[i + 1], 4, stride=2, padding=1))

    def forward(self, x):
        for i in range(4):
            conv = getattr(self, f"conv{i}")
            x = F.leaky_relu(conv(T.fan_in(x, conv)[0]), negative_slope=0.2)
            if T.shards(conv) > 1:
                x = T.gather_channels(x)
        return self.conv4(x)


class DCGANDiscriminator(nn.Module):
    def __init__(self, in_channels: int = 19, ndf: int = 64):
        super().__init__()
        self.conv0 = nn.Conv2d(in_channels, ndf, 4, stride=2, padding=1, bias=False)
        for i, mult in enumerate((2, 4, 8), start=1):
            self.add_module(f"conv{i}", nn.Conv2d(ndf * mult // 2, ndf * mult, 4, stride=2,
                                                  padding=1, bias=False))
            self.add_module(f"bn{i}", TorchBatchNorm(ndf * mult))
        self.conv4 = nn.Conv2d(ndf * 8, 1, 4, stride=1, padding=0, bias=False)

    def forward(self, x, train: bool = False, update_stats: bool = True):
        x = F.leaky_relu(self.conv0(x), negative_slope=0.2)
        for i in (1, 2, 3):
            x = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x), train, update_stats)
            x = F.leaky_relu(x, negative_slope=0.2)
        return torch.sigmoid(self.conv4(x))


def seeded_fc_discriminator(in_channels: int, seed: int) -> dict:
    """The parameters of an `FCDiscriminator` with PyTorch's default init
    drawn from the global generator seeded to `seed`, on the CPU."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        disc = FCDiscriminator(in_channels)
    return {k: v.detach() for k, v in disc.named_parameters()}
