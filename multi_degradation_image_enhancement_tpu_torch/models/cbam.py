"""CBAM (Convolutional Block Attention Module), NCHW.

Counterpart of ``multi_degradation_image_enhancement_tpu/models/cbam.py:29-156``
with the reference's module names (``ChannelGate.mlp.{1,3}``,
``SpatialGate.spatial.{conv,bn}``), so a reference state_dict loads as is.

Only what CDAN uses is ported: avg + max pools and the spatial gate always
on.  The ``lp`` / ``lse`` pool variants and ``no_spatial`` are listed in
ROADMAP.md.  The spatial gate's BatchNorm follows Flax in train and refresh
mode (``models.norm.BatchNorm2d``: biased running variance, Flax momentum 0.99
= torch momentum 0.01, ``cbam.py:29-62``).  On an H shard (the ``spatial``
mesh axis) the channel gate pools over the whole image and the 7×7 conv
reads three halo rows each side (``models.halo``).
"""

from __future__ import annotations

import torch
from torch import nn

from multi_degradation_image_enhancement_tpu_torch.models.halo import conv_same
from multi_degradation_image_enhancement_tpu_torch.models.norm import BatchNorm2d, Rematerialized
from multi_degradation_image_enhancement_tpu_torch.parallel import collectives


class BasicConv(nn.Module):
    """Conv (no bias) → BN(eps 1e-5, momentum 0.01), as the spatial gate uses
    the reference's ``BasicConv`` (``models/cbam.py:6-20``, ReLU off)."""

    def __init__(self, in_planes: int, out_planes: int, kernel_size: int):
        super().__init__()
        self.conv = nn.Conv2d(
            in_planes, out_planes, kernel_size, padding=kernel_size // 2, bias=False
        )
        self.bn = BatchNorm2d(out_planes, eps=1e-5, momentum=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(conv_same(self.conv, x))


class ChannelGate(nn.Module):
    """Shared MLP over the avg- and max-pooled channel vectors, summed before
    the sigmoid."""

    def __init__(self, gate_channels: int, reduction_ratio: int = 16):
        super().__init__()
        self.mlp = nn.Sequential(
            nn.Flatten(),
            nn.Linear(gate_channels, gate_channels // reduction_ratio),
            nn.ReLU(),
            nn.Linear(gate_channels // reduction_ratio, gate_channels),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shards = collectives.spatial_shards()
        if shards == 1:
            avg = x.mean(dim=(2, 3))
        else:  # the whole image's mean and max across the spatial axis
            avg = collectives.spatial_sum(x.mean(dim=(2, 3)) * (1.0 / shards))
        att = self.mlp(avg) + self.mlp(collectives.spatial_amax(x, (2, 3)))
        return x * torch.sigmoid(att)[:, :, None, None]


class SpatialGate(nn.Module):
    """[max, mean] over channels (in that order) → 7×7 conv + BN → sigmoid."""

    def __init__(self):
        super().__init__()
        self.spatial = BasicConv(2, 1, 7)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        compress = torch.cat([x.amax(dim=1, keepdim=True), x.mean(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.spatial(compress))


class CBAM(Rematerialized):
    """Channel gate, then spatial gate (reference ``models/cbam.py:84-95``);
    one rematerialised block under ``remat``."""

    def __init__(self, gate_channels: int, reduction_ratio: int = 16):
        super().__init__()
        self.ChannelGate = ChannelGate(gate_channels, reduction_ratio)
        self.SpatialGate = SpatialGate()

    def block_forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.SpatialGate(self.ChannelGate(x))
