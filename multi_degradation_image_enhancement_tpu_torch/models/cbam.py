"""CBAM (Convolutional Block Attention Module), NCHW.

Counterpart of ``multi_degradation_image_enhancement_tpu/models/cbam.py:29-156``
with the reference's module names (``ChannelGate.mlp.{1,3}``,
``SpatialGate.spatial.{conv,bn}``), so a reference state_dict loads as is.

The channel gate's pools are the JAX module's (``cbam.py:65-105``): ``avg``,
``max``, ``lp`` (``sqrt(Σ x²)`` over H·W) and ``lse`` (a stable logsumexp
over H·W), each through the shared MLP and summed before the sigmoid in the
order given; CDAN uses avg + max.  ``no_spatial`` leaves the spatial gate
out, and with it the ``SpatialGate.*`` keys of the state dict.  The spatial
gate's BatchNorm follows Flax in train and refresh mode
(``models.norm.BatchNorm2d``: biased running variance, Flax momentum 0.99 =
torch momentum 0.01, ``cbam.py:29-62``).  On an H shard (the ``spatial``
mesh axis) every pool is the whole image's (``lp`` the root of the
all-reduced sum of squares; ``lse`` about the global max, which
``collectives.spatial_amax`` gives) and the 7×7 conv reads three halo rows
each side (``models.halo``).
"""

from __future__ import annotations

from typing import Sequence

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


POOL_TYPES = ("avg", "max", "lp", "lse")


def _pool(x: torch.Tensor, pool_type: str) -> torch.Tensor:
    """One global pool of NCHW ``x`` over the whole image (every ``spatial``
    shard of it): ``[B, C]``."""
    shards = collectives.spatial_shards()
    if pool_type == "avg":
        if shards == 1:
            return x.mean(dim=(2, 3))
        return collectives.spatial_sum(x.mean(dim=(2, 3)) * (1.0 / shards))
    if pool_type == "max":
        return collectives.spatial_amax(x, (2, 3))
    if pool_type == "lp":  # F.lp_pool2d(norm_type=2) over the whole image
        return torch.sqrt(collectives.spatial_sum(x.square().sum(dim=(2, 3))))
    if pool_type == "lse":
        if shards == 1:
            return torch.logsumexp(x.flatten(2), dim=2)
        # log Σ exp(x − m) + m about the global max m, held constant in the
        # backward as jax.nn.logsumexp holds it (its gradient cancels)
        m = collectives.spatial_amax(x.detach(), (2, 3))
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        s = collectives.spatial_sum(torch.exp(x - m[:, :, None, None]).sum(dim=(2, 3)))
        return torch.log(s) + m
    raise ValueError(f"Unknown pool type: {pool_type}")


class ChannelGate(nn.Module):
    """Shared MLP over the pooled channel vectors (``pool_types``, in that
    order), summed before the sigmoid."""

    def __init__(self, gate_channels: int, reduction_ratio: int = 16,
                 pool_types: Sequence[str] = ("avg", "max")):
        super().__init__()
        for pool_type in pool_types:
            if pool_type not in POOL_TYPES:
                raise ValueError(f"Unknown pool type: {pool_type}")
        self.pool_types = tuple(pool_types)
        self.mlp = nn.Sequential(
            nn.Flatten(),
            nn.Linear(gate_channels, gate_channels // reduction_ratio),
            nn.ReLU(),
            nn.Linear(gate_channels // reduction_ratio, gate_channels),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        att = None
        for pool_type in self.pool_types:
            a = self.mlp(_pool(x, pool_type))
            att = a if att is None else att + a
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
    """Channel gate, then spatial gate unless ``no_spatial`` (reference
    ``models/cbam.py:84-95``); one rematerialised block under ``remat``."""

    def __init__(self, gate_channels: int, reduction_ratio: int = 16,
                 pool_types: Sequence[str] = ("avg", "max"), no_spatial: bool = False):
        super().__init__()
        self.ChannelGate = ChannelGate(gate_channels, reduction_ratio, pool_types)
        self.no_spatial = bool(no_spatial)
        if not self.no_spatial:
            self.SpatialGate = SpatialGate()

    def block_forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ChannelGate(x)
        return x if self.no_spatial else self.SpatialGate(x)
