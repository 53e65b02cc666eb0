"""CDAN restoration network, NCHW inside, eval mode.

Counterpart of ``multi_degradation_image_enhancement_tpu/models/cdan.py`` with
the reference's module names (``encoder.conv1.conv``, ``encoder.dense1.layers.0``,
``decoder.conv1``, ``bottleneck.ChannelGate.mlp.1``, …), so a reference
``CDAN_<task>.pt`` state_dict loads natively and JAX weights cross over through
``utils.jax_port``.  3,585,663 parameters at growth 16.

The public forward keeps the JAX package's layout: NHWC ``[B, H, W, 3]`` in
[0, 1] in, the same shape out; H and W multiples of 8.

The decoder keeps the reference's ``ConvTranspose2d(k3, s1, p1)`` layers (the
JAX package runs them as spatially flipped 3×3 convs).  Training-mode
BatchNorm semantics (biased running variance, momentum) wait for the training
port; this module is used in eval mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multi_degradation_image_enhancement_tpu_torch.models.cbam import CBAM


def _bilinear_x2(x: torch.Tensor) -> torch.Tensor:
    """×2 half-pixel bilinear upsample (``jax.image.resize`` bilinear)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


class ConvBlock(nn.Module):
    """Conv 3×3 → BN → ReLU (reference ``models/cdan.py:8-19``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.bn = nn.BatchNorm2d(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class DenseBlock(nn.Module):
    """4 × (BN → ReLU → 3×3 conv to ``growth_rate``, concat), then
    BN → ReLU → 1×1 transition back to ``in_channels`` (reference
    ``models/cdan.py:22-53``)."""

    num_layers = 4

    def __init__(self, in_channels: int, growth_rate: int = 16):
        super().__init__()
        self.in_channels = in_channels
        self.growth_rate = growth_rate
        self.layers = nn.ModuleList()
        c = in_channels
        for _ in range(self.num_layers):
            self.layers.append(
                nn.Sequential(nn.BatchNorm2d(c), nn.ReLU(), nn.Conv2d(c, growth_rate, 3, padding=1))
            )
            c += growth_rate
        self.transition_layer = nn.Sequential(
            nn.BatchNorm2d(c), nn.ReLU(), nn.Conv2d(c, in_channels, 1)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = x
        for layer in self.layers:
            feats = torch.cat([feats, layer(feats)], dim=1)
        return self.transition_layer(feats)


class Encoder(nn.Module):
    """Reference ``models/cdan.py:55-98``: ConvBlocks 3→64→128→256→512, a 2×2
    max-pool after the first three, a DenseBlock gate per scale computed on the
    pooled features, Dropout(0.2) at four places (inert in eval)."""

    def __init__(self, growth_rate: int = 16):
        super().__init__()
        self.conv1 = ConvBlock(3, 64)
        self.conv2 = ConvBlock(64, 128)
        self.conv3 = ConvBlock(128, 256)
        self.conv4 = ConvBlock(256, 512)
        self.dense1 = DenseBlock(64, growth_rate)
        self.dense2 = DenseBlock(128, growth_rate)
        self.dense3 = DenseBlock(256, growth_rate)
        self.pool = nn.MaxPool2d(2, 2)
        self.dropout = nn.Dropout(0.2)

    def forward(self, x: torch.Tensor):
        skips, denses = [], []
        out = x
        for conv, dense in ((self.conv1, self.dense1), (self.conv2, self.dense2),
                            (self.conv3, self.dense3)):
            out = self.pool(conv(out))
            denses.append(dense(out))
            out = self.dropout(out)
            skips.append(out)
        out = self.dropout(self.conv4(out))
        return out, skips, denses


class Decoder(nn.Module):
    """Reference ``models/cdan.py:100-159``: per scale a deconv + BN + ReLU,
    additive skip, CBAM, multiplicative dense gate, bilinear ×2; then the global
    residual, the final DenseBlock(3) and a sigmoid.  ``conv4`` (3 outputs)
    keeps its ReLU."""

    def __init__(self, growth_rate: int = 16):
        super().__init__()
        widths = [(512, 256), (256, 128), (128, 64), (64, 3)]
        for i, (cin, cout) in enumerate(widths, 1):
            setattr(self, f"conv{i}", nn.ConvTranspose2d(cin, cout, 3, stride=1, padding=1))
            setattr(self, f"bn{i}", nn.BatchNorm2d(cout))
        self.cbam1 = CBAM(256)
        self.cbam2 = CBAM(128)
        self.cbam3 = CBAM(64)
        self.final_dense = DenseBlock(3, growth_rate)

    def _deconv(self, x: torch.Tensor, i: int) -> torch.Tensor:
        return torch.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))

    def forward(self, x, out, skips, denses):
        out = self.cbam1(self._deconv(out, 1) + skips[2])
        out = out * denses[2]
        out = self.cbam2(_bilinear_x2(self._deconv(out, 2)) + skips[1])
        out = out * denses[1]
        out = self.cbam3(_bilinear_x2(self._deconv(out, 3)) + skips[0])
        out = out * denses[0]
        out = _bilinear_x2(self._deconv(out, 4)) + x  # global residual
        return torch.sigmoid(self.final_dense(out))


class CDAN(nn.Module):
    """CDAN encoder–decoder with CBAM attention (reference ``models/cdan.py:164-176``)."""

    def __init__(self, growth_rate: int = 16):
        super().__init__()
        self.encoder = Encoder(growth_rate)
        self.bottleneck = CBAM(512)
        self.decoder = Decoder(growth_rate)

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = x_nhwc.permute(0, 3, 1, 2)
        out, skips, denses = self.encoder(x)
        out = self.bottleneck(out)
        out = self.decoder(x, out, skips, denses)
        return out.permute(0, 2, 3, 1).float()


@torch.no_grad()
def init_cdan(generator: torch.Generator) -> CDAN:
    """A CDAN in eval mode with seeded weights and random BN statistics.

    Weights take PyTorch's default init under a seed drawn from ``generator``
    (the global RNG state is restored after); every BatchNorm's running mean
    and variance are drawn U(0.5, 1.5) from ``generator`` so every BN fold is
    exercised.  Stands in for trained weights, which the repo does not ship.
    """
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = CDAN()
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.running_mean.uniform_(0.5, 1.5, generator=generator)
            m.running_var.uniform_(0.5, 1.5, generator=generator)
    return model.eval()
