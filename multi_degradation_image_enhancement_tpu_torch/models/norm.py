"""BatchNorm with the JAX package's (Flax) training semantics.

``torch.nn.BatchNorm2d`` differs from ``flax.linen.BatchNorm`` in training:

* Flax updates the running variance with the *biased* batch variance; torch
  uses the unbiased one;
* Flax computes the statistics in f32 as E[x²] − E[x]², clipped at 0
  (``use_fast_variance``), and normalises as ``(x − mean)·(scale·rsqrt(var +
  eps)) + bias``;
* Flax's momentum m keeps ``m·running``; torch's momentum m mixes in
  ``m·batch`` (Flax 0.9 = torch 0.1, Flax 0.99 = torch 0.01).

:class:`BatchNorm2d` keeps torch's parameter and buffer names (so reference
state_dicts load) and torch's momentum convention, and follows Flax in train
and refresh mode.  In eval mode it is ``torch.nn.BatchNorm2d``.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


def channel_stats(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mean, biased var) of NCHW ``t`` in f32: E[x²] − E[x]²,
    negatives clipped (``_channel_stats``, ``models/cdan.py:105-111``)."""
    tf = t.float()
    mu = tf.mean(dim=(0, 2, 3))
    mu2 = (tf * tf).mean(dim=(0, 2, 3))
    return mu, torch.clamp(mu2 - mu * mu, min=0.0)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d on batch statistics with Flax semantics in train mode, or
    in eval mode with ``stats_refresh`` set (the statistics refresh of
    ``bn_recalibration``); the output is f32 there, whatever the input."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.stats_refresh = False

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """``running ← (1 − m)·running + m·batch`` with the biased variance."""
        keep = 1.0 - self.momentum
        self.running_mean.copy_(keep * self.running_mean + self.momentum * mean)
        self.running_var.copy_(keep * self.running_var + self.momentum * var)
        self.num_batches_tracked += 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training or self.stats_refresh):
            return super().forward(x)
        mean, var = channel_stats(x)
        self.update_running(mean, var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x.float() - mean[None, :, None, None]) * mul[None, :, None, None] + self.bias[
            None, :, None, None
        ]
