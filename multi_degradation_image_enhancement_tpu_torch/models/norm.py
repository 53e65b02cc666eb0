"""BatchNorm with the JAX package's (Flax) training semantics, and the
per-block rematerialisation that must not update its statistics twice.

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

:class:`Rematerialized` is the switch of ``train.remat`` on a block
(``nn.checkpoint`` around the JAX CDAN's blocks, ``models/cdan.py:249-263``):
the block's forward runs through ``torch.utils.checkpoint`` and is computed
again in the backward.  The recomputation leaves every running average of
the block alone, as Flax's checkpoint does, so a rematerialised step ends
with the same statistics as a plain one; under a mesh it reduces the batch
statistics again (every rank recomputes the same blocks in the same order)
and updates nothing.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from multi_degradation_image_enhancement_tpu_torch.parallel import collectives


def channel_stats(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mean, biased var) of NCHW ``t`` in f32: E[x²] − E[x]²,
    negatives clipped (``_channel_stats``, ``models/cdan.py:105-111``).

    Under a mesh with process groups (``parallel.collectives``) this is
    sync-BN: E[x] and E[x²] over the global batch, the ranks' equal-sized
    shards' means averaged by one differentiable all-reduce over ``data`` ×
    ``spatial`` (at one rank the plain path, bit for bit)."""
    tf = t.float()
    mu = tf.mean(dim=(0, 2, 3))
    mu2 = (tf * tf).mean(dim=(0, 2, 3))
    shards = collectives.bn_shards()
    if shards:
        mu, mu2 = collectives.bn_sum(torch.stack([mu, mu2]) * (1.0 / shards)).unbind(0)
    return mu, torch.clamp(mu2 - mu * mu, min=0.0)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d on batch statistics with Flax semantics in train mode, or
    in eval mode with ``stats_refresh`` set (the statistics refresh of
    ``bn_recalibration``); the output is f32 there, whatever the input."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.stats_refresh = False
        self.recomputing = False  # set while a rematerialised block recomputes

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """``running ← (1 − m)·running + m·batch`` with the biased variance;
        nothing while the forward is being recomputed."""
        if self.recomputing:
            return
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


@contextlib.contextmanager
def _recomputing(block: nn.Module):
    """Every BatchNorm2d of ``block`` skips its running-average update."""
    norms = [m for m in block.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.recomputing = True
    try:
        yield
    finally:
        for m in norms:
            m.recomputing = False


class Rematerialized(nn.Module):
    """A block whose ``remat`` flag sends its forward (``block_forward``)
    through ``torch.utils.checkpoint`` (non-reentrant) when gradients are on.
    The checkpoint records the autocast state and restores it for the
    recomputation.  Nothing random runs inside a block (dropout sits between
    blocks), so no RNG state is stashed."""

    remat = False

    def block_forward(self, *args):
        raise NotImplementedError

    def forward(self, *args):
        if not (self.remat and torch.is_grad_enabled()):
            return self.block_forward(*args)
        return checkpoint(self.block_forward, *args, use_reentrant=False, preserve_rng_state=False,
                          context_fn=lambda: (contextlib.nullcontext(), _recomputing(self)))
