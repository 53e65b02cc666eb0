"""CDAN's spatial operators on an H shard (the ``spatial`` mesh axis).

Each takes this rank's rows of NCHW activations, fetches the rows its
window reaches across the shard boundary (``parallel.collectives.halo_h``)
and returns exactly its own rows of the whole image's result.  Without a
spatial axis each is the plain operator, as before.

* a k×k SAME conv: halo k // 2, zero rows at the global edges;
* the decoder's ``ConvTranspose2d(k3, s1, p1)``: halo 1, zero rows; the
  transposed conv with padding 2 along H on the halo'd rows is the SAME one;
* the ×2 half-pixel bilinear upsample: halo 1, the edge row copied at the
  global edges (the resize's own clamp), then the output cropped;
* the 2×2 max-pool is local: each rank's rows must stay even through the
  three pools, so a rank's H must divide by 8 (:func:`check_local_height`);
  JAX lets XLA pad an uneven shard instead.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multi_degradation_image_enhancement_tpu_torch.parallel import collectives


def check_local_height(h: int) -> None:
    """CDAN's three 2×2 pools need each rank's H to divide by 8."""
    if collectives.spatial_shards() > 1 and h % 8:
        raise ValueError(f"a spatial shard of {h} rows: each rank's H must divide by 8 for "
                         "CDAN's three 2x2 max-pools (choose H divisible by 8 x the spatial axis)")


def conv_same(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` for an odd square kernel with SAME padding, on an H shard."""
    if collectives.spatial_shards() == 1:
        return conv(x)
    k = conv.kernel_size[0]
    return F.conv2d(collectives.halo_h(x, k // 2, "zeros"), conv.weight, conv.bias,
                    padding=(0, k // 2))


def conv_transpose_same(deconv: nn.ConvTranspose2d, x: torch.Tensor) -> torch.Tensor:
    """``deconv(x)`` for ``ConvTranspose2d(k3, s1, p1)``, on an H shard."""
    if collectives.spatial_shards() == 1:
        return deconv(x)
    return F.conv_transpose2d(collectives.halo_h(x, 1, "zeros"), deconv.weight, deconv.bias,
                              padding=(2, 1))


def bilinear_x2(x: torch.Tensor) -> torch.Tensor:
    """×2 half-pixel bilinear upsample (``jax.image.resize`` bilinear), on an
    H shard: output row i of a shard reads its input rows ⌊(i − 1)/2⌋ and the
    next, so one halo row each side, cropped after."""
    if collectives.spatial_shards() == 1:
        return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
    h = x.shape[2]
    up = F.interpolate(collectives.halo_h(x, 1, "edge"), scale_factor=2, mode="bilinear",
                       align_corners=False)
    return up[:, :, 2:2 + 2 * h]
