"""SSIM and PSNR with torchmetrics semantics (counterpart of
``multi_degradation_image_enhancement_tpu/ops/ssim.py``).

SSIM uses an 11-tap Gaussian window (σ 1.5), k1 0.01, k2 0.03, *valid*
windows only, and the mean over batch, channels and positions.  Both metrics
default to a data range inferred from the data, ``max(max(p) − min(p),
max(t) − min(t))``, which stays differentiable as in JAX: ``amax``/``amin``
split the gradient evenly between tied extremes, as JAX's reductions do.
Images are NHWC, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from multi_degradation_image_enhancement_tpu_torch.parallel import collectives

DataRange = Union[float, str, None]


def _resolve_data_range(preds: torch.Tensor, target: torch.Tensor, data_range: DataRange):
    if data_range is None or data_range == "auto":
        group = collectives.loss_group()

        def amax(t):
            return collectives.all_reduce_amax(t, (), group)

        return torch.maximum(amax(preds) + amax(-preds), amax(target) + amax(-target))
    return torch.tensor(float(data_range), dtype=preds.dtype, device=preds.device)


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over all elements of the valid samples (``mask``: per-sample
    {0, 1} of shape [B], ``None`` = all valid): the mask-weighted mean of
    per-sample means, which equals it because samples have equal sizes.

    Under a mesh with a ``data`` axis ``x`` holds this rank's samples and the
    result is its share of the global batch's mean: its own sum over the
    global count (the valid counts all-reduced, as a padded last batch may
    leave the ranks unequal ones); the shares sum to the global mean."""
    group = collectives.loss_group()
    if mask is None:
        shards = 1 if group is None else collectives.active_mesh().size("data")
        return x.mean() if shards == 1 else x.mean() * (1.0 / shards)
    per_sample = x.reshape(x.shape[0], -1).mean(dim=1)
    m = mask.to(per_sample.dtype)
    count = collectives.all_reduce_detached(m.sum(), group)
    return (per_sample * m).sum() / torch.clamp(count, min=1.0)


def psnr(preds, target, data_range: DataRange = "auto", mask=None) -> torch.Tensor:
    """``10·log10(range² / mse)`` over the whole (valid) batch."""
    dr = _resolve_data_range(preds, target, data_range)
    mse = masked_mean(torch.square(preds - target), mask)
    return 10.0 * torch.log10(torch.square(dr) / mse)


def _gaussian_window(kernel_size: int, sigma: float, device=None) -> torch.Tensor:
    x = torch.arange(kernel_size, dtype=torch.float32, device=device) - (kernel_size - 1) / 2.0
    w = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return w / w.sum()


def _filter_valid(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Separable valid-mode filter on [B, H, W, C], H then W, summed tap by tap
    in the JAX package's order."""
    k = taps.shape[0]
    h = x.shape[1] - (k - 1)
    out = sum(taps[i] * x[:, i:i + h] for i in range(k))
    w = out.shape[2] - (k - 1)
    return sum(taps[i] * out[:, :, i:i + w] for i in range(k))


def ssim(preds, target, data_range: DataRange = "auto", kernel_size: int = 11,
         sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03, mask=None) -> torch.Tensor:
    """Structural similarity, one scalar over the (valid) batch."""
    dr = _resolve_data_range(preds, target, data_range)
    c1 = torch.square(k1 * dr)
    c2 = torch.square(k2 * dr)
    taps = _gaussian_window(kernel_size, sigma, preds.device).to(preds.dtype)

    mu_x = _filter_valid(preds, taps)
    mu_y = _filter_valid(target, taps)
    mu_xx = _filter_valid(preds * preds, taps)
    mu_yy = _filter_valid(target * target, taps)
    mu_xy = _filter_valid(preds * target, taps)

    sigma_x = mu_xx - mu_x * mu_x
    sigma_y = mu_yy - mu_y * mu_y
    sigma_xy = mu_xy - mu_x * mu_y

    num = (2.0 * mu_x * mu_y + c1) * (2.0 * sigma_xy + c2)
    den = (mu_x * mu_x + mu_y * mu_y + c1) * (sigma_x + sigma_y + c2)
    return masked_mean(num / den, mask)
