"""Post-processing ops and their config-driven chain, NHWC (counterpart of
``multi_degradation_image_enhancement_tpu/ops/post_processing.py``), with
the reference's quirks kept:

* ``sharpen`` adds ``eye(3)`` as a matrix to the 3×3 kernel (not a centre
  delta), then normalises (COMPONENTS C6);
* each op rescales its input by 1/255 when the batch's maximum exceeds 1
  (``_auto01``): one maximum over the whole batch, the padded repeats of a
  final partial batch included, as the JAX eval step takes it.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from multi_degradation_image_enhancement_tpu_torch.ops.image import conv3x3_fixed, rgb_to_luma


def _auto01(images: torch.Tensor) -> torch.Tensor:
    """Divide by 255 when the batch looks like 0..255, without a host sync."""
    scale = torch.where(images.max() > 1.0, 1.0 / 255.0, 1.0).to(images.dtype)
    return images * scale


def enhance_contrast(images: torch.Tensor, contrast_factor: float = 1.1) -> torch.Tensor:
    """Contrast scaled about the per-sample, per-channel mean."""
    images = _auto01(images)
    mean = images.mean(dim=(1, 2), keepdim=True)
    return torch.clamp((images - mean) * contrast_factor + mean, 0.0, 1.0)


def enhance_color(images: torch.Tensor, saturation_factor: float = 1.1) -> torch.Tensor:
    """Saturation scaled about the luma."""
    images = _auto01(images)
    gray = rgb_to_luma(images)
    return torch.clamp(gray + saturation_factor * (images - gray), 0.0, 1.0)


def sharpen(images: torch.Tensor, strength: float = 0.5) -> torch.Tensor:
    """The reference's sharpening kernel, ``base·strength + eye(3)``
    normalised, as a depthwise 3×3 correlation with zero padding."""
    images = _auto01(images)
    base = torch.tensor([[0.0, -1.0, 0.0], [-1.0, 5.0, -1.0], [0.0, -1.0, 0.0]])
    kernel = base * strength + torch.eye(3)
    kernel = (kernel / kernel.sum()).to(device=images.device, dtype=images.dtype)
    return torch.clamp(conv3x3_fixed(images, kernel), 0.0, 1.0)


def soft_denoise(images: torch.Tensor, sigma: float = 0.2) -> torch.Tensor:
    """A 3×3 binomial blur blended in with weight ``sigma``."""
    images = _auto01(images)
    kernel = torch.tensor([[1.0, 2.0, 1.0], [2.0, 4.0, 2.0], [1.0, 2.0, 1.0]]) / 16.0
    blurred = conv3x3_fixed(images, kernel.to(device=images.device, dtype=images.dtype))
    return torch.clamp((1.0 - sigma) * images + sigma * blurred, 0.0, 1.0)


_OPS = {
    "enhance_contrast": enhance_contrast,
    "enhance_color": enhance_color,
    "sharpen": sharpen,
    "soft_denoise": soft_denoise,
}


def apply_postprocessing(images: torch.Tensor, pp_cfg: Dict[str, Any]) -> torch.Tensor:
    """The config's op chain when ``enabled``, else the images unchanged."""
    if not pp_cfg or not pp_cfg.get("enabled", False):
        return images
    for op in pp_cfg.get("ops", []) or []:
        name = op["name"]
        if name not in _OPS:
            raise ValueError(f"Unknown post-processing op: {name}")
        images = _OPS[name](images, **(op.get("args", {}) or {}))
    return images
