"""Batched degradations on PyTorch tensors (counterpart of
``multi_degradation_image_enhancement_tpu/ops/degradations.py``).

Only the noise family is ported so far; asking for any of the other eight
raises and names the ROADMAP queue that holds it.

Value convention: float32 images ``[B, H, W, 3]`` in 0..255, as in the JAX
package; :func:`degrade_batch` returns the network's [0, 1] domain.  Random
draws come from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from multi_degradation_image_enhancement_tpu_torch.ops.cuda.noise import sample_sigma
from multi_degradation_image_enhancement_tpu_torch.ops.image import quantize_u8

DEGRADATIONS: Tuple[str, ...] = (
    "blur",
    "noise",
    "low_light",
    "jpeg",
    "pixelation",
    "motion_blur",
    "high_light",
    "low_contrast",
    "color_distortion",
)
PORTED: Tuple[str, ...] = ("noise",)


def _check_name(name: str) -> None:
    if name in PORTED:
        return
    if name in DEGRADATIONS:
        raise ValueError(
            f"degradation {name!r} is not ported to PyTorch yet (ROADMAP.md, queue 1)"
        )
    raise ValueError(f"Unknown degradation: {name}. Available: {DEGRADATIONS}")


def sample_params(name: str, generator: torch.Generator, batch: int) -> Dict[str, torch.Tensor]:
    """Per-sample severity parameters with the reference's ranges.

    noise: ``std`` ~ U[10, 50] per image, on the generator's device."""
    _check_name(name)
    return {"std": sample_sigma(generator, batch)}


def add_gaussian_noise(images: torch.Tensor, std: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """``floor(clip(images + σ·n, 0, 255))`` with given standard normals ``n``
    shaped like ``images``."""
    return quantize_u8(images + std.reshape(-1, 1, 1, 1) * normal, "floor")


def apply_with_params(name: str, images: torch.Tensor, params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Apply ``name`` with explicit parameters; noise needs ``std`` [B] and
    ``normal`` (standard normals shaped like ``images``)."""
    _check_name(name)
    return add_gaussian_noise(images, params["std"].to(images.device), params["normal"])


def apply_degradation(name: str, images: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Apply ``name`` with random reference-range severities from ``generator``."""
    params = sample_params(name, generator, images.shape[0])
    params["normal"] = torch.randn(
        images.shape, generator=generator, device=generator.device, dtype=images.dtype
    ).to(images.device)
    return apply_with_params(name, images, params)


def degrade_batch(
    images: torch.Tensor, name: str, generator: torch.Generator
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A (degraded, clean) pair in the network's [0, 1] domain."""
    degraded = apply_degradation(name, images, generator)
    return degraded / 255.0, images / 255.0
