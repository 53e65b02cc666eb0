"""The nine degradation families on batched PyTorch tensors (counterpart of
``multi_degradation_image_enhancement_tpu/ops/degradations.py``), with the
same parameter ranges:

  blur              Gaussian blur, k ∈ {3,5,7,9} (cv2 sigma=0 kernels)
  noise             additive Gaussian, σ ∈ [10,50]
  low_light         intensity × [0.05, 0.4]
  jpeg              DCT quantisation round trip, quality ∈ [10,50]
  pixelation        factor ∈ [4,16]: bilinear down, nearest up
  motion_blur       horizontal line PSF, k ∈ [5,25]
  high_light        intensity × [1.5, 3.0]
  low_contrast      blend to the per-channel mean, α ∈ [0.3, 0.7]
  color_distortion  per-channel gains ∈ [0.6, 1.4]

Value convention: float32 images ``[B, H, W, 3]`` in 0..255, as in the JAX
package; each op ends on the uint8 lattice (cv2 outputs round, NumPy
``astype(uint8)`` truncates); :func:`degrade_batch` returns the network's
[0, 1] domain.  Random draws come from an explicit ``torch.Generator`` and
land on its device.  Every op is elementwise arithmetic, index gathers and
(for ``low_contrast``) a mean: no convolution or matmul, so TF32 cannot
change a degraded image on the card.

Two levels: :func:`sample_params` and :func:`apply_with_params` (explicit,
deterministic), :func:`apply_degradation` (the two combined).  Noise keeps
the port's convention: ``std`` [B] plus explicit standard normals
``normal`` shaped like the images (``apply_degradation`` draws them).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from multi_degradation_image_enhancement_tpu_torch.ops.cuda.noise import sample_sigma
from multi_degradation_image_enhancement_tpu_torch.ops.image import (
    conv_taps_w,
    quantize_u8,
    separable_blur,
    true_div,
)
from multi_degradation_image_enhancement_tpu_torch.ops.jpeg import jpeg_roundtrip

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


def _gaussian_taps_9(sigma: float) -> torch.Tensor:
    x = torch.arange(9, dtype=torch.float32) - 4.0
    w = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return w / torch.sum(w)


# cv2.getGaussianKernel with sigma <= 0: fixed tables for k ∈ {3,5,7}, the
# σ = 0.3·((k−1)/2 − 1) + 0.8 formula for k = 9 (σ = 1.7); each row is a
# 9-tap kernel centred at index 4.  Built on the CPU once (bit-equal to JAX's).
GAUSSIAN_KERNEL_TABLE = torch.stack([
    torch.tensor([0, 0, 0, 0.25, 0.5, 0.25, 0, 0, 0], dtype=torch.float32),
    torch.tensor([0, 0, 0.0625, 0.25, 0.375, 0.25, 0.0625, 0, 0], dtype=torch.float32),
    torch.tensor([0, 0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125, 0],
                 dtype=torch.float32),
    _gaussian_taps_9(1.7),
])  # [4, 9] for k = 3, 5, 7, 9


def check_name(name: str) -> None:
    if name not in DEGRADATIONS:
        raise ValueError(f"Unknown degradation: {name}. Available: {DEGRADATIONS}")


def sample_params(name: str, generator: torch.Generator, batch: int) -> Dict[str, torch.Tensor]:
    """Per-sample severity parameters with the reference's ranges, on the
    generator's device; integers are int32 and ``randint`` highs exclusive,
    as in JAX."""
    check_name(name)
    dev = generator.device

    def uniform(lo, hi, shape=(batch,)):
        return torch.rand(shape, generator=generator, device=dev) * (hi - lo) + lo

    def randint(lo, hi):
        return torch.randint(lo, hi, (batch,), generator=generator, device=dev,
                             dtype=torch.int32)

    if name == "blur":
        return {"k_idx": randint(0, 4)}
    if name == "noise":
        return {"std": sample_sigma(generator, batch)}
    if name == "low_light":
        return {"factor": uniform(0.05, 0.4)}
    if name == "jpeg":
        return {"quality": randint(10, 51)}
    if name == "pixelation":
        return {"factor": randint(4, 17)}
    if name == "motion_blur":
        return {"k": randint(5, 26)}
    if name == "high_light":
        return {"factor": uniform(1.5, 3.0)}
    if name == "low_contrast":
        return {"alpha": uniform(0.3, 0.7)}
    return {"gains": uniform(0.6, 1.4, (batch, 3))}  # color_distortion


def _per_sample(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(-1, 1, 1, 1)


def gaussian_blur(images: torch.Tensor, k_idx: torch.Tensor) -> torch.Tensor:
    """Gaussian blur with a per-sample kernel index into {3, 5, 7, 9}."""
    weights = GAUSSIAN_KERNEL_TABLE.to(images.device)[k_idx.long()]  # [B, 9]
    return quantize_u8(separable_blur(images, weights, radius=4), "round")


def add_gaussian_noise(images: torch.Tensor, std: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """``floor(clip(images + σ·n, 0, 255))`` with given standard normals ``n``."""
    return quantize_u8(images + _per_sample(std) * normal, "floor")


def scale_intensity(images: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """low_light and high_light: ``floor(clip(images · factor))``."""
    return quantize_u8(images * _per_sample(factor), "floor")


def _axis_taps(size: int, factor: torch.Tensor):
    """The two source taps and the weight of the second, ``[B, size]`` each,
    of cv2 INTER_LINEAR down to ``size // factor`` composed with
    INTER_NEAREST back up to ``size`` (JAX ``_axis_interp_matrix``, whose
    rows hold these two taps; f32 in the JAX order)."""
    f = factor.to(torch.float32)
    small = torch.clamp(torch.floor(true_div(size, f)), min=1.0)[:, None]  # cv2: size // factor
    dst = torch.arange(size, dtype=torch.float32, device=f.device)[None, :]
    sx = torch.minimum(torch.clamp(torch.floor(true_div(dst * small, size)), min=0.0), small - 1.0)
    u = torch.clamp((sx + 0.5) * true_div(size, small) - 0.5, 0.0, size - 1.0)
    i0 = torch.floor(u)
    frac = u - i0
    i0 = i0.long()
    return i0, torch.clamp(i0 + 1, max=size - 1), frac


def _interp_axis(x: torch.Tensor, axis: int, factor: torch.Tensor) -> torch.Tensor:
    """``(1 − frac)·x[i0] + frac·x[i1]`` along ``axis`` (1 = H, 2 = W) of [B,H,W,C]."""
    i0, i1, frac = _axis_taps(x.shape[axis], factor)
    shape = [x.shape[0], 1, 1, 1]
    shape[axis] = x.shape[axis]

    def take(idx):
        return torch.gather(x, axis, idx.reshape(shape).expand_as(x))

    frac = frac.reshape(shape)
    return (1.0 - frac) * take(i0) + frac * take(i1)


def pixelate(images: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """cv2-equivalent pixelation with per-sample factors, clamped to
    ``[2, min(H, W)//2]``: bilinear down by the factor, nearest back up (a
    two-tap gather per axis), rounded."""
    _, h, w, _ = images.shape
    f = torch.clamp(factor.to(images.device), 2, max(2, min(h, w) // 2))
    return quantize_u8(_interp_axis(_interp_axis(images, 1, f), 2, f), "round")


def motion_blur(images: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Horizontal line PSF of per-sample length ``k`` ≤ 25 (cv2.filter2D
    anchor: taps at offsets ``j − k//2`` for ``j ∈ [0, k)``, weight 1/k),
    over a 25-tap masked window.  Needs W ≥ 13 (the reflect pad is 12)."""
    radius = 12
    kk = k.to(images.device).long()[:, None]
    offsets = torch.arange(-radius, radius + 1, device=images.device)[None, :]
    mask = (offsets >= -(kk // 2)) & (offsets <= kk - 1 - kk // 2)
    weights = mask.to(torch.float32) / kk.to(torch.float32)
    return quantize_u8(conv_taps_w(images, weights, radius), "round")


def low_contrast(images: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    m = images.mean(dim=(1, 2), keepdim=True)  # per-sample, per-channel
    a = _per_sample(alpha)
    return quantize_u8(a * images + (1.0 - a) * m, "floor")


def color_distortion(images: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    return quantize_u8(images * gains[:, None, None, :], "floor")


_APPLY = {
    "blur": lambda x, p: gaussian_blur(x, p["k_idx"]),
    "noise": lambda x, p: add_gaussian_noise(x, p["std"], p["normal"]),
    "low_light": lambda x, p: scale_intensity(x, p["factor"]),
    "jpeg": lambda x, p: jpeg_roundtrip(x, p["quality"]),
    "pixelation": lambda x, p: pixelate(x, p["factor"]),
    "motion_blur": lambda x, p: motion_blur(x, p["k"]),
    "high_light": lambda x, p: scale_intensity(x, p["factor"]),
    "low_contrast": lambda x, p: low_contrast(x, p["alpha"]),
    "color_distortion": lambda x, p: color_distortion(x, p["gains"]),
}


def apply_with_params(name: str, images: torch.Tensor, params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Apply ``name`` with explicit per-sample parameters (moved to the
    images' device); noise also needs ``normal``."""
    check_name(name)
    params = {k: v.to(images.device) for k, v in params.items()}
    return _APPLY[name](images, params)


def apply_degradation(name: str, images: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Apply ``name`` with random reference-range severities from ``generator``."""
    params = sample_params(name, generator, images.shape[0])
    if name == "noise":
        params["normal"] = torch.randn(
            images.shape, generator=generator, device=generator.device, dtype=images.dtype)
    return apply_with_params(name, images, params)


def degrade_batch(
    images: torch.Tensor, name: str, generator: torch.Generator
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A (degraded, clean) pair in the network's [0, 1] domain."""
    degraded = apply_degradation(name, images, generator)
    return degraded / 255.0, images / 255.0
