"""Severity-parameterised degradations, the classifier workload's flavour
(counterpart of ``multi_degradation_image_enhancement_tpu/ops/severity.py``).

Severity ∈ [0, 1] maps to each family's parameters as in the JAX package:

  blur              k = {3,5,7,9}[round(sev·3)]
  noise             σ = 5 + 45·sev
  low_light         × (0.45 − 0.40·sev)
  jpeg              quality = round(80 − 70·sev)
  pixelation        factor = round(4 + 12·sev)
  motion_blur       k = odd(round(5 + 20·sev)), random angle ∈ [0, 180)
  high_light        × (1.2 + 1.8·sev)
  low_contrast      α = 0.8 − 0.6·sev
  color_distortion  per-channel gains ~ U(1 ± 0.4·sev)

Two levels, as ``ops.degradations``: :func:`severity_params` draws the
realised parameters (the JAX function's returned ``params``, plus noise's
standard normals under ``normal``) from an explicit ``torch.Generator``,
and :func:`apply_severity_with_params` applies them deterministically.  The
rotated motion-blur PSF is the closed-form rasterisation of
:func:`rotated_line_kernel`; each sample is correlated with its own PSF by
one grouped convolution in full f32 (TF32 off), reflect-101 borders.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from multi_degradation_image_enhancement_tpu_torch.ops import degradations as D
from multi_degradation_image_enhancement_tpu_torch.ops.image import quantize_u8, reflect_pad_hw
from multi_degradation_image_enhancement_tpu_torch.ops.jpeg import jpeg_roundtrip

MAX_MOTION_K = 25
_MOTION_R = MAX_MOTION_K // 2  # 12


def rotated_line_kernel(k: torch.Tensor, angle_deg: torch.Tensor) -> torch.Tensor:
    """Per-sample ``[B, 25, 25]`` PSF: a length-k horizontal line rotated by
    ``angle_deg``, as ``cv2.warpAffine(INTER_LINEAR)`` rasterises it on a k×k
    canvas centred at (k/2, k/2), embedded at the centre of 25×25 (the
    JAX package's closed form, ``severity.py:38-79``)."""
    dev = angle_deg.device
    kf = k.to(device=dev, dtype=torch.float32)[:, None, None]
    c = kf / 2.0
    row = torch.div(k.to(dev), 2, rounding_mode="floor").to(torch.float32)[:, None, None]

    ys = torch.arange(MAX_MOTION_K, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(MAX_MOTION_K, dtype=torch.float32, device=dev)[None, None, :]
    off = (MAX_MOTION_K - kf) / 2.0
    x = xs - off
    y = ys - off

    theta = torch.deg2rad(angle_deg.to(torch.float32))[:, None, None]
    cos, sin = torch.cos(theta), torch.sin(theta)
    dx, dy = x - c, y - c
    sx = c + cos * dx - sin * dy
    sy = c + sin * dx + cos * dy

    wy = torch.clamp(1.0 - torch.abs(sy - row), min=0.0)
    f = torch.floor(sx)
    t = sx - f
    left_valid = (f >= 0.0) & (f <= kf - 1.0)
    right_valid = (f + 1.0 >= 0.0) & (f + 1.0 <= kf - 1.0)
    zero = torch.zeros((), device=dev)
    wx = torch.where(left_valid, 1.0 - t, zero) + torch.where(right_valid, t, zero)

    # taps outside the k×k canvas are cropped, as warpAffine crops them
    in_canvas = (x >= 0.0) & (x <= kf - 1.0) & (y >= 0.0) & (y <= kf - 1.0)
    kern = wy * wx * in_canvas.to(torch.float32)
    s = torch.sum(kern, dim=(1, 2), keepdim=True)
    return torch.where(s > 1e-8, kern / s, kern)


def motion_blur_rotated(images: torch.Tensor, k: torch.Tensor, angle_deg: torch.Tensor) -> torch.Tensor:
    """Correlate each sample of ``[B,H,W,C]`` with its own rotated-line PSF
    (reflect-101 border), rounded to the uint8 lattice: a depthwise
    ``F.conv2d`` over the batch folded into the channels."""
    b, h, w, c = images.shape
    kern = rotated_line_kernel(k, angle_deg.to(images.device))  # [B, 25, 25]
    xp = reflect_pad_hw(images, _MOTION_R, _MOTION_R)  # [B, H+24, W+24, C]
    x = xp.permute(0, 3, 1, 2).reshape(1, b * c, h + 2 * _MOTION_R, w + 2 * _MOTION_R)
    weight = kern.repeat_interleave(c, dim=0)[:, None]  # [B·C, 1, 25, 25]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the products in full f32, as the JAX op
    try:
        out = F.conv2d(x, weight, groups=b * c)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return quantize_u8(out.reshape(b, c, h, w).permute(0, 2, 3, 1), "round")


def severity_params(name: str, sev: torch.Tensor, generator: torch.Generator,
                    image_shape: Tuple[int, ...]) -> Dict[str, torch.Tensor]:
    """The realised parameters of ``name`` at per-sample severities ``sev``
    [B] on the generator's device: the JAX function's ``params`` (same keys,
    f32 where it computes in f32), with noise's standard normals of
    ``image_shape`` under ``normal``."""
    D.check_name(name)
    dev = generator.device
    sev = sev.to(device=dev, dtype=torch.float32)
    b = sev.shape[0]
    if name == "blur":
        k_idx = torch.clamp(torch.round(sev * 3).to(torch.int32), 0, 3)
        return {"k": 3 + 2 * k_idx}
    if name == "noise":
        normal = torch.randn(tuple(image_shape), generator=generator, device=dev)
        return {"std": 5.0 + sev * 45.0, "normal": normal}
    if name == "low_light":
        return {"factor": 0.45 - sev * 0.40}
    if name == "jpeg":
        return {"quality": torch.round(80.0 - sev * 70.0)}
    if name == "pixelation":
        return {"factor": torch.round(4.0 + sev * 12.0).to(torch.int32)}
    if name == "motion_blur":
        k = torch.clamp(torch.round(5.0 + sev * 20.0).to(torch.int32), min=3)
        k = torch.where(k % 2 == 0, k + 1, k)
        angle = torch.rand(b, generator=generator, device=dev) * 180.0
        return {"k": k, "angle_deg": angle}
    if name == "high_light":
        return {"factor": 1.2 + sev * 1.8}
    if name == "low_contrast":
        return {"alpha": 0.8 - sev * 0.6}
    amp = (0.4 * sev)[:, None]  # color_distortion
    u = torch.rand((b, 3), generator=generator, device=dev)
    return {"gains": (1.0 - amp) + u * (2.0 * amp)}


_APPLY = {
    "blur": lambda x, p: D.gaussian_blur(x, torch.div(p["k"] - 3, 2, rounding_mode="floor")),
    "noise": lambda x, p: D.add_gaussian_noise(x, p["std"], p["normal"]),
    "low_light": lambda x, p: D.scale_intensity(x, p["factor"]),
    "jpeg": lambda x, p: jpeg_roundtrip(x, p["quality"]),
    "pixelation": lambda x, p: D.pixelate(x, p["factor"]),
    "motion_blur": lambda x, p: motion_blur_rotated(x, p["k"], p["angle_deg"]),
    "high_light": lambda x, p: D.scale_intensity(x, p["factor"]),
    "low_contrast": lambda x, p: D.low_contrast(x, p["alpha"]),
    "color_distortion": lambda x, p: D.color_distortion(x, p["gains"]),
}


def apply_severity_with_params(name: str, images: torch.Tensor,
                               params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Apply ``name`` to ``[B,H,W,3]`` f32 in 0..255 with realised parameters
    (moved to the images' device)."""
    D.check_name(name)
    return _APPLY[name](images, {k: v.to(images.device) for k, v in params.items()})


def apply_severity(name: str, images: torch.Tensor, sev: torch.Tensor,
                   generator: torch.Generator) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Both levels: ``(degraded, params)``, params without noise's normals."""
    params = severity_params(name, sev, generator, images.shape)
    out = apply_severity_with_params(name, images, params)
    params.pop("normal", None)
    return out, params
