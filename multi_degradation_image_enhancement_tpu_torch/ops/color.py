"""Colour-space conversions with OpenCV conventions, for the
HueSaturationValue and CLAHE transforms (counterpart of
``multi_degradation_image_enhancement_tpu/ops/color.py``): HSV with
H ∈ [0, 180) and S, V ∈ [0, 255]; the LAB L channel through D65 XYZ, scaled
to [0, 255] (cv2's 8-bit convention).  ``[..., 3]`` tensors in 0..255.
"""

from __future__ import annotations

import torch


def rgb_to_hsv_cv(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] RGB in 0..255 → HSV, H ∈ [0, 180), S, V ∈ [0, 255]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = v - mn
    safe_diff = torch.where(diff > 0, diff, torch.ones_like(diff))
    s = torch.where(v > 0, diff / torch.clamp(v, min=1e-9) * 255.0, torch.zeros_like(v))
    h = torch.where(v == r, 60.0 * (g - b) / safe_diff,
                    torch.where(v == g, 120.0 + 60.0 * (b - r) / safe_diff,
                                240.0 + 60.0 * (r - g) / safe_diff))
    h = torch.where(diff == 0, torch.zeros_like(h), h)
    h = torch.where(h < 0, h + 360.0, h) / 2.0  # cv2 halves H to fit a byte
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb_cv(hsv: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`rgb_to_hsv_cv`."""
    h = hsv[..., 0] * 2.0  # degrees
    s = hsv[..., 1] / 255.0
    v = hsv[..., 2]
    c = v * s
    hp = h / 60.0
    x = c * (1.0 - torch.abs(torch.remainder(hp, 2.0) - 1.0))
    m = v - c
    z = torch.zeros_like(c)
    idx = torch.clamp(hp.to(torch.int32), 0, 5)
    # sector → (r, g, b) among (c, x, 0), as jnp.select in the JAX package
    table = {0: (c, x, z), 1: (x, c, z), 2: (z, c, x), 3: (z, x, c), 4: (x, z, c), 5: (c, z, x)}
    r, g, b = z, z, z
    for sector in range(5, -1, -1):
        sel = idx == sector
        r = torch.where(sel, table[sector][0], r)
        g = torch.where(sel, table[sector][1], g)
        b = torch.where(sel, table[sector][2], b)
    return torch.stack([r + m, g + m, b + m], dim=-1)


def _f_lab(t: torch.Tensor) -> torch.Tensor:
    d3 = (6.0 / 29.0) ** 3
    return torch.where(t > d3, _cbrt(t), t / (3 * (6.0 / 29.0) ** 2) + 4.0 / 29.0)


def _cbrt(t: torch.Tensor) -> torch.Tensor:
    """Real cube root (torch has none): sign · |t|^(1/3)."""
    return torch.sign(t) * torch.pow(torch.abs(t), 1.0 / 3.0)


def _srgb_to_linear(srgb: torch.Tensor) -> torch.Tensor:
    return torch.where(srgb > 0.04045, ((srgb + 0.055) / 1.055) ** 2.4, srgb / 12.92)


def rgb_to_lab_l(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] RGB 0..255 → the L channel in 0..255 (cv2 8-bit LAB)."""
    lin = _srgb_to_linear(rgb / 255.0)
    y = 0.212671 * lin[..., 0] + 0.715160 * lin[..., 1] + 0.072169 * lin[..., 2]
    return (116.0 * _f_lab(y) - 16.0) * 255.0 / 100.0


def replace_lab_l(rgb: torch.Tensor, new_l255: torch.Tensor) -> torch.Tensor:
    """Rescale RGB so that its LAB L channel becomes ``new_l255``: linear-light
    RGB scaled by the luminance ratio (hue and saturation kept)."""
    def y_of_l(l255):
        fy = (l255 * 100.0 / 255.0 + 16.0) / 116.0
        d = 6.0 / 29.0
        return torch.where(fy > d, fy ** 3, 3 * d * d * (fy - 4.0 / 29.0))

    ratio = y_of_l(new_l255) / torch.clamp(y_of_l(rgb_to_lab_l(rgb)), min=1e-6)
    lin = _srgb_to_linear(rgb / 255.0) * ratio[..., None]
    srgb = torch.where(lin > 0.0031308, 1.055 * lin ** (1 / 2.4) - 0.055, 12.92 * lin)
    return torch.clamp(srgb * 255.0, 0.0, 255.0)
