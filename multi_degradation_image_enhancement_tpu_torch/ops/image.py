"""Image helpers (counterpart of ``multi_degradation_image_enhancement_tpu/ops/image.py``).

Batched NHWC float tensors.  Ported so far: :func:`quantize_u8`,
:func:`conv3x3_fixed`, :func:`rgb_to_luma` and :func:`resize_bilinear_cv`; the
reflect-padded tap sums and the nearest resize wait for the other
degradations (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import torch


def quantize_u8(x: torch.Tensor, mode: str = "floor") -> torch.Tensor:
    """Emulate a uint8 round-trip without leaving float.

    ``floor``: NumPy's ``clip(...).astype(uint8)`` truncation, used by most
    reference degradations.  ``round``: OpenCV's fixed-point rounding, used by
    cv2 filter outputs.
    """
    x = torch.clamp(x, 0.0, 255.0)
    if mode == "floor":
        return torch.floor(x)
    if mode == "round":
        return torch.round(x)
    raise ValueError(f"Unknown quantize mode: {mode}")


def conv3x3_fixed(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise 3×3 correlation of [B,H,W,C] with one fixed [3,3] kernel, zero
    padding (``F.conv2d(..., padding=1, groups=C)``), summed tap by tap in the
    JAX package's order."""
    _, h, w, _ = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    out = torch.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            out = out + kernel[dy, dx] * xp[:, dy:dy + h, dx:dx + w]
    return out


def rgb_to_luma(x: torch.Tensor) -> torch.Tensor:
    """ITU-R BT.601 luma with the reference's constants: [..., 3] → [..., 1]."""
    r, g, b = x[..., 0:1], x[..., 1:2], x[..., 2:3]
    return 0.2989 * r + 0.5870 * g + 0.1140 * b


def _linear_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """``[in, out]`` interpolation weights of ``jax.image.scale_and_translate``
    (triangle kernel, no antialias, scale ``out/in``, translation
    ``(scale − 1)/2``), computed in f32 as JAX computes them: columns
    normalised to sum 1, zero where the sample falls outside the input."""
    scale = torch.tensor(out_size / in_size, dtype=torch.float32)
    translation = 0.5 * (scale - 1.0)
    inv_scale = 1.0 / scale
    sample = ((torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale
              - translation * inv_scale - 0.5)
    x = torch.abs(sample[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None])
    weights = torch.clamp(1.0 - x, min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(torch.abs(total) > 1000.0 * float(torch.finfo(torch.float32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights)).to(device)


def resize_bilinear_cv(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of [B,H,W,C] with half-pixel centres and no antialias,
    as the JAX package's ``resize_bilinear_cv`` (``scale_and_translate``,
    ``method="linear"``): two f32 contractions with the weight matrices."""
    _, h, w, _ = x.shape
    wh = _linear_weights(h, out_h, x.device).to(x.dtype)
    ww = _linear_weights(w, out_w, x.device).to(x.dtype)
    return torch.einsum("bhwc,hi,wj->bijc", x, wh, ww)
