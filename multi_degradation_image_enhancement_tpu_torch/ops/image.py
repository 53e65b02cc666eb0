"""Image helpers (counterpart of ``multi_degradation_image_enhancement_tpu/ops/image.py``).

Batched NHWC float tensors.  Borders follow OpenCV's ``BORDER_REFLECT_101``
(``jnp.pad(mode="reflect")``: the edge pixel is not repeated), done here as
an index gather, which keeps NHWC and allows any pad width.

The tap sums are elementwise multiply-adds in the JAX package's order, one
PyTorch op each: no convolution, so cuDNN's TF32 (on by default for f32
convs) never rounds the operands, and the card computes the same bits as the
CPU.  Per-sample tap weights are a ``[B, taps]`` tensor.
"""

from __future__ import annotations

import torch


def true_div(a, b) -> torch.Tensor:
    """``a / b`` correctly rounded on every device, either operand a Python
    number.  PyTorch's CUDA division by a Python number multiplies by its
    reciprocal, and ``number / tensor`` is ``reciprocal(tensor) · number`` on
    every device; both can move a later floor or round away from the CPU's
    and JAX's result.  Here both operands are f32 tensors on one device."""
    ref = a if isinstance(a, torch.Tensor) else b
    def as_tensor(v):
        return v if isinstance(v, torch.Tensor) else torch.tensor(v, dtype=torch.float32,
                                                                  device=ref.device)
    return torch.div(as_tensor(a), as_tensor(b))


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Source indices of a BORDER_REFLECT_101 pad of ``pad`` on both sides of
    an axis of length ``n`` (repeated reflection when ``pad >= n``)."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    j = torch.remainder(i, period)
    return torch.where(j < n, j, period - j)


def reflect_pad_hw(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Pad H and W of [B,H,W,C] with BORDER_REFLECT_101 semantics."""
    if ph:
        x = x.index_select(1, _reflect_index(x.shape[1], ph, x.device))
    if pw:
        x = x.index_select(2, _reflect_index(x.shape[2], pw, x.device))
    return x


def conv_taps_w(x: torch.Tensor, weights: torch.Tensor, radius: int) -> torch.Tensor:
    """Horizontal tap-sum correlation: ``weights`` [B, 2·radius+1], tap ``i``
    at offset ``i − radius`` (``cv2.filter2D`` convention)."""
    w = x.shape[2]
    xp = reflect_pad_hw(x, 0, radius)
    weights = weights.to(device=x.device, dtype=x.dtype)
    out = torch.zeros_like(x)
    for i in range(2 * radius + 1):
        out = out + weights[:, i, None, None, None] * xp[:, :, i:i + w]
    return out


def conv_taps_h(x: torch.Tensor, weights: torch.Tensor, radius: int) -> torch.Tensor:
    """Vertical tap-sum correlation; see :func:`conv_taps_w`."""
    h = x.shape[1]
    xp = reflect_pad_hw(x, radius, 0)
    weights = weights.to(device=x.device, dtype=x.dtype)
    out = torch.zeros_like(x)
    for i in range(2 * radius + 1):
        out = out + weights[:, i, None, None, None] * xp[:, i:i + h]
    return out


def separable_blur(x: torch.Tensor, weights: torch.Tensor, radius: int) -> torch.Tensor:
    """Separable symmetric blur: the same 1-D taps along W, then H."""
    return conv_taps_h(conv_taps_w(x, weights, radius), weights, radius)


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


def resize_nearest_cv(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv2.INTER_NEAREST-style resize of [B,H,W,C]: source index
    ``floor(dst · in/out)`` in f32, as the JAX package computes it."""
    _, h, w, _ = x.shape

    def index(n_out: int, n_in: int) -> torch.Tensor:
        src = torch.floor(torch.arange(n_out, dtype=torch.float32)
                          * torch.tensor(n_in / n_out, dtype=torch.float32))
        return torch.clamp(src.long(), 0, n_in - 1).to(x.device)

    return x.index_select(1, index(out_h, h)).index_select(2, index(out_w, w))
