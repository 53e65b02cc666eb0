"""JPEG degradation as an 8×8 DCT / quantise / dequantise round trip on
batched tensors (counterpart of ``multi_degradation_image_enhancement_tpu/
ops/jpeg.py``):

  RGB → JFIF YCbCr → 4:2:0 chroma (2×2 mean) → per-plane 8×8 DCT-II →
  IJG quality-scaled quantisation (round) → dequantise → IDCT →
  "fancy" (triangle) chroma upsample → RGB → round(clip).

Every constant is f32 and every step follows the JAX order.  The 8×8
transforms are written as elementwise multiply-adds over the block axes
(:func:`_sandwich`) rather than matmuls: one PyTorch op per term, so the card
and the CPU compute the same bits whatever the TF32 settings
(``torch.backends.cuda.matmul.allow_tf32`` defaults to False, but a caller
may turn it on).  ``round`` is half to even in both frameworks.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from multi_degradation_image_enhancement_tpu_torch.ops.image import true_div

# IJG standard quantisation tables (Annex K of the JPEG spec).
LUMA_QTABLE = (
    (16, 11, 10, 16, 24, 40, 51, 61),
    (12, 12, 14, 19, 26, 58, 60, 55),
    (14, 13, 16, 24, 40, 57, 69, 56),
    (14, 17, 22, 29, 51, 87, 80, 62),
    (18, 22, 37, 56, 68, 109, 103, 77),
    (24, 35, 55, 64, 81, 104, 113, 92),
    (49, 64, 78, 87, 103, 121, 120, 101),
    (72, 92, 95, 98, 112, 100, 103, 99),
)
CHROMA_QTABLE = ((17, 18, 24, 47, 99, 99, 99, 99),
                 (18, 21, 26, 66, 99, 99, 99, 99),
                 (24, 26, 56, 99, 99, 99, 99, 99),
                 (47, 66, 99, 99, 99, 99, 99, 99)) + ((99,) * 8,) * 4


def _dct8_matrix() -> torch.Tensor:
    """Orthonormal 8-point DCT-II matrix D (``X = D x Dᵀ``), f32.  The cosine
    argument is formed in f32 as in JAX; the cosine itself is taken in f64
    and rounded, which reproduces the JAX package's ``_DCT8`` bit for bit
    (torch's f32 ``cos`` is one ulp off at one entry)."""
    k = torch.arange(8, dtype=torch.float32)[:, None]
    n = torch.arange(8, dtype=torch.float32)[None, :]
    arg = (2.0 * n + 1.0) * k * torch.tensor(math.pi / 16.0, dtype=torch.float32)
    m = torch.cos(arg.double()).float()
    alpha = torch.where(k == 0, torch.tensor(math.sqrt(1.0 / 8.0), dtype=torch.float32),
                        torch.tensor(math.sqrt(2.0 / 8.0), dtype=torch.float32))
    return alpha * m


_DCT8 = _dct8_matrix()


def quality_to_qtables(quality: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """IJG quality ``[B]`` → (luma, chroma) tables ``[B, 8, 8]``:
    scale = floor(5000/q) for q < 50 else 200 − 2q;
    T = clip(floor((base·scale + 50)/100), 1, 255)."""
    q = quality.to(torch.float32)
    scale = torch.where(q < 50.0, torch.floor(true_div(5000.0, q)), 200.0 - 2.0 * q)[..., None, None]

    def scaled(base):
        base = torch.tensor(base, dtype=torch.float32, device=q.device)
        return torch.clamp(torch.floor(true_div(base * scale + 50.0, 100.0)), 1.0, 255.0)

    return scaled(LUMA_QTABLE), scaled(CHROMA_QTABLE)


def _to_blocks(plane: torch.Tensor) -> torch.Tensor:
    """[B,H,W] → [B, H/8, W/8, 8, 8]."""
    b, h, w = plane.shape
    return plane.reshape(b, h // 8, 8, w // 8, 8).transpose(2, 3)


def _from_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """[B, Hb, Wb, 8, 8] → [B, H, W]."""
    b, hb, wb = blocks.shape[:3]
    return blocks.transpose(2, 3).reshape(b, hb * 8, wb * 8)


def _sandwich(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``m · x · mᵀ`` on the trailing 8×8 axes of ``x``, as 8 + 8 elementwise
    multiply-adds (summed in index order)."""
    m = m.to(x.device)
    left = torch.zeros_like(x)
    for j in range(8):  # left[i, k] = Σ_j m[i, j] x[j, k]
        left = left + m[:, j, None] * x[..., j:j + 1, :]
    out = torch.zeros_like(x)
    for k in range(8):  # out[i, l] = Σ_k left[i, k] m[l, k]
        out = out + left[..., :, k:k + 1] * m[None, :, k]
    return out


def dct2_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """8×8 DCT-II on [..., 8, 8] blocks."""
    return _sandwich(_DCT8, blocks)


def idct2_blocks(coefs: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`dct2_blocks` (orthonormal: ``Dᵀ c D``)."""
    return _sandwich(_DCT8.t().contiguous(), coefs)


def _quantize_plane(plane: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """DCT → round(coef/qt)·qt → IDCT for one [B,H,W] plane; qtable [B,8,8]."""
    coefs = dct2_blocks(_to_blocks(plane - 128.0))
    qt = qtable[:, None, None]
    return _from_blocks(idct2_blocks(torch.round(coefs / qt) * qt)) + 128.0


def rgb_to_ycbcr(rgb: torch.Tensor):
    """JFIF RGB → YCbCr planes, 0..255. rgb: [B,H,W,3]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0
    return y, cb, cr


def ycbcr_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """JFIF YCbCr planes → [B,H,W,3] RGB, unclipped."""
    cb = cb - 128.0
    cr = cr - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136286 * cb - 0.714136286 * cr
    b = y + 1.772 * cb
    return torch.stack([r, g, b], dim=-1)


def _downsample_2x2(plane: torch.Tensor) -> torch.Tensor:
    """h2v2 chroma downsample: 2×2 mean, [B,H,W] → [B,H/2,W/2]."""
    b, h, w = plane.shape
    p = plane.reshape(b, h // 2, 2, w // 2, 2)
    return (p[:, :, 0, :, 0] + p[:, :, 0, :, 1] + p[:, :, 1, :, 0] + p[:, :, 1, :, 1]) / 4.0


def _fancy_upsample_axis(plane: torch.Tensor, axis: int) -> torch.Tensor:
    """libjpeg h2v2 "fancy" upsample along one axis (×2): sample 2i is
    (3·x[i] + x[i−1])/4, sample 2i+1 is (3·x[i] + x[i+1])/4, edges
    replicated."""
    n = plane.shape[axis]
    prev = torch.cat([plane.narrow(axis, 0, 1), plane.narrow(axis, 0, n - 1)], dim=axis)
    nxt = torch.cat([plane.narrow(axis, 1, n - 1), plane.narrow(axis, n - 1, 1)], dim=axis)
    even = (3.0 * plane + prev) * 0.25
    odd = (3.0 * plane + nxt) * 0.25
    shape = list(plane.shape)
    shape[axis] *= 2
    return torch.stack([even, odd], dim=axis + 1).reshape(shape)


def _fancy_upsample_2x2(plane: torch.Tensor) -> torch.Tensor:
    """[B,H,W] → [B,2H,2W] (axis 1, then axis 2)."""
    return _fancy_upsample_axis(_fancy_upsample_axis(plane, 1), 2)


def _edge_pad(x: torch.Tensor, axis: int, pad: int) -> torch.Tensor:
    n = x.shape[axis]
    return x.index_select(axis, torch.clamp(torch.arange(n + pad, device=x.device), max=n - 1))


def jpeg_roundtrip(rgb: torch.Tensor, quality: torch.Tensor) -> torch.Tensor:
    """JPEG-compress-and-decode [B,H,W,3] f32 in 0..255 at per-sample IJG
    ``quality`` [B]; returns the decoded batch on the uint8 lattice.  Sizes
    that are not multiples of 16 are edge-padded to whole 4:2:0 MCUs, as
    libjpeg pads, and cropped back."""
    b, h, w, _ = rgb.shape
    ph, pw = (-h) % 16, (-w) % 16
    if ph:
        rgb = _edge_pad(rgb, 1, ph)
    if pw:
        rgb = _edge_pad(rgb, 2, pw)
    quality = torch.broadcast_to(torch.as_tensor(quality, device=rgb.device), (b,))
    luma_qt, chroma_qt = quality_to_qtables(quality)

    y, cb, cr = rgb_to_ycbcr(rgb)
    cb = _downsample_2x2(cb)
    cr = _downsample_2x2(cr)
    y = _quantize_plane(y, luma_qt)
    cb = _fancy_upsample_2x2(_quantize_plane(cb, chroma_qt))
    cr = _fancy_upsample_2x2(_quantize_plane(cr, chroma_qt))
    out = torch.round(torch.clamp(ycbcr_to_rgb(y, cb, cr), 0.0, 255.0))
    return out[:, :h, :w, :]
