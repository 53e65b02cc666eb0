"""CLAHE (contrast-limited adaptive histogram equalisation) on batched
tensors (counterpart of ``multi_degradation_image_enhancement_tpu/ops/
clahe.py``), cv2.createCLAHE semantics as the albumentations ``CLAHE``
transform uses them: per-tile 256-bin histograms of the uint8-quantised LAB
L channel, clipped with uniform redistribution of the excess, per-tile
equalisation LUTs, and bilinear interpolation of the four neighbouring
tiles' LUTs per pixel.

The JAX package builds its histograms as one-hot sums (matrix-unit work on
the TPU); here each tile's histogram is one ``scatter_add_`` of ones, and the
LUT lookups are gathers.  Counts are exact integers in f32 either way.
"""

from __future__ import annotations

import torch

from multi_degradation_image_enhancement_tpu_torch.ops.color import replace_lab_l, rgb_to_lab_l


def _tile_luts(l_u8: torch.Tensor, grid: int, clip_limit: float) -> torch.Tensor:
    """Per-tile LUTs: ``l_u8`` [B,H,W] int64 in 0..255 → [B, g, g, 256] f32."""
    b, h, w = l_u8.shape
    th, tw = h // grid, w // grid
    tiles = l_u8.reshape(b, grid, th, grid, tw).transpose(2, 3).reshape(b, grid, grid, th * tw)
    hist = torch.zeros((b, grid, grid, 256), dtype=torch.float32, device=l_u8.device)
    hist.scatter_add_(3, tiles, torch.ones(tiles.shape, dtype=torch.float32, device=l_u8.device))
    # clip + uniform redistribution (cv2: limit = max(clip·P/256, 1))
    limit = max(clip_limit * (th * tw) / 256.0, 1.0)
    excess = torch.sum(torch.clamp(hist - limit, min=0.0), dim=-1, keepdim=True)
    hist = torch.clamp(hist, max=limit) + excess / 256.0
    cdf = torch.cumsum(hist, dim=-1)
    return torch.clamp(torch.round(cdf * (255.0 / (th * tw))), 0.0, 255.0)


def _interp_coords(n: int, tile: int, grid: int, device):
    """Per pixel along one axis: the two tile indices and the weight of the second."""
    pos = (torch.arange(n, dtype=torch.float32, device=device) - tile / 2.0 + 0.5) / tile
    lo = torch.floor(pos)
    i0 = torch.clamp(lo, 0, grid - 1).long()
    frac = torch.clamp(pos - lo, 0.0, 1.0)
    frac = torch.where(pos < 0, torch.zeros_like(frac),
                       torch.where(pos > grid - 1, torch.ones_like(frac), frac))
    return i0, torch.clamp(i0 + 1, max=grid - 1), frac


def clahe_l_channel(l255: torch.Tensor, grid: int = 8, clip_limit: float = 4.0) -> torch.Tensor:
    """CLAHE on an L-channel batch [B,H,W] in 0..255 (H, W divisible by grid)."""
    b, h, w = l255.shape
    l_u8 = torch.clamp(torch.round(l255), 0, 255).long()
    luts = _tile_luts(l_u8, grid, clip_limit).reshape(b, grid * grid, 256)
    y0, y1, fy = _interp_coords(h, h // grid, grid, l255.device)
    x0, x1, fx = _interp_coords(w, w // grid, grid, l255.device)
    fy, fx = fy[:, None], fx[None, :]

    def lookup(ty, tx):
        tile = (ty[:, None] * grid + tx[None, :]).reshape(1, h * w).expand(b, -1)
        flat = tile * 256 + l_u8.reshape(b, h * w)
        return torch.gather(luts.reshape(b, -1), 1, flat).reshape(b, h, w)

    top = lookup(y0, x0) * (1 - fx) + lookup(y0, x1) * fx
    bot = lookup(y1, x0) * (1 - fx) + lookup(y1, x1) * fx
    return top * (1 - fy) + bot * fy


def clahe_rgb(rgb255: torch.Tensor, grid: int = 8, clip_limit: float = 4.0) -> torch.Tensor:
    """albumentations-style CLAHE on RGB [B,H,W,3] in 0..255, through LAB L."""
    new_l = clahe_l_channel(rgb_to_lab_l(rgb255), grid=grid, clip_limit=clip_limit)
    return replace_lab_l(rgb255, new_l)
