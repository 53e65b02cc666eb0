"""Image helpers (counterpart of ``multi_degradation_image_enhancement_tpu/ops/image.py``).

Only :func:`quantize_u8` is ported so far; the rest waits for the other
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
