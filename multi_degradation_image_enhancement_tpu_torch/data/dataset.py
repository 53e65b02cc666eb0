"""Image directories (the listing and decoding part of
``multi_degradation_image_enhancement_tpu/data/dataset.py``).

Only what the serving CLI reads: the extensions (:data:`_IMG_EXTS`, ``:24``),
the sorted listing (:func:`_list_images`, ``:27``) and the PIL branch of
:func:`_load_rgb` (``:84-102``), which is the JAX package's own fallback when
its native decoder is absent.  The native host decoder and the paired
datasets are not ported yet.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".webp")


def _list_images(folder: str) -> List[str]:
    return sorted(
        f
        for f in os.listdir(folder)
        if not f.startswith(".") and f.lower().endswith(_IMG_EXTS)
    )


def _load_rgb(path: str, target_hw: Optional[Tuple[int, int]]) -> np.ndarray:
    """Decode to uint8 RGB [H,W,3]; resized (bilinear) only when its size
    differs from ``target_hw``."""
    img = Image.open(path).convert("RGB")
    if target_hw is not None and (img.height, img.width) != tuple(target_hw):
        img = img.resize((target_hw[1], target_hw[0]), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)
