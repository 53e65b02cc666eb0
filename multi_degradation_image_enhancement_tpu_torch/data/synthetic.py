"""Synthetic paired dataset: clean images whose pairs the loader degrades on
the device (counterpart of
``multi_degradation_image_enhancement_tpu/data/synthetic.py``).

Every degradation name of ``ops.degradations`` is accepted.  Two clean
sources, as in the JAX package:

* procedural (no ``clean_root``): deterministic band-limited random images,
  made once and kept on the device by the loader;
* ``clean_root``: a directory of images (e.g. the output of
  ``datasets_generation.select_clean_images``), each decoded on the host by
  the loader's pool at the transform's size (``data.dataset._load_rgb``);
  ``n_images`` is ignored.

Config usage (a dataset block):

    {"name": ["data.synthetic", "SyntheticPairedDataset"],
     "args": {"degradation": "noise", "n_images": 512, "seed": 42,
              "transform": {...}}}
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from multi_degradation_image_enhancement_tpu_torch.data.dataset import _list_images, _load_rgb
from multi_degradation_image_enhancement_tpu_torch.data.transforms import build_transforms
from multi_degradation_image_enhancement_tpu_torch.ops import degradations


def _procedural_clean(n: int, h: int, w: int, seed: int = 42) -> np.ndarray:
    """Deterministic band-limited random RGB images, uint8 ``[n, h, w, 3]``:
    a sum of six random 2-D cosines plus mild texture, stretched to 0..255.
    NumPy only, bit-identical to the JAX package's."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    imgs = np.empty((n, h, w, 3), np.float32)
    for i in range(n):
        img = np.zeros((h, w, 3), np.float32)
        for _ in range(6):
            fy, fx = rng.uniform(0.5, 6.0, 2)
            phase = rng.uniform(0, 2 * np.pi, 3)
            amp = rng.uniform(10, 60, 3)
            base = 2 * np.pi * (fy * yy / h + fx * xx / w)
            img += amp * np.cos(base[..., None] + phase)
        img += rng.normal(0, 6.0, (h, w, 3))
        img = img - img.min()
        img = img / max(img.max(), 1e-6) * 255.0
        imgs[i] = img
    return imgs.astype(np.uint8)


class SyntheticPairedDataset:
    """Clean images whose pairs the loader synthesises on the device with
    ``ops.degradations.apply_degradation(degradation, clean, generator)``,
    then the paired transform.  ``clean`` holds the procedural set (uint8
    NHWC) or is None for a ``clean_root``, whose images ``load_single``
    decodes."""

    paired = True

    def __init__(self, degradation: str = "noise", clean_root: Optional[str] = None,
                 n_images: int = 512, height: int = 256, width: int = 384, seed: int = 42,
                 transform: Optional[Dict] = None):
        degradations.check_name(degradation)  # an unknown name raises
        self.device_degrade = degradation
        self.backend, self.transform = build_transforms(transform)
        self.files: Optional[List[str]] = None
        self.clean: Optional[np.ndarray] = None
        if clean_root:
            self.files = [os.path.join(clean_root, f) for f in _list_images(clean_root)]
            if not self.files:
                raise RuntimeError(f"No images found in {clean_root}")
        else:
            hw = self.transform.target_hw or (height, width)
            self.clean = _procedural_clean(n_images, hw[0], hw[1], seed)

    def __len__(self) -> int:
        return len(self.files) if self.files is not None else len(self.clean)

    def load_single(self, idx: int) -> np.ndarray:
        """Clean image ``idx`` as uint8 ``[H, W, 3]``."""
        if self.clean is not None:
            return self.clean[idx]
        return _load_rgb(self.files[idx], self.transform.target_hw)
