"""Directory-backed paired and unpaired datasets (counterpart of
``multi_degradation_image_enhancement_tpu/data/dataset.py``).

``input_root`` (degraded) + ``target_root`` (clean) with the pairing modes
``filename`` / ``stem`` / ``sorted`` (an empty pairing raises); images
decode as RGB through PIL (:func:`_load_rgb`, the JAX package's own path
when its native decoder is absent; the native decoder is not ported).  The
datasets return uint8 NumPy arrays; ``data.loader`` batches them, moves them
to the device and runs the transform there.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from multi_degradation_image_enhancement_tpu_torch.data.transforms import build_transforms

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


def _stem(filename: str) -> str:
    return os.path.splitext(filename)[0]


# Pairing keys per mode: how a file in one root is matched to the other root.
_PAIR_KEYS = {
    "filename": lambda f: f,
    "stem": _stem,
}


def _match_pairs(input_root: str, target_root: str, mode: str) -> List[Tuple[str, str]]:
    """(degraded_path, clean_path) pairs between two directories:
    ``filename`` matches identical names, ``stem`` ignores the extension,
    ``sorted`` zips the two sorted listings (truncating to the shorter)."""
    inp_files = _list_images(input_root)
    tgt_files = _list_images(target_root)

    if mode == "sorted":
        return [
            (os.path.join(input_root, a), os.path.join(target_root, b))
            for a, b in zip(inp_files, tgt_files)
        ]

    key = _PAIR_KEYS.get(mode)
    if key is None:
        raise ValueError(f"Unknown pairing_mode: {mode}")
    by_key_inp = {key(f): f for f in inp_files}
    by_key_tgt = {key(f): f for f in tgt_files}
    pairs = [
        (os.path.join(input_root, by_key_inp[k]), os.path.join(target_root, by_key_tgt[k]))
        for k in sorted(by_key_inp.keys() & by_key_tgt.keys())
    ]
    if not pairs:
        raise RuntimeError(
            f"Pairing produced zero matches (mode={mode!r}) between "
            f"{input_root!r} ({len(inp_files)} images) and "
            f"{target_root!r} ({len(tgt_files)} images)."
        )
    return pairs


class PairedDataset:
    """Degraded/clean pairs from two directories."""

    paired = True

    def __init__(
        self,
        input_root: str,
        target_root: str,
        pairing_mode: str = "filename",
        transform: Optional[Dict] = None,
    ):
        self.input_root = input_root
        self.target_root = target_root
        self.pairs = _match_pairs(input_root, target_root, pairing_mode)
        self.backend, self.transform = build_transforms(transform)

    def __len__(self) -> int:
        return len(self.pairs)

    def load_pair(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        inp_path, tgt_path = self.pairs[idx]
        hw = self.transform.target_hw
        return _load_rgb(inp_path, hw), _load_rgb(tgt_path, hw)


class UnpairedDataset:
    """Inputs only."""

    paired = False

    def __init__(self, input_root: str, transform: Optional[Dict] = None):
        self.input_root = input_root
        self.files = [os.path.join(input_root, f) for f in _list_images(input_root)]
        self.backend, self.transform = build_transforms(transform)

    def __len__(self) -> int:
        return len(self.files)

    def load_single(self, idx: int) -> np.ndarray:
        return _load_rgb(self.files[idx], self.transform.target_hw)
