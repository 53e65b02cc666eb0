"""Shared host-side helpers of the offline dataset generators (counterpart of
``multi_degradation_image_enhancement_tpu/datasets_generation/common.py``).

Behavioural contracts kept from the JAX package:

* letterbox resize to (256, 384) with RGB(128, 128, 128) padding, by
  OpenCV's ``INTER_AREA`` rule (written here in NumPy: the card's machine
  has no OpenCV);
* persisted split JSONs keyed by seed and ratios;
* md5-stable per-file and per-variant RNG streams (Python's
  ``random.Random`` and NumPy's generators, bit-identical across the two
  packages).

Images are decoded with PIL, EXIF orientation applied, as ``cv2.imread``
does by default.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import random
from typing import Dict, List, Tuple

import numpy as np

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".webp")

TARGET_SIZE = (256, 384)  # (H, W)
PADDING_COLOR_RGB = (128, 128, 128)

_COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS: 2^11 fixed-point bilinear weights


def list_images(folder: str) -> List[str]:
    return sorted(
        f
        for f in os.listdir(folder)
        if os.path.isfile(os.path.join(folder, f)) and f.lower().endswith(IMG_EXTS)
    )


def _area_weights(src: int, dst: int) -> np.ndarray:
    """``[dst, src]`` fractional-area weights of a downscale (``dst <= src``),
    OpenCV's ``computeResizeAreaTab``: output cell ``d`` covers
    ``[d·s, (d+1)·s)`` of the source (``s = src/dst``), each source pixel
    weighted by its covered share; slivers under 1e-3 are dropped."""
    scale = src / dst
    weights = np.zeros((dst, src), np.float64)
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            weights[d, s1 - 1] += (s1 - f1) / cell
        weights[d, s1:s2] += 1.0 / cell
        if f2 - s2 > 1e-3:
            weights[d, s2] += min(min(f2 - s2, 1.0), cell) / cell
    return weights


def _area_up_taps(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """OpenCV's ``INTER_AREA`` taps where an axis is not a downscale on both
    axes (its bilinear path in "area mode"): the source index of each output,
    the next one (clamped) and the 11-bit fixed-point weights of both."""
    scale, inv = src / dst, dst / src
    d = np.arange(dst)
    s = np.floor(d * scale).astype(np.int64)
    f = ((d + 1) - (s + 1) * inv).astype(np.float32)
    f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    end = s >= src - 1
    f = np.where(end, np.float32(0), f)
    s = np.minimum(s, src - 1)
    one = np.float32(1 << _COEF_BITS)
    w1 = np.rint(f * one).astype(np.int64)
    w0 = np.rint((np.float32(1) - f) * one).astype(np.int64)
    return s, np.minimum(s + 1, src - 1), np.stack([w0, w1])


def resize_area(img: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    """``cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_AREA)`` for
    uint8 ``[H, W, C]``, within 1 LSB (OpenCV's SIMD paths round some ties
    the other way).  A downscale on both axes averages by fractional area
    (one weight matrix per axis; box sums at an integer scale, as OpenCV's
    fast path); otherwise OpenCV runs its fixed-point
    bilinear path with area-mode coefficients, emulated here in integers."""
    h, w = img.shape[:2]
    if (new_h, new_w) == (h, w):
        return img.copy()
    if new_w <= w and new_h <= h:
        if h % new_h == 0 and w % new_w == 0:  # OpenCV's integer-scale box path
            sy, sx = h // new_h, w // new_w
            box = img.astype(np.int64).reshape(new_h, sy, new_w, sx, -1).sum(axis=(1, 3))
            if sy == sx == 2:
                return ((box + 2) >> 2).astype(np.uint8)
            out = box.astype(np.float32) * np.float32(1.0 / (sy * sx))
            return np.clip(np.rint(out), 0, 255).astype(np.uint8)
        wy, wx = _area_weights(h, new_h), _area_weights(w, new_w)
        rows = np.tensordot(img.astype(np.float64), wx, axes=([1], [1]))  # [h, c, x]
        out = np.tensordot(wy, rows, axes=([1], [0])).transpose(0, 2, 1)  # [y, x, c]
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    y0, y1, wy = _area_up_taps(h, new_h)
    x0, x1, wx = _area_up_taps(w, new_w)
    src = img.astype(np.int64)
    rows = src[:, x0] * wx[0][None, :, None] + src[:, x1] * wx[1][None, :, None]
    # the vertical pass as OpenCV's vector code computes it: rows >> 4 times
    # the weight, high 16 bits, the two summed, then (sum + 2) >> 2
    acc = ((rows[y0] >> 4) * wy[0][:, None, None] >> 16) + ((rows[y1] >> 4) * wy[1][:, None, None] >> 16)
    return np.clip((acc + 2) >> 2, 0, 255).astype(np.uint8)


def letterbox_rgb(
    img: np.ndarray,
    target_hw: Tuple[int, int] = TARGET_SIZE,
    pad_color: Tuple[int, int, int] = PADDING_COLOR_RGB,
) -> np.ndarray:
    """Aspect-preserving resize + centre pad, uint8 RGB in and out."""
    target_h, target_w = target_hw
    h, w = img.shape[:2]
    if h == 0 or w == 0:
        raise ValueError("Invalid image with zero dimension.")
    scale = min(target_w / w, target_h / h)
    new_w = max(1, int(round(w * scale)))
    new_h = max(1, int(round(h * scale)))
    resized = resize_area(img, new_w, new_h)
    canvas = np.full((target_h, target_w, 3), pad_color, dtype=np.uint8)
    x0 = (target_w - new_w) // 2
    y0 = (target_h - new_h) // 2
    canvas[y0 : y0 + new_h, x0 : x0 + new_w] = resized
    return canvas


def load_letterboxed_rgb(path: str, target_hw: Tuple[int, int] = TARGET_SIZE) -> np.ndarray:
    from PIL import Image, ImageOps

    try:
        with Image.open(path) as im:
            rgb = np.asarray(ImageOps.exif_transpose(im).convert("RGB"), np.uint8)
    except OSError as e:
        raise RuntimeError(f"Cannot read image: {path}") from e
    return letterbox_rgb(rgb, target_hw)


def save_rgb(img: np.ndarray, path: str) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(img).save(path)


def md5_int(s: str) -> int:
    return int(hashlib.md5(s.encode("utf-8")).hexdigest(), 16)


def stable_index(name: str, modulo: int) -> int:
    """md5-stable index (the curriculum keying of the paired generator)."""
    if modulo <= 0:
        return 0
    return md5_int(name) % modulo


def stable_rng(name: str, variant_id: int, seed: int) -> random.Random:
    return random.Random((md5_int(f"{name}__v{variant_id}") & 0xFFFFFFFF) ^ seed)


def stable_np_rng(name: str, variant_id: int, seed: int) -> np.random.Generator:
    return np.random.default_rng((md5_int(f"np::{name}__v{variant_id}") & 0xFFFFFFFF) ^ seed)


def load_or_create_split(
    names: List[str], split_path: str, ratios: Dict[str, float], seed: int
) -> Dict[str, List[str]]:
    """Persisted deterministic split; re-used if the file already exists."""
    if os.path.exists(split_path):
        with open(split_path, "r", encoding="utf-8") as f:
            return json.load(f)

    if abs(sum(ratios.values()) - 1.0) > 1e-6:
        raise ValueError(f"Split ratios must sum to 1.0: {ratios}")

    rnd = random.Random(seed)
    names = names[:]
    rnd.shuffle(names)

    split: Dict[str, List[str]] = {}
    start = 0
    items = list(ratios.items())
    for i, (split_name, ratio) in enumerate(items):
        if i == len(items) - 1:
            split[split_name] = names[start:]
        else:
            n = int(round(len(names) * ratio))
            split[split_name] = names[start : start + n]
            start += n

    os.makedirs(os.path.dirname(split_path), exist_ok=True)
    with open(split_path, "w", encoding="utf-8") as f:
        json.dump(split, f, indent=2)
    return split
