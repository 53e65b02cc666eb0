"""The classifier's directory dataset and its device loader (counterpart of
``multi_degradation_image_enhancement_tpu/classification/data.py``).

:class:`MultiLabelSeverityDataset` reads ``<root>/<split>/labels.jsonl``
rows and decodes (image, labels[C], severity[C], rel_path) on the host.
:class:`ClassifierLoader` decodes one batch ahead on a thread pool, moves
it to the device, and augments there (train: hflip 0.5, vflip 0.15,
rotation ±5°), then scales to [0, 1] and ImageNet-normalises.  Epoch order
comes from ``np.random.RandomState(seed + epoch)``, as in the JAX package,
so both visit the samples in the same order; each batch's augmentation
draws from a ``torch.Generator`` on the device seeded from (seed, epoch,
batch) by ``data.loader.batch_seed``.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Tuple

import numpy as np
import torch
from PIL import Image

from multi_degradation_image_enhancement_tpu_torch.classification.model import (
    IMAGENET_MEAN,
    IMAGENET_STD,
)
from multi_degradation_image_enhancement_tpu_torch.data.loader import batch_seed, prefetch
from multi_degradation_image_enhancement_tpu_torch.data.transforms import (
    DeviceTransform,
    _op_hflip,
    _op_rotation,
    _op_vflip,
)


def read_jsonl(path: str) -> List[dict]:
    rows = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


class MultiLabelSeverityDataset:
    def __init__(self, root: str, split: str, classes: List[str], input_hw=(256, 384)):
        self.root = root
        self.split = split
        self.classes = classes
        self.input_hw = tuple(input_hw)
        self.rows = read_jsonl(os.path.join(root, split, "labels.jsonl"))

    def __len__(self) -> int:
        return len(self.rows)

    def load(self, idx: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, str]:
        r = self.rows[idx]
        rel = str(r["file"]).replace("\\", "/")
        with Image.open(os.path.join(self.root, rel)) as im:
            img = im.convert("RGB")
        if (img.height, img.width) != self.input_hw:
            img = img.resize((self.input_hw[1], self.input_hw[0]), Image.BILINEAR)
        y = np.array([r["labels"][c] for c in self.classes], np.float32)
        s = np.array([r["severity"][c] for c in self.classes], np.float32)
        return np.asarray(img, np.uint8), y, s, rel


# The classifier's train augmentation on f32 0..255 NHWC: hflip 0.5, vflip
# 0.15, rotation ±5° (the JAX loader's chain, ``data.py:89-97``).
TRAIN_AUGMENT = DeviceTransform([_op_hflip(0.5), _op_vflip(0.15), _op_rotation(5.0)], None)


def to_network_input(x: torch.Tensor, normalize: bool) -> torch.Tensor:
    """0..255 → [0, 1], then ImageNet mean/std when ``normalize``."""
    x = x / 255.0
    if normalize:
        mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
        std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
        x = (x - mean) / std
    return x


class ClassifierLoader:
    """Yields ``(x, y, s, paths)``: x ``[B, H, W, 3]`` f32 on the device
    (augmented when ``augment``, normalised when ``normalize``), y and s
    ``[B, C]`` f32 on the device, paths the rows' relative files."""

    def __init__(
        self,
        dataset: MultiLabelSeverityDataset,
        batch_size: int,
        shuffle: bool = False,
        augment: bool = False,
        normalize: bool = True,
        num_workers: int = 0,
        seed: int = 42,
        device="cuda",
    ):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.augment = TRAIN_AUGMENT if augment else None
        self.normalize = normalize
        self.seed = seed
        self.device = torch.device(device)
        self._epoch = 0
        self._pool = ThreadPoolExecutor(max_workers=max(1, num_workers or 1))

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _decode(self, idxs: np.ndarray):
        items = list(self._pool.map(self.dataset.load, idxs))
        return (np.stack([it[0] for it in items]), np.stack([it[1] for it in items]),
                np.stack([it[2] for it in items]), [it[3] for it in items])

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, List[str]]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        epoch = self._epoch
        self._epoch += 1
        batches = [order[i : i + self.batch_size] for i in range(0, n, self.batch_size)]
        for bi, (imgs, ys, ss, paths) in enumerate(prefetch(batches, self._decode)):
            x = torch.from_numpy(imgs).to(self.device).float()
            if self.augment is not None:
                gen = torch.Generator(device=self.device).manual_seed(
                    batch_seed(self.seed, epoch, bi))
                x = self.augment(x, gen)
            yield (to_network_input(x, self.normalize), torch.from_numpy(ys).to(self.device),
                   torch.from_numpy(ss).to(self.device), paths)
