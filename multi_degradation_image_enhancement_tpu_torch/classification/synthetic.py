"""Synthetic classifier data: composed degradations made on the device each
step (counterpart of
``multi_degradation_image_enhancement_tpu/classification/synthetic.py``).

The offline generator's sampling (``datasets_generation.generate_classifier``,
whose ``plan_variant`` this module calls) is planned on the host, identical
to the JAX package's: degradation count 1/2/3 w.p. 0.6/0.3/0.1,
co-occurrence bias, three pipeline-order templates, Beta-mixture
severities, 10% clean samples, md5-stable per-(image, variant) plans, the
same template ids (``RandomState(md5_int("tmpl::…"))``) and the same
batches (:meth:`SyntheticClassifierLoader._batches`).  A batch holds one
template's samples, so it runs at most that template's nine degradations in
order; each is applied on the device to the samples that carry it
(``ops.severity``), then the train augmentation and the normalisation.  The
draws come from a ``torch.Generator`` on the device per batch, seeded from
(seed, epoch, batch) by ``data.loader.batch_seed``.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from multi_degradation_image_enhancement_tpu_torch.classification.data import (
    TRAIN_AUGMENT,
    to_network_input,
)
from multi_degradation_image_enhancement_tpu_torch.data.dataset import _list_images, _load_rgb
from multi_degradation_image_enhancement_tpu_torch.data.loader import batch_seed, prefetch
from multi_degradation_image_enhancement_tpu_torch.data.synthetic import _procedural_clean
from multi_degradation_image_enhancement_tpu_torch.datasets_generation.common import md5_int
from multi_degradation_image_enhancement_tpu_torch.datasets_generation.generate_classifier import (
    PIPELINES,
    plan_variant,
)
from multi_degradation_image_enhancement_tpu_torch.ops.degradations import DEGRADATIONS
from multi_degradation_image_enhancement_tpu_torch.ops.severity import (
    apply_severity_with_params,
    severity_params,
)


class SyntheticClassifierDataset:
    """Plans (labels, severities, template) per sample; images degrade on the device."""

    def __init__(
        self,
        split: str = "train",
        clean_root: Optional[str] = None,
        n_images: int = 256,
        variants_per_image: int = 2,
        input_hw: Tuple[int, int] = (256, 384),
        seed: int = 42,
    ):
        self.classes = list(DEGRADATIONS)
        self.input_hw = tuple(input_hw)
        self.seed = seed

        if clean_root:
            self.clean_root = clean_root
            self._clean = None
            files = _list_images(clean_root)
            self.names = files[:n_images] if n_images else files
        else:
            self.clean_root = None
            split_seed = seed + {"train": 0, "val": 1000, "test": 2000}[split]
            self._clean = _procedural_clean(n_images, input_hw[0], input_hw[1], split_seed)
            self.names = [f"{split}_{i:05d}.png" for i in range(n_images)]

        # one plan per (image, variant), md5-stable like the offline generator
        self.samples: List[Tuple[int, int, dict, int]] = []
        for idx, name in enumerate(self.names):
            for v in range(variants_per_image):
                plan = plan_variant(name, v, seed)
                rng = np.random.RandomState(md5_int(f"tmpl::{name}::v{v}") % (2**31))
                template_id = int(rng.randint(0, len(PIPELINES)))
                self.samples.append((idx, v, plan, template_id))

    def __len__(self) -> int:
        return len(self.samples)

    def labels_rows(self) -> List[dict]:
        """Rows shaped like labels.jsonl, for pos_weight computation."""
        return [
            {"labels": {c: int(c in plan["chosen"]) for c in self.classes}}
            for (_, _, plan, _) in self.samples
        ]

    def clean_image(self, image_idx: int) -> np.ndarray:
        if self._clean is not None:
            return self._clean[image_idx]
        return _load_rgb(os.path.join(self.clean_root, self.names[image_idx]), self.input_hw)


def degrade_template(x: torch.Tensor, template_id: int, ys: np.ndarray, ss: np.ndarray,
                     classes: List[str], gen: torch.Generator) -> torch.Tensor:
    """A template's degradations in its order on f32 0..255 ``x`` [B,H,W,3]:
    each applied to the samples whose label ``ys`` carries it, at their
    severities ``ss`` (both [B, C] on the host)."""
    for d in PIPELINES[template_id]:
        ci = classes.index(d)
        rows = np.flatnonzero(ys[:, ci] > 0.5)
        if rows.size == 0:
            continue
        idx = torch.from_numpy(rows).to(x.device)
        part = x.index_select(0, idx)
        params = severity_params(d, torch.from_numpy(ss[rows, ci]), gen, part.shape)
        x = x.index_copy(0, idx, apply_severity_with_params(d, part, params))
    return x


class SyntheticClassifierLoader:
    """Yields ``(x, y, s, ids)``: device-degraded, augmented, normalised batches."""

    def __init__(
        self,
        dataset: SyntheticClassifierDataset,
        batch_size: int,
        shuffle: bool = False,
        augment: bool = False,
        normalize: bool = True,
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

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _batches(self) -> List[List[int]]:
        """Group sample indices by template, then batch within groups."""
        by_template: dict = {}
        for i, (_, _, _, t) in enumerate(self.dataset.samples):
            by_template.setdefault(t, []).append(i)
        rng = np.random.RandomState(self.seed + self._epoch)
        batches = []
        for t, idxs in sorted(by_template.items()):
            idxs = np.asarray(idxs)
            if self.shuffle:
                rng.shuffle(idxs)
            for i in range(0, len(idxs), self.batch_size):
                batches.append(list(idxs[i : i + self.batch_size]))
        if self.shuffle:
            rng.shuffle(batches)
        return batches

    def _host_batch(self, idxs: List[int]):
        ds = self.dataset
        imgs, ys, ss, ids = [], [], [], []
        for i in idxs:
            img_idx, v, plan, _t = ds.samples[i]
            imgs.append(ds.clean_image(img_idx))
            ys.append([float(c in plan["chosen"]) for c in ds.classes])
            ss.append([float(plan["severities"].get(c, 0.0)) for c in ds.classes])
            ids.append(f"{ds.names[img_idx]}::v{v}")
        return (ds.samples[idxs[0]][3], np.stack(imgs), np.asarray(ys, np.float32),
                np.asarray(ss, np.float32), ids)

    def __iter__(self) -> Iterator:
        batches = self._batches()
        epoch = self._epoch
        self._epoch += 1
        for bi, (template_id, imgs, ys, ss, ids) in enumerate(prefetch(batches, self._host_batch)):
            gen = torch.Generator(device=self.device).manual_seed(batch_seed(self.seed, epoch, bi))
            x = torch.from_numpy(imgs).to(self.device).float()
            x = degrade_template(x, template_id, ys, ss, self.dataset.classes, gen)
            if self.augment is not None:
                x = self.augment(x, gen)
            yield (to_network_input(x, self.normalize), torch.from_numpy(ys).to(self.device),
                   torch.from_numpy(ss).to(self.device), ids)
