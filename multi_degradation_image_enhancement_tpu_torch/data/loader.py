"""Device-resident data loader for synthetic paired datasets (counterpart of
``multi_degradation_image_enhancement_tpu/data/loader.py``).

The clean set is copied to the device once (uint8 NHWC); a batch is a device
gather, the dataset's degradation (``ops.degradations.apply_degradation``,
any of the nine; noise by its plain version, ``degradations.py:124``, as the
JAX loader uses) and the paired transform, all on the device.  Yields ``(inputs, targets, mask)``: NHWC f32
in the transform's output domain and a per-sample validity vector ``[B]`` of
{0., 1.}.  Every sample is kept; a final partial batch is padded to the full
batch size by repeating its last sample, and the mask excludes the repeats.

Epoch shuffling uses ``np.random.RandomState(seed + epoch)``, as the JAX
loader does, so both visit samples in the same order.  Each batch draws its
degradation and augmentation from a ``torch.Generator`` on the device,
seeded from ``(seed, epoch, batch)``.  Only datasets that synthesise their
pairs on the device are ported (ROADMAP.md, queue 1).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator

import numpy as np
import torch

from multi_degradation_image_enhancement_tpu_torch.ops.degradations import apply_degradation


def batch_seed(seed: int, epoch: int, batch: int) -> int:
    """A well-mixed 63-bit seed for batch ``batch`` of ``epoch``."""
    state = np.random.SeedSequence([seed, epoch, batch]).generate_state(2, np.uint32)
    return int(state[0]) << 31 ^ int(state[1])


class DeviceDataLoader:
    def __init__(self, dataset: Any, batch_size: int, shuffle: bool = False, seed: int = 42,
                 device="cpu"):
        if getattr(dataset, "device_degrade", None) is None:
            raise ValueError("only datasets that synthesise pairs on the device are ported to "
                             "PyTorch yet (ROADMAP.md, queue 1)")
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.device = torch.device(device)
        self._epoch = 0
        self._clean = torch.from_numpy(dataset.clean).to(self.device)

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        epoch = self._epoch
        self._epoch += 1
        bsz = self.batch_size
        for bi, start in enumerate(range(0, n, bsz)):
            idxs = order[start:start + bsz]
            n_valid = len(idxs)
            if n_valid < bsz:
                idxs = np.concatenate([idxs, np.full(bsz - n_valid, idxs[-1])])
            gen = torch.Generator(device=self.device).manual_seed(batch_seed(self.seed, epoch, bi))
            clean = self._clean[torch.from_numpy(idxs).to(self.device)].float()
            degraded = apply_degradation(self.dataset.device_degrade, clean, gen)
            inputs, targets = self.dataset.transform.apply_paired(degraded, clean, gen)
            mask = (torch.arange(bsz, device=self.device) < n_valid).float()
            yield inputs, targets, mask


def define_dataloader(dataset: Any, dataloader_config: Dict[str, Any], device="cpu"):
    """Signature of the JAX package's ``define_dataloader`` plus the device;
    ``num_workers`` has no use here (nothing is decoded on the host)."""
    return DeviceDataLoader(
        dataset,
        batch_size=dataloader_config["batch_size"],
        shuffle=bool(dataloader_config.get("shuffle", False)),
        seed=int(dataloader_config.get("seed", 42) or 42),
        device=device,
    )
