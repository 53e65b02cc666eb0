"""Device data loader (counterpart of
``multi_degradation_image_enhancement_tpu/data/loader.py``).

Three modes, the JAX loader's:

* datasets that synthesise their pairs on the device (``device_degrade``,
  ``data.synthetic``) from a procedural clean set: the set is copied to the
  device once (uint8 NHWC); a batch is a device gather, the dataset's
  degradation (``ops.degradations.apply_degradation``, any of the nine;
  noise by its plain version, ``degradations.py:124``, as the JAX loader
  uses) and the paired transform, all on the device;
* the same with a ``clean_root``: a pool of threads decodes the clean
  images of batch i+1 while batch i runs; each batch is moved to the device,
  degraded and transformed there;
* host-decoded directory datasets (``data.dataset.PairedDataset`` and
  ``UnpairedDataset``): decoded one batch ahead as above, then moved to the
  device and transformed there.

Host decoding goes through the native engine (``data.io_native``, one call a
batch on the pool's thread count) where it is available, else through PIL on
the pool.

Yields ``(inputs, targets, mask)``: NHWC f32 in the transform's output
domain and a per-sample validity vector ``[B]`` of {0., 1.}; an unpaired
dataset yields ``targets`` None.  Every sample is kept; a final partial
batch is padded to the full batch size by repeating its last sample, and the
mask excludes the repeats (the JAX loader's padding and mask).

Epoch shuffling uses ``np.random.RandomState(seed + epoch)``, as the JAX
loader does, so both visit samples in the same order.  Each batch draws its
degradation and augmentation from a ``torch.Generator`` on the device,
seeded from ``(seed, epoch, batch)``.

The wait for each batch and its device work is the host span
``data/next_batch`` (``utils.tracing``).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, Sequence

import numpy as np
import torch

from multi_degradation_image_enhancement_tpu_torch.data import io_native
from multi_degradation_image_enhancement_tpu_torch.ops.degradations import apply_degradation
from multi_degradation_image_enhancement_tpu_torch.utils.tracing import span


def batch_seed(seed: int, epoch: int, batch: int) -> int:
    """A well-mixed 63-bit seed for batch ``batch`` of ``epoch``."""
    state = np.random.SeedSequence([seed, epoch, batch]).generate_state(2, np.uint32)
    return int(state[0]) << 31 ^ int(state[1])


def prefetch(batches: Sequence, load: Callable) -> Iterator:
    """``load(batch)`` for each batch on a helper thread, one batch ahead of
    the consumer: batch i+1 loads while batch i is used.  A failure in
    ``load`` is raised to the consumer.  A consumer that stops early leaves
    at most that one load running; the thread ends when it returns."""
    ahead = ThreadPoolExecutor(max_workers=1)
    try:
        pending = ahead.submit(load, batches[0]) if len(batches) else None
        for i in range(len(batches)):
            item = pending.result()
            pending = ahead.submit(load, batches[i + 1]) if i + 1 < len(batches) else None
            yield item
    finally:
        ahead.shutdown(wait=False, cancel_futures=True)


class DeviceDataLoader:
    def __init__(self, dataset: Any, batch_size: int, shuffle: bool = False, seed: int = 42,
                 device="cpu", num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.device = torch.device(device)
        self._epoch = 0
        self._degrade = getattr(dataset, "device_degrade", None)
        self._paired = bool(getattr(dataset, "paired", True))
        self._clean = None  # the device-resident clean set, when the dataset holds one
        if self._degrade is not None and getattr(dataset, "clean", None) is not None:
            self._clean = torch.from_numpy(dataset.clean).to(self.device)
        else:
            self._pool = ThreadPoolExecutor(max_workers=max(1, int(num_workers) or 1))

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _host_batch(self, idxs: np.ndarray):
        """Decode a batch: (inputs, targets) u8 [B,H,W,3], or (inputs, None)
        for an unpaired dataset or a clean set to degrade.  With a transform
        size, one native-engine call on the pool's thread count decodes the
        whole batch (both halves of a paired batch in one), as the JAX
        loader does (``loader.py:110-135``); else the pool decodes image by
        image (``_load_rgb``)."""
        hw = getattr(self.dataset.transform, "target_hw", None)
        paired = self._paired and self._degrade is None
        files = getattr(self.dataset, "files", None)
        if hw is not None and io_native.available() and (paired or files is not None):
            if paired:
                pairs = [self.dataset.pairs[i] for i in idxs]
                paths = [p[0] for p in pairs] + [p[1] for p in pairs]
            else:
                paths = [files[i] for i in idxs]
            flat = io_native.decode_batch(paths, hw[0], hw[1], n_threads=self._pool._max_workers)
            if flat is not None:
                return (flat[:len(idxs)], flat[len(idxs):]) if paired else (flat, None)
        if paired:
            pairs = list(self._pool.map(self.dataset.load_pair, idxs))
            return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])
        return np.stack(list(self._pool.map(self.dataset.load_single, idxs))), None

    def __iter__(self) -> Iterator:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        epoch = self._epoch
        self._epoch += 1
        bsz = self.batch_size
        batches, n_valids = [], []
        for start in range(0, n, bsz):
            idxs = order[start:start + bsz]
            n_valids.append(len(idxs))
            if len(idxs) < bsz:
                idxs = np.concatenate([idxs, np.full(bsz - len(idxs), idxs[-1])])
            batches.append(idxs)
        feed = iter(batches if self._clean is not None else prefetch(batches, self._host_batch))
        for bi, n_valid in enumerate(n_valids):
            with span("data/next_batch"):
                gen = torch.Generator(device=self.device).manual_seed(
                    batch_seed(self.seed, epoch, bi))
                batch = self._device_batch(next(feed), n_valid, gen)
            yield batch

    def _device_batch(self, item, n_valid: int, gen: torch.Generator):
        """One yielded ``(inputs, targets, mask)`` from ``item``: the clean
        set's rows to gather, or a decoded host batch."""
        bsz, transform = self.batch_size, self.dataset.transform
        mask = (torch.arange(bsz, device=self.device) < n_valid).float()
        if self._clean is not None:
            clean = self._clean[torch.from_numpy(item).to(self.device)].float()
        elif self._degrade is not None:
            clean = torch.from_numpy(item[0]).to(self.device).float()
        if self._degrade is not None:
            degraded = apply_degradation(self._degrade, clean, gen)
            return (*transform.apply_paired(degraded, clean, gen), mask)
        inp_u8, tgt_u8 = item
        inp = torch.from_numpy(inp_u8).to(self.device).float()
        if tgt_u8 is None:
            return transform(inp, gen), None, mask
        tgt = torch.from_numpy(tgt_u8).to(self.device).float()
        return (*transform.apply_paired(inp, tgt, gen), mask)


def define_dataloader(dataset: Any, dataloader_config: Dict[str, Any], device="cpu"):
    """Signature of the JAX package's ``define_dataloader`` plus the device."""
    return DeviceDataLoader(
        dataset,
        batch_size=dataloader_config["batch_size"],
        shuffle=bool(dataloader_config.get("shuffle", False)),
        seed=int(dataloader_config.get("seed", 42) or 42),
        device=device,
        num_workers=int(dataloader_config.get("num_workers", 0) or 0),
    )
