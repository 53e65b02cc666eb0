"""The one traffic generator.  Every mix is a data file,
``traffic/<name>.json``, read here; nothing in it is code.

Every mix holds ``kind``, the name of the driver that runs it: the file
``drive_<kind>.py`` beside this one (see ``drivers``), not one of a fixed set
of words.  A mix of a new kind holds ``kind``, ``trace_steps`` (the steps of
its traced window) and ``cpu_dry_run`` (the sizes its CPU tests run at);
everything else in it belongs to its driver, which reads it.

Keys of the mixes of ``drive_serve`` and ``drive_train``:

* ``kind``: ``"serve"`` (inference batches through the serving forward) or
  ``"train"`` (optimizer steps);
* ``batch``, ``height``, ``width``: every request's shape (the same for every
  seed; the seed changes only the pixels, the degradations' severities and
  the order);
* ``pool``: distinct inputs made at set-up and cycled (serve: batches;
  train: image pairs);
* serve: ``loop`` ``"closed"`` with ``clients`` 1 (the next request is sent
  when the last is ready), ``sample`` (``batches`` kept for the check, drawn
  from the first ``within``, plus the last; ``rows`` compared of each);
* train: ``reference_steps`` (the set-up steps the reference follows);
* ``trace_steps``: the steps of the traced window;
* ``cpu_dry_run``: the sizes that replace these on the CPU (tests only).

Images are procedural (six random 2-D cosines per channel plus texture,
stretched to 0..255, as the program's synthetic dataset draws them),
degraded by the configuration's ``degradation``: ``noise`` (Gaussian, σ
uniform in its range per image, ``floor(clip(x + σ·n))``) on the device, or
``jpeg`` (PIL, quality uniform in its range per image) on the host, quantised
to 8 bits.  NHWC in [0, 1] where a batch is served or stepped.
"""

from __future__ import annotations

import io
import json
import math
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


def load(name: str, cpu_dry_run: bool = False) -> Dict:
    with open(TRAFFIC_DIR / f"{name}.json", encoding="utf-8") as f:
        mix = json.load(f)
    if cpu_dry_run:
        mix.update(mix.get("cpu_dry_run", {}))
    return mix


@torch.no_grad()
def clean_images(gen: torch.Generator, n: int, h: int, w: int, device) -> torch.Tensor:
    """uint8 NHWC ``[n, h, w, 3]``: per image and channel a sum of six random
    2-D cosines (frequencies 0.5–6 cycles across, amplitudes 10–60) plus
    N(0, 6²) texture, stretched to 0..255."""
    u = torch.rand(n, 6, 8, device=device, generator=gen)
    fy, fx = 0.5 + 5.5 * u[..., 0], 0.5 + 5.5 * u[..., 1]
    phase, amp = 2 * math.pi * u[..., 2:5], 10 + 50 * u[..., 5:8]
    yy = torch.arange(h, device=device, dtype=torch.float32) / h
    xx = torch.arange(w, device=device, dtype=torch.float32) / w
    img = torch.randn(n, h, w, 3, device=device, generator=gen) * 6.0
    for k in range(6):
        base = 2 * math.pi * (fy[:, k, None, None] * yy[None, :, None] +
                              fx[:, k, None, None] * xx[None, None, :])
        img += amp[:, k, None, None, :] * torch.cos(base[..., None] + phase[:, k, None, None, :])
    lo = img.amin(dim=(1, 2, 3), keepdim=True)
    hi = img.amax(dim=(1, 2, 3), keepdim=True)
    return ((img - lo) / (hi - lo).clamp(min=1e-6) * 255.0).round().to(torch.uint8)


@torch.no_grad()
def add_noise(clean: torch.Tensor, gen: torch.Generator, sigma: Sequence[float]) -> torch.Tensor:
    """Gaussian noise of a per-image σ ~ U[sigma] (0..255 scale),
    ``floor(clip(x + σ·n, 0, 255))``, uint8."""
    n = clean.shape[0]
    s = torch.empty(n, device=clean.device).uniform_(float(sigma[0]), float(sigma[1]),
                                                     generator=gen)
    noisy = clean.float() + s[:, None, None, None] * torch.randn(
        clean.shape, device=clean.device, generator=gen)
    return noisy.clamp(0.0, 255.0).floor().to(torch.uint8)


def _jpeg_one(args) -> np.ndarray:
    from PIL import Image

    img, quality = args
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=int(quality))
    buf.seek(0)
    with Image.open(buf) as dec:
        return np.asarray(dec.convert("RGB"), dtype=np.uint8)


def jpeg(clean: torch.Tensor, gen: torch.Generator, quality: Sequence[int],
         threads: int = 4) -> torch.Tensor:
    """A PIL JPEG round trip of each image at a quality drawn uniformly from
    ``quality`` (inclusive), on ``threads`` host threads; uint8, on
    ``clean``'s device."""
    q = torch.randint(int(quality[0]), int(quality[1]) + 1, (clean.shape[0],),
                      device=clean.device, generator=gen).tolist()
    host = clean.cpu().numpy()
    with ThreadPoolExecutor(threads) as pool:
        out = list(pool.map(_jpeg_one, zip(host, q)))
    return torch.from_numpy(np.stack(out)).to(clean.device)


def degrade(clean: torch.Tensor, gen: torch.Generator, spec: Dict) -> torch.Tensor:
    if spec["name"] == "noise":
        return add_noise(clean, gen, spec["sigma"])
    if spec["name"] == "jpeg":
        return jpeg(clean, gen, spec["quality"])
    raise ValueError(f"the generator has no degradation {spec['name']!r}")


def to01(t: torch.Tensor) -> torch.Tensor:
    return t.float() / 255.0


def serve_pool(gen: torch.Generator, mix: Dict, degradation: Dict, device) -> List[torch.Tensor]:
    """``pool`` distinct degraded batches, f32 NHWC in [0, 1]."""
    b, h, w = mix["batch"], mix["height"], mix["width"]
    clean = clean_images(gen, mix["pool"] * b, h, w, device)
    noisy = to01(degrade(clean, gen, degradation))
    return list(noisy.split(b))


def train_pool(gen: torch.Generator, mix: Dict, degradation: Dict, device):
    """(degraded, clean): ``pool`` resident image pairs, uint8 NHWC."""
    clean = clean_images(gen, mix["pool"], mix["height"], mix["width"], device)
    return degrade(clean, gen, degradation), clean


class BatchOrder:
    """Which pool rows each step takes: a fresh permutation of the pool per
    epoch, drawn from the seed, so every step within an epoch takes rows
    that no other step of it took."""

    def __init__(self, seed: int, pool: int, batch: int):
        self.gen = torch.Generator().manual_seed(seed)
        self.pool, self.batch = pool, batch
        self.rows: List[int] = []

    def take(self, step: int) -> List[int]:
        while len(self.rows) < (step + 1) * self.batch:
            self.rows += torch.randperm(self.pool, generator=self.gen).tolist()[
                :self.pool - self.pool % self.batch]
        return self.rows[step * self.batch:(step + 1) * self.batch]


def dropout_masks(gen: torch.Generator, batch: int, h: int, w: int, device) -> List[torch.Tensor]:
    """The four Bernoulli(0.8) keep masks of a CDAN train step (NCHW, the
    encoder's sites after the three pools and after conv4)."""
    shapes = [(batch, 64, h // 2, w // 2), (batch, 128, h // 4, w // 4),
              (batch, 256, h // 8, w // 8), (batch, 512, h // 8, w // 8)]
    return [torch.rand(s, device=device, generator=gen) < 0.8 for s in shapes]


def sample_steps(seed: int, sample: Dict) -> List[int]:
    """The window's requests kept for the check: ``batches`` drawn from the
    first ``within`` (the last request of the window is kept besides)."""
    gen = torch.Generator().manual_seed(seed + 1)
    within, k = int(sample["within"]), int(sample["batches"])
    return sorted(torch.randperm(within, generator=gen)[:k].tolist())


def sample_rows(seed: int, batch: int, rows: int) -> List[int]:
    gen = torch.Generator().manual_seed(seed + 2)
    return sorted(torch.randperm(batch, generator=gen)[:min(rows, batch)].tolist())
