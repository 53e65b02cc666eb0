"""The degrade → restore serving step (counterpart of ``bench.py:139-190``
``build_pipeline``).

One step is the fused noise degrade (``ops.cuda.noise``, bf16 output when the
forward runs in bf16) followed by the fused CDAN forward
(``models.cdan_fast.build_serving_apply``), under ``torch.inference_mode()``.
On ``device="cuda"`` both run their CUDA kernels; ``device="cpu"`` runs the
plain versions.  Asking for CUDA without a card raises.

Usage::

    step, clean = build_pipeline(128, 256, torch.bfloat16, "cuda")
    restored = step(clean, torch.Generator().manual_seed(0))  # [B,H,W,3] f32
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from multi_degradation_image_enhancement_tpu_torch.models.cdan import init_cdan
from multi_degradation_image_enhancement_tpu_torch.models.cdan_fast import (
    build_serving_apply,
    resolve_device,
)
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.noise import degrade_noise_batch_fast


def clean_batch(batch: int, height: int, width: int, device="cpu") -> torch.Tensor:
    """The bench's deterministic clean batch: ``|sin(arange·0.001)|·255``, NHWC f32."""
    n = batch * height * width * 3
    x = torch.abs(torch.sin(torch.arange(n, dtype=torch.float32, device=device) * 0.001))
    return (x * 255.0).reshape(batch, height, width, 3)


def build_pipeline(
    batch: int,
    size: int,
    dtype=torch.bfloat16,
    device="cuda",
    *,
    generator: Optional[torch.Generator] = None,
    tuning: Optional[Dict[str, Any]] = None,
) -> Tuple[Callable[[torch.Tensor, torch.Generator], torch.Tensor], torch.Tensor]:
    """Build the serving step and its clean input batch.

    The model is a CDAN with seeded weights drawn through ``generator`` (a CPU
    generator; seed 0 when omitted).  Returns ``(step, clean)`` where
    ``step(clean255, generator) -> restored`` takes the clean batch (NHWC, f32,
    0..255, on ``device``) and a generator for σ and the noise seed (a CPU
    generator keeps the draw off the device), and returns the restored batch
    (NHWC, f32, [0, 1]).  The step takes any batch and H, W multiples of 8.
    ``tuning`` reaches ``build_serving_apply`` (None: the serving tuning
    file).
    """
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = init_cdan(generator)
    forward = build_serving_apply(model, dtype, device, tuning)
    noise_dtype = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32

    def step(clean255: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        with torch.inference_mode():
            degraded, _ = degrade_noise_batch_fast(clean255, gen, out_dtype=noise_dtype)
            return forward(degraded)

    return step, clean_batch(batch, size, size, device)
