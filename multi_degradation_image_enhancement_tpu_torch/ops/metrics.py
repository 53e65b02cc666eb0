"""Config-driven metrics pipeline: PSNR, SSIM, LPIPS (counterpart of
``multi_degradation_image_enhancement_tpu/ops/metrics.py``).

The reference's config schema (``metrics.items``: ``name``, ``args``,
``mode`` "paired"/"unpaired"); PSNR and SSIM with torchmetrics semantics
(``ops.ssim``), LPIPS on the frozen AlexNet of ``ops.perceptual``.  Each
value is a mask-aware mean over the valid samples of a padded batch, left
on the device as a scalar.  Images are NHWC.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch

from multi_degradation_image_enhancement_tpu_torch.ops.perceptual import frozen_lpips
from multi_degradation_image_enhancement_tpu_torch.ops.ssim import masked_mean
from multi_degradation_image_enhancement_tpu_torch.ops.ssim import psnr as psnr_fn
from multi_degradation_image_enhancement_tpu_torch.ops.ssim import ssim as ssim_fn


@dataclass
class MetricItem:
    name: str
    mode: str  # "paired" | "unpaired"
    fn: Callable[..., torch.Tensor]


class MetricsPipeline:
    """An ordered list of metric items, not a name-keyed dict, so two items
    of one name under different modes both survive; the mode filter picks
    which contribute to a call (``metrics.py:35-65``)."""

    def __init__(self, metrics: List[MetricItem]):
        self.metrics = list(metrics)

    def __call__(self, outputs: torch.Tensor, targets: Optional[torch.Tensor] = None,
                 inputs: Optional[torch.Tensor] = None, is_paired: bool = True,
                 mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        for item in self.metrics:
            if (item.mode == "paired" and not is_paired) or (item.mode == "unpaired" and is_paired):
                continue
            val = item.fn(outputs=outputs, targets=targets, inputs=inputs, mask=mask)
            out[item.name] = val.mean() if val.dim() != 0 else val
        return out


def _require_targets(name: str, targets) -> None:
    if targets is None:
        raise ValueError(f"{name} metric requires targets (paired dataset).")


def build_metrics_pipeline(metrics_cfg: Optional[Dict[str, Any]], device) -> MetricsPipeline:
    """A :class:`MetricsPipeline` from a ``metrics`` config block; LPIPS's
    frozen network is placed on ``device`` (the engine's)."""
    if not metrics_cfg or not metrics_cfg.get("enabled", True):
        return MetricsPipeline([])

    metrics: List[MetricItem] = []
    for it in metrics_cfg.get("items", []) or []:
        name = it["name"]
        args = it.get("args", {}) or {}
        mode = it.get("mode", "paired") or "paired"
        if name == "psnr":
            def psnr(outputs, targets=None, inputs=None, mask=None):
                _require_targets("psnr", targets)
                return psnr_fn(outputs, targets, mask=mask)
            metrics.append(MetricItem("psnr", mode, psnr))
        elif name == "ssim":
            def ssim(outputs, targets=None, inputs=None, mask=None):
                _require_targets("ssim", targets)
                return ssim_fn(outputs, targets, mask=mask)
            metrics.append(MetricItem("ssim", mode, ssim))
        elif name == "lpips":
            module = frozen_lpips(args, device)

            def lpips(outputs, targets=None, inputs=None, mask=None, _m=module):
                _require_targets("lpips", targets)
                return masked_mean(_m(outputs, targets), mask)
            metrics.append(MetricItem("lpips", mode, lpips))
        else:
            raise ValueError(f"Unknown metric: {name}")
    return MetricsPipeline(metrics)
