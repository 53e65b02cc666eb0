"""Config-driven loss pipeline (counterpart of
``multi_degradation_image_enhancement_tpu/ops/losses.py``).

Weighted multi-term losses with per-term paired/unpaired filtering and a
per-component report.  Terms: ``mse``, ``l1``, ``charbonnier`` (eps 1e-3),
``ssim`` (1 − SSIM), ``channel_mean``, ``gradient_l1`` (L1 on Sobel
gradients, optionally on luma), ``vgg_perceptual`` (MSE of frozen VGG19
features) and ``lpips`` (per-sample LPIPS-alex, masked mean), and the
optional ``worst_case`` weighting.  Images are NHWC.

The frozen networks of the perceptual terms are built once per pipeline, on
the pipeline's device (``ops.perceptual.init_frozen_params``).  Callers run
the loss outside any bf16 autocast, so these terms run in f32 as in JAX;
gradients reach the outputs only (the networks do not require grad, and the
targets' features are taken without a graph).

Under a mesh (``parallel.mesh.shard_train_step``) the pipeline gathers the
``spatial`` shards of its images and returns this rank's share of each
global mean over ``data`` (``ops.ssim.masked_mean``); the step sums the
shares for the report.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch

from multi_degradation_image_enhancement_tpu_torch.ops.image import conv3x3_fixed, rgb_to_luma
from multi_degradation_image_enhancement_tpu_torch.ops.perceptual import (
    VGG19Features,
    frozen_lpips,
    init_frozen_params,
)
from multi_degradation_image_enhancement_tpu_torch.ops.ssim import masked_mean
from multi_degradation_image_enhancement_tpu_torch.ops.ssim import ssim as ssim_fn
from multi_degradation_image_enhancement_tpu_torch.parallel import collectives
from multi_degradation_image_enhancement_tpu_torch.utils.tracing import span

_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
_SOBEL_Y = ((-1.0, -2.0, -1.0), (0.0, 0.0, 0.0), (1.0, 2.0, 1.0))


def sobel_gradients(x: torch.Tensor) -> torch.Tensor:
    """Per-channel Sobel gradients with zero padding: [B,H,W,C] → [B,H,W,C,2]."""
    kx = torch.tensor(_SOBEL_X, dtype=x.dtype, device=x.device)
    ky = torch.tensor(_SOBEL_Y, dtype=x.dtype, device=x.device)
    return torch.stack([conv3x3_fixed(x, kx), conv3x3_fixed(x, ky)], dim=-1)


@dataclass
class LossTerm:
    name: str
    weight: float
    mode: str  # "paired" | "unpaired"
    fn: Callable[..., torch.Tensor]


class LossPipeline:
    """Weighted sum of loss terms; returns each component plus ``total``.

    ``worst_case`` (``{"fraction": f, "scale": s}``), applied only with
    ``training=True``: per-image totals, the worst ``k = round(f·B)`` images
    (clipped to 1..B) weighted ``s`` and the rest 1, by a threshold on the
    detached losses, so ties at the threshold up-weight more than ``k``
    images (``losses.py:119-157`` as written); ``total`` is the weighted mean.

    Each term's call, or its per-image calls under ``worst_case``, is the
    span ``loss/<term name>`` (``utils.tracing``; a device range on the card).
    """

    def __init__(self, terms: List[LossTerm], worst_case: Optional[Dict[str, Any]] = None):
        self.terms = terms
        self.worst_case = dict(worst_case) if worst_case else None

    def __call__(self, outputs, targets=None, inputs=None, is_paired: bool = True, mask=None,
                 training: bool = False) -> Dict[str, torch.Tensor]:
        # under a spatial mesh axis, the whole images (SSIM filters in valid
        # mode; VGG and LPIPS see whole images): every spatial rank of a data
        # shard computes its loss, and keeps its own rows' gradient
        outputs, targets, inputs = (None if t is None else collectives.gather_h(t)
                                    for t in (outputs, targets, inputs))
        if training and self.worst_case is not None and is_paired:
            return self._call_worst_case(outputs, targets, inputs, mask)
        components: Dict[str, torch.Tensor] = {}
        total = torch.zeros((), dtype=torch.float32, device=outputs.device)
        for term in self.terms:
            if (term.mode == "paired" and not is_paired) or (term.mode == "unpaired" and is_paired):
                continue
            with span(f"loss/{term.name}", device=outputs.device):
                val = term.fn(outputs=outputs, targets=targets, inputs=inputs, mask=mask)
                val = val.mean() if val.dim() != 0 else val
            components[term.name] = val
            total = total + term.weight * val
        components["total"] = total
        return components

    def _call_worst_case(self, outputs, targets, inputs, mask) -> Dict[str, torch.Tensor]:
        """Under a mesh's ``data`` axis the rank holds ``b`` of the global
        batch's images: ``k`` and the threshold come from the global batch
        (the ranks' detached per-image totals gathered in batch order), and
        each mean is this rank's share over the all-reduced denominator."""
        b = outputs.shape[0]
        group = collectives.loss_group()
        mesh = collectives.active_mesh()
        shards, index = (1, 0) if group is None else (mesh.size("data"), mesh.index("data"))
        b_all = b * shards
        frac = float(self.worst_case.get("fraction", 0.25))
        scale = float(self.worst_case.get("scale", 3.0))
        k = min(max(int(round(frac * b_all)), 1), b_all)
        valid = (torch.ones((b,), dtype=torch.float32, device=outputs.device) if mask is None
                 else mask.reshape(b).float())
        n_valid = collectives.all_reduce_detached(valid.sum(), group)
        components: Dict[str, torch.Tensor] = {}
        per_image_total = torch.zeros((b,), dtype=torch.float32, device=outputs.device)
        for term in self.terms:
            if term.mode == "unpaired":
                continue
            with span(f"loss/{term.name}", device=outputs.device), collectives.unsharded():
                # one image's term, as one device computes it
                val = torch.stack([
                    term.fn(outputs=outputs[i:i + 1], targets=targets[i:i + 1],
                            inputs=None if inputs is None else inputs[i:i + 1])
                    for i in range(b)
                ]).reshape(b).float()
            # the plain (unweighted) masked mean keeps logged components comparable
            components[term.name] = (val * valid).sum() / torch.clamp(n_valid, min=1.0)
            per_image_total = per_image_total + term.weight * val
        ranked = torch.where(valid > 0, per_image_total.detach(),
                             torch.full_like(per_image_total, float("-inf")))
        ranked_all = collectives.all_gather_detached(ranked, group, shards, index).reshape(b_all)
        thresh = torch.sort(ranked_all).values[b_all - k]
        weights = torch.where(ranked >= thresh, scale, 1.0) * valid
        weight_sum = collectives.all_reduce_detached(weights.sum(), group)
        components["total"] = (weights * per_image_total).sum() / torch.clamp(
            weight_sum, min=1e-8)
        return components


def _require_targets(name: str, targets) -> None:
    if targets is None:
        raise ValueError(f"{name} loss requires targets (paired dataset).")


def build_loss_pipeline(loss_cfg: Optional[Dict[str, Any]], device) -> LossPipeline:
    """A :class:`LossPipeline` from a config block (the reference's schema,
    with a single MSE term when disabled or empty); the perceptual terms'
    frozen networks live on ``device``."""
    if not loss_cfg or not loss_cfg.get("enabled", True):
        loss_cfg = {"terms": [{"name": "mse", "weight": 1.0, "args": {}}]}
    terms_cfg = loss_cfg.get("terms", []) or [{"name": "mse", "weight": 1.0, "args": {}}]
    built = [
        LossTerm(name=t["name"], weight=float(t.get("weight", 1.0)),
                 mode=t.get("mode", "paired") or "paired",
                 fn=_make_term(t["name"], t.get("args", {}) or {}, torch.device(device)))
        for t in terms_cfg
    ]
    return LossPipeline(built, worst_case=loss_cfg.get("worst_case"))


def _make_term(name: str, args: Dict[str, Any], device: torch.device) -> Callable[..., torch.Tensor]:
    if name == "mse":
        def mse(outputs, targets=None, inputs=None, mask=None):
            _require_targets("mse", targets)
            return masked_mean(torch.square(outputs - targets), mask)
        return mse

    if name == "l1":
        def l1(outputs, targets=None, inputs=None, mask=None):
            _require_targets("l1", targets)
            return masked_mean(torch.abs(outputs - targets), mask)
        return l1

    if name == "charbonnier":
        eps = float(args.get("eps", 1e-3))

        def charbonnier(outputs, targets=None, inputs=None, mask=None):
            _require_targets("charbonnier", targets)
            diff = outputs - targets
            return masked_mean(torch.sqrt(diff * diff + eps * eps), mask)
        return charbonnier

    if name == "ssim":
        def ssim_loss(outputs, targets=None, inputs=None, mask=None):
            _require_targets("ssim", targets)
            # under a data axis the 1 is shared too: this rank's share of it
            one = 1.0 if collectives.loss_group() is None else masked_mean(
                torch.ones(outputs.shape[0], device=outputs.device), mask)
            return one - ssim_fn(outputs, targets, mask=mask)
        return ssim_loss

    if name == "channel_mean":
        def channel_mean(outputs, targets=None, inputs=None, mask=None):
            _require_targets("channel_mean", targets)
            axes = tuple(range(1, outputs.dim() - 1))  # spatial dims of NHWC
            return masked_mean(torch.abs(outputs.mean(dim=axes) - targets.mean(dim=axes)), mask)
        return channel_mean

    if name == "gradient_l1":
        to_gray = bool(args.get("to_gray", False))

        def gray(x):
            return rgb_to_luma(x) if x.shape[-1] == 3 else x.mean(dim=-1, keepdim=True)

        def gradient_l1(outputs, targets=None, inputs=None, mask=None):
            _require_targets("gradient_l1", targets)
            x, y = (gray(outputs), gray(targets)) if to_gray else (outputs, targets)
            return masked_mean(torch.abs(sobel_gradients(x) - sobel_gradients(y)), mask)
        return gradient_l1

    if name == "vgg_perceptual":
        vgg = init_frozen_params(VGG19Features(int(args.get("layers", 20))),
                                 "vgg19_features.npz").to(device)

        def vgg_perceptual(outputs, targets=None, inputs=None, mask=None):
            _require_targets("vgg_perceptual", targets)
            with torch.no_grad():
                ft = vgg(targets)
            return masked_mean(torch.square(vgg(outputs) - ft), mask)
        return vgg_perceptual

    if name == "lpips":
        module = frozen_lpips(args, device)

        def lpips(outputs, targets=None, inputs=None, mask=None):
            _require_targets("lpips", targets)
            return masked_mean(module(outputs, targets), mask)
        return lpips

    raise ValueError(f"Unknown loss term: {name}")
