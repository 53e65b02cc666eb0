"""Batched paired transforms on the device (counterpart of
``multi_degradation_image_enhancement_tpu/data/transforms.py``).

The ops that the shipped synthetic configs use, with the albumentations
backend: HorizontalFlip, VerticalFlip, RandomRotate90, Resize, Normalize and
ToTensorV2.  Any other op raises and names ROADMAP.md.  Images are NHWC f32 in
0..255 in; ``Normalize`` moves them to the network's domain; ``ToTensorV2``
keeps NHWC (value identity), as in the JAX package.

Per-sample decisions are drawn from a ``torch.Generator`` (on the images'
device, so no host synchronisation), once per op and batch; a pair gets the
same decisions on input and target.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from multi_degradation_image_enhancement_tpu_torch.ops.image import resize_bilinear_cv

# An op: (sample(batch, generator, device) -> params, apply(images, params) -> images)
Op = Tuple[Callable[[int, torch.Generator, torch.device], Any], Callable[[torch.Tensor, Any], torch.Tensor]]


def _no_params(b, gen, device):
    return None


def _bernoulli(p: float):
    def sample(b, gen, device):
        return torch.rand(b, generator=gen, device=device) < p
    return sample


def _select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[:, None, None, None], a, b)


def _op_hflip(p: float) -> Op:
    return _bernoulli(p), lambda x, m: _select(m, x.flip(2), x)


def _op_vflip(p: float) -> Op:
    return _bernoulli(p), lambda x, m: _select(m, x.flip(1), x)


def _op_rot90(p: float) -> Op:
    """RandomRotate90: with probability p rotate by k·90°, k ~ U{0..3}
    (np.rot90 convention); odd k on a non-square canvas is resized back to
    H×W, as the JAX package does (``transforms.py:66-90``)."""

    def sample(b, gen, device):
        applied = torch.rand(b, generator=gen, device=device) < p
        return torch.randint(0, 4, (b,), generator=gen, device=device) * applied

    def apply(x, factor):
        _, h, w, _ = x.shape
        r1 = resize_bilinear_cv(torch.rot90(x, 1, dims=(1, 2)), h, w)
        r2 = torch.rot90(x, 2, dims=(1, 2))
        r3 = resize_bilinear_cv(torch.rot90(x, 3, dims=(1, 2)), h, w)
        out = _select(factor == 1, r1, x)
        out = _select(factor == 2, r2, out)
        return _select(factor == 3, r3, out)

    return sample, apply


def _op_resize(height: int, width: int) -> Op:
    def apply(x, _):
        if x.shape[1] == height and x.shape[2] == width:
            return x
        return resize_bilinear_cv(x, height, width)
    return _no_params, apply


def _op_normalize(mean, std, max_pixel_value: float = 255.0) -> Op:
    mean_t = torch.tensor(mean, dtype=torch.float32) * max_pixel_value
    std_t = torch.tensor(std, dtype=torch.float32) * max_pixel_value
    return _no_params, lambda x, _: (x - mean_t.to(x.device)) / std_t.to(x.device)


def _albu_op(name: str, args: Dict[str, Any]) -> Op:
    if name == "HorizontalFlip":
        return _op_hflip(args.get("p", 0.5))
    if name == "VerticalFlip":
        return _op_vflip(args.get("p", 0.5))
    if name == "RandomRotate90":
        return _op_rot90(args.get("p", 0.5))
    if name == "Resize":
        return _op_resize(args["height"], args["width"])
    if name == "Normalize":
        return _op_normalize(args["mean"], args["std"], args.get("max_pixel_value", 255.0))
    if name == "ToTensorV2":
        return _no_params, lambda x, _: x
    raise ValueError(
        f"[albumentations] transform {name!r} is not ported to PyTorch yet (ROADMAP.md, queue 1)"
    )


class DeviceTransform:
    """A chain of batched ops with paired decision sharing."""

    def __init__(self, ops: List[Op], target_hw: Optional[Tuple[int, int]]):
        self.ops = ops
        self.target_hw = target_hw  # size the loader should deliver batches at

    def apply_paired(self, inp: torch.Tensor, tgt: torch.Tensor, generator: torch.Generator):
        """The same decisions on input and target (albumentations
        ``additional_targets`` semantics)."""
        for sample, apply in self.ops:
            params = sample(inp.shape[0], generator, inp.device)
            inp, tgt = apply(inp, params), apply(tgt, params)
        return inp, tgt


def build_transforms(transform_cfg: Optional[Dict[str, Any]]) -> Tuple[str, DeviceTransform]:
    """A transform chain from a config block; returns ``(backend, transform)``.
    Only the albumentations backend is ported."""
    if not transform_cfg:
        raise ValueError("a transform config is required: the default torchvision ToTensor "
                         "chain is not ported to PyTorch yet (ROADMAP.md, queue 1)")
    backend = transform_cfg.get("backend", "torchvision")
    if backend != "albumentations":
        raise ValueError(f"transform backend {backend!r} is not ported to PyTorch yet "
                         "(ROADMAP.md, queue 1)")
    target_hw: Optional[Tuple[int, int]] = None
    ops: List[Op] = []
    for op in transform_cfg.get("ops", []) or []:
        name, args = op["name"], op.get("args", {}) or {}
        if name == "Resize":
            target_hw = (args["height"], args["width"])
        ops.append(_albu_op(name, args))
    return backend, DeviceTransform(ops, target_hw)
