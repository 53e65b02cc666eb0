"""Batched paired transforms on the device (counterpart of
``multi_degradation_image_enhancement_tpu/data/transforms.py``).

The albumentations backend's ops: HorizontalFlip, VerticalFlip,
RandomRotate90, Resize, RandomBrightnessContrast, RandomGamma, GaussNoise,
MotionBlur, Sharpen, HueSaturationValue, CLAHE, Normalize and ToTensorV2.
The torchvision backend (and the default ToTensor chain it implies) raises
and names ROADMAP.md.  Images are NHWC f32 in 0..255 in; ``Normalize`` moves
them to the network's domain; ``ToTensorV2`` keeps NHWC (value identity), as
in the JAX package.

An op is a pair ``(sample, apply)``: ``sample(shape, generator, device)``
draws the batch's per-sample parameters once (on the images' device, so no
host synchronisation), and ``apply(images, params)`` is deterministic.  A
pair gets the same parameters on input and target, as the JAX package's key
sharing gives them; so photometric ops (gamma, brightness, contrast, noise)
change the target too, as they do there (``transforms.py:383-388``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from multi_degradation_image_enhancement_tpu_torch.ops.degradations import motion_blur
from multi_degradation_image_enhancement_tpu_torch.ops.image import resize_bilinear_cv

# An op: (sample(shape, generator, device) -> params, apply(images, params) -> images)
Op = Tuple[Callable[[torch.Size, torch.Generator, torch.device], Any],
           Callable[[torch.Tensor, Any], torch.Tensor]]


def _no_params(shape, gen, device):
    return None


def _applied(shape, gen, device, p: float) -> torch.Tensor:
    """Per-sample Bernoulli(p) decisions [B]."""
    return torch.rand(shape[0], generator=gen, device=device) < p


def _uniform(shape, gen, device, lo: float, hi: float) -> torch.Tensor:
    return torch.rand(shape[0], generator=gen, device=device) * (hi - lo) + lo


def _per_sample(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None, None]


def _select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(_per_sample(mask), a, b)


def _op_hflip(p: float) -> Op:
    return (lambda s, g, d: _applied(s, g, d, p)), lambda x, m: _select(m, x.flip(2), x)


def _op_vflip(p: float) -> Op:
    return (lambda s, g, d: _applied(s, g, d, p)), lambda x, m: _select(m, x.flip(1), x)


def _op_rot90(p: float) -> Op:
    """RandomRotate90: with probability p rotate by k·90°, k ~ U{0..3}
    (np.rot90 convention); odd k on a non-square canvas is resized back to
    H×W, as the JAX package does (``transforms.py:66-90``)."""

    def sample(shape, gen, device):
        applied = _applied(shape, gen, device, p)
        return torch.randint(0, 4, (shape[0],), generator=gen, device=device) * applied

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


def _op_brightness_contrast(brightness_limit: float = 0.2, contrast_limit: float = 0.2,
                            p: float = 0.5) -> Op:
    """RandomBrightnessContrast (brightness by max): ``x·α + β·255``,
    α = 1 + U(−c, c), β = U(−b, b), clipped to 0..255."""

    def sample(shape, gen, device):
        applied = _applied(shape, gen, device, p).float()
        alpha = 1.0 + _uniform(shape, gen, device, -contrast_limit, contrast_limit)
        beta = _uniform(shape, gen, device, -brightness_limit, brightness_limit)
        return 1.0 + (alpha - 1.0) * applied, beta * applied

    def apply(x, params):
        alpha, beta = params
        return torch.clamp(x * _per_sample(alpha) + _per_sample(beta) * 255.0, 0.0, 255.0)

    return sample, apply


def _op_random_gamma(gamma_limit=(80.0, 120.0), p: float = 0.5) -> Op:
    """RandomGamma: ``clip(x/255, 1e-8, 1)^γ · 255``, γ = U(lo, hi)/100."""

    def sample(shape, gen, device):
        applied = _applied(shape, gen, device, p).float()
        gamma = _uniform(shape, gen, device, gamma_limit[0] / 100.0, gamma_limit[1] / 100.0)
        return 1.0 + (gamma - 1.0) * applied

    def apply(x, gamma):
        return torch.pow(torch.clamp(x / 255.0, 1e-8, 1.0), _per_sample(gamma)) * 255.0

    return sample, apply


def _op_gauss_noise(var_limit=(10.0, 50.0), p: float = 0.5) -> Op:
    """GaussNoise: ``clip(x + σ·n)``, σ = √U(var_limit); the same noise ``n``
    on input and target."""

    def sample(shape, gen, device):
        applied = _applied(shape, gen, device, p).float()
        sigma = torch.sqrt(_uniform(shape, gen, device, *var_limit)) * applied
        return _per_sample(sigma) * torch.randn(tuple(shape), generator=gen, device=device)

    return sample, lambda x, noise: torch.clamp(x + noise, 0.0, 255.0)


def _op_motion_blur(blur_limit: int = 7, p: float = 0.5) -> Op:
    """MotionBlur through the degradation's line PSF, k ~ U{3..blur_limit};
    k = 1 (identity taps, still rounded) where not applied."""

    def sample(shape, gen, device):
        applied = _applied(shape, gen, device, p)
        k = torch.randint(3, blur_limit + 1, (shape[0],), generator=gen, device=device)
        return torch.where(applied, k, torch.ones_like(k))

    return sample, motion_blur


def _op_sharpen(alpha=(0.2, 0.5), p: float = 0.5) -> Op:
    """Sharpen, approximated (as in the JAX package) by the post-processing
    ``sharpen`` at the midpoint of ``alpha``."""
    from multi_degradation_image_enhancement_tpu_torch.ops.post_processing import sharpen

    strength = float(sum(alpha) / 2)
    return ((lambda s, g, d: _applied(s, g, d, p)),
            lambda x, m: _select(m, sharpen(x / 255.0, strength=strength) * 255.0, x))


def _op_hsv(hue_limit: float = 20, sat_limit: float = 30, val_limit: float = 20,
            p: float = 0.5) -> Op:
    """HueSaturationValue: per-sample uniform shifts in cv2 HSV."""
    from multi_degradation_image_enhancement_tpu_torch.ops.color import hsv_to_rgb_cv, rgb_to_hsv_cv

    def sample(shape, gen, device):
        applied = _applied(shape, gen, device, p).float()
        return tuple(applied * _uniform(shape, gen, device, -lim, lim)
                     for lim in (hue_limit, sat_limit, val_limit))

    def apply(x, shifts):
        dh, ds, dv = (s[:, None, None] for s in shifts)
        hsv = rgb_to_hsv_cv(x)
        h = torch.remainder(hsv[..., 0] + dh, 180.0)
        s = torch.clamp(hsv[..., 1] + ds, 0.0, 255.0)
        v = torch.clamp(hsv[..., 2] + dv, 0.0, 255.0)
        return torch.clamp(hsv_to_rgb_cv(torch.stack([h, s, v], dim=-1)), 0.0, 255.0)

    return sample, apply


def _op_clahe(clip_limit: float = 4.0, grid=(8, 8), p: float = 0.5) -> Op:
    """CLAHE on the LAB L channel."""
    from multi_degradation_image_enhancement_tpu_torch.ops.clahe import clahe_rgb

    return ((lambda s, g, d: _applied(s, g, d, p)),
            lambda x, m: _select(m, clahe_rgb(x, grid=grid[0], clip_limit=clip_limit), x))


def _op_normalize(mean, std, max_pixel_value: float = 255.0) -> Op:
    mean_t = torch.tensor(mean, dtype=torch.float32) * max_pixel_value
    std_t = torch.tensor(std, dtype=torch.float32) * max_pixel_value
    return _no_params, lambda x, _: (x - mean_t.to(x.device)) / std_t.to(x.device)


def _albu_op(name: str, args: Dict[str, Any]) -> Op:
    p = args.get("p", 0.5)
    if name == "HorizontalFlip":
        return _op_hflip(p)
    if name == "VerticalFlip":
        return _op_vflip(p)
    if name == "RandomRotate90":
        return _op_rot90(p)
    if name == "Resize":
        return _op_resize(args["height"], args["width"])
    if name == "RandomBrightnessContrast":
        return _op_brightness_contrast(args.get("brightness_limit", 0.2),
                                       args.get("contrast_limit", 0.2), p)
    if name == "GaussNoise":
        return _op_gauss_noise(tuple(args.get("var_limit", (10.0, 50.0))), p)
    if name == "MotionBlur":
        return _op_motion_blur(args.get("blur_limit", 7), p)
    if name == "RandomGamma":
        return _op_random_gamma(tuple(args.get("gamma_limit", (80, 120))), p)
    if name == "Sharpen":
        return _op_sharpen(tuple(args.get("alpha", (0.2, 0.5))), p)
    if name == "HueSaturationValue":
        return _op_hsv(args.get("hue_shift_limit", 20), args.get("sat_shift_limit", 30),
                       args.get("val_shift_limit", 20), p)
    if name == "CLAHE":
        return _op_clahe(args.get("clip_limit", 4.0), tuple(args.get("tile_grid_size", (8, 8))), p)
    if name == "Normalize":
        return _op_normalize(args["mean"], args["std"], args.get("max_pixel_value", 255.0))
    if name == "ToTensorV2":
        return _no_params, lambda x, _: x
    raise ValueError(f"[albumentations] Transform not supported: {name}")


class DeviceTransform:
    """A chain of batched ops with paired parameter sharing."""

    def __init__(self, ops: List[Op], target_hw: Optional[Tuple[int, int]]):
        self.ops = ops
        self.target_hw = target_hw  # size the loader should deliver batches at

    def apply_paired(self, inp: torch.Tensor, tgt: torch.Tensor, generator: torch.Generator):
        """The same parameters on input and target (albumentations
        ``additional_targets`` semantics)."""
        for sample, apply in self.ops:
            params = sample(inp.shape, generator, inp.device)
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
