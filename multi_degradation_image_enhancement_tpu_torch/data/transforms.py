"""Batched paired transforms on the device (counterpart of
``multi_degradation_image_enhancement_tpu/data/transforms.py``).

The albumentations backend's ops: HorizontalFlip, VerticalFlip,
RandomRotate90, Resize, RandomBrightnessContrast, RandomGamma, GaussNoise,
MotionBlur, Sharpen, HueSaturationValue, CLAHE, Normalize and ToTensorV2.
The torchvision backend's: Resize (``size`` or ``height``/``width``),
ToTensor, Normalize (on [0, 1] values), RandomHorizontalFlip,
RandomVerticalFlip, RandomRotation and ColorJitter; no transform block means
the torchvision ``ToTensor`` chain.  Images are NHWC f32 in 0..255 in;
``Normalize`` / ``ToTensor`` move them to the network's domain;
``ToTensorV2`` keeps NHWC (value identity), as in the JAX package.

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


def rotation_coords(angle: torch.Tensor, h: int, w: int):
    """Source coordinates ``(sy, sx)`` [B, H, W] of a rotation by ``angle``
    degrees about the centre ((H−1)/2, (W−1)/2), in the JAX op's f32 steps
    and order (``transforms.py:298-319``)."""
    theta = (-angle.to(torch.float32) * torch.pi / 180.0)[:, None, None]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=angle.device)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=angle.device)[None, None, :]
    cos, sin = torch.cos(theta), torch.sin(theta)
    return cy + (yy - cy) * cos - (xx - cx) * sin, cx + (yy - cy) * sin + (xx - cx) * cos


def sample_bilinear_zero(x: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """``map_coordinates(order=1, cval=0)`` of each channel of ``[B,H,W,C]``
    at per-sample coordinates [B, H, W]: the four taps in JAX's order, each
    weighing in only where it lies inside the image."""
    b, h, w, c = x.shape
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy1, wx1 = sy - y0, sx - x0
    flat = x.reshape(b, h * w, c)
    out = torch.zeros_like(x)
    for dy, wy in ((0, 1.0 - wy1), (1, wy1)):
        for dx, wx in ((0, 1.0 - wx1), (1, wx1)):
            yi, xi = (y0 + dy).long(), (x0 + dx).long()
            valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, h * w, 1)
            tap = torch.gather(flat, 1, idx.expand(b, h * w, c)).reshape(b, h, w, c)
            out = out + (wy * wx * valid)[..., None] * tap
    return out


def _op_rotation(degrees: float) -> Op:
    """RandomRotation: an angle uniform in ±``degrees`` per sample, bilinear,
    zero outside (torchvision's op, as the JAX package computes it)."""

    def apply(x, angle):
        sy, sx = rotation_coords(angle.to(x.device), x.shape[1], x.shape[2])
        return sample_bilinear_zero(x, sy, sx)

    return (lambda s, g, d: _uniform(s, g, d, -degrees, degrees)), apply


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


def _op_to_tensor_scale() -> Op:
    """torchvision ToTensor's values: 0..255 → [0, 1] (NHWC kept)."""
    return _no_params, lambda x, _: x / 255.0


def _op_identity() -> Op:
    return _no_params, lambda x, _: x


def _gray(x: torch.Tensor) -> torch.Tensor:
    return 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]


def hue_shift(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Rotate each sample's hue by ``shift`` [B] (a fraction of the colour
    wheel) in YIQ, clipped to 0..255 (``_hue_shift``, ``transforms.py:351``)."""
    angle = shift * 2.0 * torch.pi
    cos, sin = torch.cos(angle)[:, None, None], torch.sin(angle)[:, None, None]
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = _gray(x)
    i = 0.596 * r - 0.274 * g - 0.322 * b
    q = 0.211 * r - 0.523 * g + 0.312 * b
    i2 = i * cos - q * sin
    q2 = i * sin + q * cos
    r2 = y + 0.956 * i2 + 0.621 * q2
    g2 = y - 0.272 * i2 - 0.647 * q2
    b2 = y - 1.106 * i2 + 1.703 * q2
    return torch.clamp(torch.stack([r2, g2, b2], dim=-1), 0.0, 255.0)


def color_jitter(x: torch.Tensor, brightness=None, contrast=None, saturation=None,
                 hue=None) -> torch.Tensor:
    """ColorJitter on 0..255 NHWC with explicit per-sample parameters [B]
    (``None`` skips a step), in the JAX op's fixed order: brightness factor,
    contrast factor about the image's mean gray, saturation factor about each
    pixel's gray, hue shift; each clipped to 0..255."""
    out = x
    if brightness is not None:
        out = torch.clamp(out * _per_sample(brightness), 0.0, 255.0)
    if contrast is not None:
        mean = _gray(out).mean(dim=(1, 2), keepdim=True)[..., None]
        out = torch.clamp(mean + _per_sample(contrast) * (out - mean), 0.0, 255.0)
    if saturation is not None:
        gray = _gray(out)[..., None]
        out = torch.clamp(gray + _per_sample(saturation) * (out - gray), 0.0, 255.0)
    if hue is not None:
        out = hue_shift(out, hue)
    return out


def _op_color_jitter(brightness: float = 0.0, contrast: float = 0.0, saturation: float = 0.0,
                     hue: float = 0.0, **_ignored) -> Op:
    """torchvision ColorJitter (``_op_color_jitter``, ``transforms.py:322``):
    factors U(max(0, 1 − a), 1 + a) for each amount a set, a hue shift
    U(−hue, hue); see :func:`color_jitter`."""

    def sample(shape, gen, device):
        params = {}
        for name, amount in (("brightness", brightness), ("contrast", contrast),
                             ("saturation", saturation)):
            if amount:
                params[name] = _uniform(shape, gen, device, max(0.0, 1.0 - amount), 1.0 + amount)
        if hue:
            params["hue"] = _uniform(shape, gen, device, -hue, hue)
        return params

    return sample, lambda x, params: color_jitter(x, **params)


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
        return _op_identity()
    raise ValueError(f"[albumentations] Transform not supported: {name}")


def _tv_op(name: str, args: Dict[str, Any]) -> Op:
    """The torchvision backend's ops (``_tv_op``, ``transforms.py:272-295``)."""
    if name == "Resize":
        h, w = tuple(args["size"]) if "size" in args else (args["height"], args["width"])
        return _op_resize(h, w)
    if name == "ToTensor":
        return _op_to_tensor_scale()
    if name == "Normalize":  # on ToTensor's [0, 1] values
        return _op_normalize(args["mean"], args["std"], 1.0)
    if name == "RandomHorizontalFlip":
        return _op_hflip(args.get("p", 0.5))
    if name == "RandomVerticalFlip":
        return _op_vflip(args.get("p", 0.5))
    if name == "RandomRotation":
        return _op_rotation(args.get("degrees", 0))
    if name == "ColorJitter":
        return _op_color_jitter(**args)
    raise ValueError(f"[torchvision] Transform not supported: {name}")


class DeviceTransform:
    """A chain of batched ops with paired parameter sharing."""

    def __init__(self, ops: List[Op], target_hw: Optional[Tuple[int, int]]):
        self.ops = ops
        self.target_hw = target_hw  # size the loader should deliver batches at

    def __call__(self, images: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        for sample, apply in self.ops:
            images = apply(images, sample(images.shape, generator, images.device))
        return images

    def apply_paired(self, inp: torch.Tensor, tgt: torch.Tensor, generator: torch.Generator):
        """The same parameters on input and target (albumentations
        ``additional_targets`` semantics)."""
        for sample, apply in self.ops:
            params = sample(inp.shape, generator, inp.device)
            inp, tgt = apply(inp, params), apply(tgt, params)
        return inp, tgt


def build_transforms(transform_cfg: Optional[Dict[str, Any]]) -> Tuple[str, DeviceTransform]:
    """A transform chain from a config block; returns ``(backend, transform)``.
    No block: the torchvision ``ToTensor`` chain (``transforms.py:399-400``)."""
    if not transform_cfg:
        return "torchvision", DeviceTransform([_op_to_tensor_scale()], None)
    backend = transform_cfg.get("backend", "torchvision")
    make_op = {"albumentations": _albu_op, "torchvision": _tv_op}.get(backend)
    target_hw: Optional[Tuple[int, int]] = None
    ops: List[Op] = []
    for op in transform_cfg.get("ops", []) or []:
        name, args = op["name"], op.get("args", {}) or {}
        if name == "Resize":
            target_hw = tuple(args["size"]) if "size" in args else (args["height"], args["width"])
        if make_op is None:  # raised at the first op, as in the JAX package
            raise ValueError(f"Unknown transform backend: {backend}")
        ops.append(make_op(name, args))
    return backend, DeviceTransform(ops, target_hw)
