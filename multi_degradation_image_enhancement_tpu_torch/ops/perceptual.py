"""Frozen perceptual feature networks (counterpart of
``multi_degradation_image_enhancement_tpu/ops/perceptual.py``): the VGG19
features of the ``vgg_perceptual`` loss, and LPIPS with the AlexNet, VGG16
or SqueezeNet 1.1 backbone.

:class:`VGG19Features` is the first ``num_layers`` ops (default 20) of
torchvision's ``vgg19().features`` in f32, convs named ``conv_{i}`` by their
``features`` index (``perceptual.py:38-69``); NHWC in and out, NCHW inside.

:class:`LPIPS` follows the JAX module (``perceptual.py:215-262``), itself
torchmetrics' ``LearnedPerceptualImagePatchSimilarity`` as the reference
feeds it: [0, 1] images used as they are, the shift/scale prep, the
backbone's ReLU taps (``alex``: the five of torchvision's
``alexnet().features``, :class:`AlexNetFeatures`; ``vgg``: the five of
``vgg16().features`` at indices 3/8/15/22/29, :class:`VGG16Taps`;
``squeeze``: the seven of ``squeezenet1_1().features``, :class:`SqueezeTaps`),
per tap the channel unit-normalisation (1e-10 under the root), the squared
difference weighted by ``|lin|`` 1×1 weights, the spatial mean, and the sum
over taps: per-sample distances ``[B]``.  Images are NHWC, as in the JAX
package; the backbones run NCHW, their convs named by torchvision's feature
index (``conv_{i}``, ``fire_{i}``).

Weights: :func:`init_frozen_params` loads ``$MDIE_WEIGHTS_DIR/<npz>``,
whose keys are the JAX package's ``/``-joined Flax paths (``net/conv_0/kernel``
HWIO, ``net/conv_0/bias``, ``lin_0`` ``[C, 1]``; ``conv_{i}/kernel`` with no
``net/`` for ``vgg19_features.npz``), mapped to torch layouts; without the
file it keeps seeded, frozen random weights (status ``"random_frozen"``, one
warning).  Those random draws are the port's own (JAX's threefry cannot be
reproduced in torch), so the two packages agree only on loaded or
carried-over weights (``utils.jax_port.load_feature_net``).  Nothing
is downloaded.
"""

from __future__ import annotations

import math
import os
import warnings
from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LPIPS_CHANNELS: Dict[str, Tuple[int, ...]] = {
    "alex": (64, 192, 384, 256, 256),
    "vgg": (64, 128, 256, 512, 512),
    "squeeze": (64, 128, 256, 384, 384, 512, 512),
}

# torchvision vgg19.features: index -> (kind, out_channels)
_VGG19_LAYOUT: Tuple[Tuple[str, int], ...] = (
    ("conv", 64), ("relu", 0), ("conv", 64), ("relu", 0), ("pool", 0),
    ("conv", 128), ("relu", 0), ("conv", 128), ("relu", 0), ("pool", 0),
    ("conv", 256), ("relu", 0), ("conv", 256), ("relu", 0), ("conv", 256),
    ("relu", 0), ("conv", 256), ("relu", 0), ("pool", 0),
    ("conv", 512), ("relu", 0), ("conv", 512), ("relu", 0), ("conv", 512),
    ("relu", 0), ("conv", 512), ("relu", 0), ("pool", 0),
    ("conv", 512), ("relu", 0), ("conv", 512), ("relu", 0), ("conv", 512),
    ("relu", 0), ("conv", 512), ("relu", 0), ("pool", 0),
)

# LPIPS input normalisation constants (shift/scale on [-1, 1] inputs).
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)


class VGG19Features(nn.Module):
    """The first ``num_layers`` ops of torchvision ``vgg19().features``:
    3×3 SAME convs, ReLUs and 2×2 max pools; NHWC in, NHWC out."""

    def __init__(self, num_layers: int = 20):
        super().__init__()
        self.layout = _VGG19_LAYOUT[:num_layers]
        c_in = 3
        for i, (kind, ch) in enumerate(self.layout):
            if kind == "conv":
                setattr(self, f"conv_{i}", nn.Conv2d(c_in, ch, 3, padding=1))
                c_in = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for i, (kind, _) in enumerate(self.layout):
            if kind == "conv":
                x = getattr(self, f"conv_{i}")(x)
            elif kind == "relu":
                x = torch.relu(x)
            else:
                x = F.max_pool2d(x, 2, 2)
        return x.permute(0, 2, 3, 1)


class AlexNetFeatures(nn.Module):
    """torchvision ``alexnet().features`` returning the five ReLU taps LPIPS
    uses; convs named by their ``features`` index, as in the JAX module."""

    def __init__(self):
        super().__init__()
        self.conv_0 = nn.Conv2d(3, 64, 11, stride=4, padding=2)
        self.conv_3 = nn.Conv2d(64, 192, 5, padding=2)
        self.conv_6 = nn.Conv2d(192, 384, 3, padding=1)
        self.conv_8 = nn.Conv2d(384, 256, 3, padding=1)
        self.conv_10 = nn.Conv2d(256, 256, 3, padding=1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        t0 = torch.relu(self.conv_0(x))
        t1 = torch.relu(self.conv_3(F.max_pool2d(t0, 3, 2)))
        t2 = torch.relu(self.conv_6(F.max_pool2d(t1, 3, 2)))
        t3 = torch.relu(self.conv_8(t2))
        t4 = torch.relu(self.conv_10(t3))
        return t0, t1, t2, t3, t4


def _max_pool_ceil(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """torch's ``MaxPool2d(window, stride, ceil_mode=True)`` as the JAX
    package computes it (``perceptual.py:101-112``): where a side exceeds
    the window, −inf rows / columns on the bottom / right up to the next
    stride, then a VALID pool.  NCHW."""
    h, w = x.shape[2], x.shape[3]
    pad_h = (-(h - window)) % stride if h > window else 0
    pad_w = (-(w - window)) % stride if w > window else 0
    if pad_h or pad_w:
        x = F.pad(x, (0, pad_w, 0, pad_h), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


class VGG16Taps(nn.Module):
    """torchvision ``vgg16().features`` up to index 29, returning the five
    LPIPS taps (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3: indices
    3/8/15/22/29)."""

    LAYOUT: Tuple[Tuple[str, int], ...] = (
        ("conv", 64), ("relu", 0), ("conv", 64), ("relu", 0), ("pool", 0),
        ("conv", 128), ("relu", 0), ("conv", 128), ("relu", 0), ("pool", 0),
        ("conv", 256), ("relu", 0), ("conv", 256), ("relu", 0), ("conv", 256),
        ("relu", 0), ("pool", 0),
        ("conv", 512), ("relu", 0), ("conv", 512), ("relu", 0), ("conv", 512),
        ("relu", 0), ("pool", 0),
        ("conv", 512), ("relu", 0), ("conv", 512), ("relu", 0), ("conv", 512),
        ("relu", 0),
    )
    TAPS: Tuple[int, ...] = (3, 8, 15, 22, 29)

    def __init__(self):
        super().__init__()
        c_in = 3
        for i, (kind, ch) in enumerate(self.LAYOUT):
            if kind == "conv":
                setattr(self, f"conv_{i}", nn.Conv2d(c_in, ch, 3, padding=1))
                c_in = ch

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        taps = []
        for i, (kind, _) in enumerate(self.LAYOUT):
            if kind == "conv":
                x = getattr(self, f"conv_{i}")(x)
            elif kind == "relu":
                x = torch.relu(x)
            else:
                x = F.max_pool2d(x, 2, 2)
            if i in self.TAPS:
                taps.append(x)
        return tuple(taps)


class Fire(nn.Module):
    """SqueezeNet's Fire module: squeeze 1×1, then expand 1×1 ‖ expand 3×3
    (channels concatenated in that order), each with its ReLU."""

    def __init__(self, c_in: int, squeeze: int, expand: int):
        super().__init__()
        self.squeeze = nn.Conv2d(c_in, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.relu(self.squeeze(x))
        return torch.cat([torch.relu(self.expand1x1(s)), torch.relu(self.expand3x3(s))], dim=1)


class SqueezeTaps(nn.Module):
    """torchvision ``squeezenet1_1().features`` returning the seven LPIPS taps
    (after indices 1/4/7/9/10/11/12): a stride-2 VALID 3×3 ``conv_0``, Fire
    modules named by their feature index, and ceil-mode 3×3 stride-2 pools
    (:func:`_max_pool_ceil`)."""

    FIRES = ((3, 64, 16, 64), (4, 128, 16, 64), (6, 128, 32, 128), (7, 256, 32, 128),
             (9, 256, 48, 192), (10, 384, 48, 192), (11, 384, 64, 256), (12, 512, 64, 256))

    def __init__(self):
        super().__init__()
        self.conv_0 = nn.Conv2d(3, 64, 3, stride=2)
        for i, c_in, squeeze, expand in self.FIRES:
            setattr(self, f"fire_{i}", Fire(c_in, squeeze, expand))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = torch.relu(self.conv_0(x))
        taps = [x]
        for i, _, _, _ in self.FIRES:
            if i in (3, 6, 9):
                x = _max_pool_ceil(x, 3, 2)
            x = getattr(self, f"fire_{i}")(x)
            if i not in (3, 6):
                taps.append(x)
        return tuple(taps)


_BACKBONES = {"alex": AlexNetFeatures, "vgg": VGG16Taps, "squeeze": SqueezeTaps}


class LPIPS(nn.Module):
    """LPIPS distance, ``net_type`` alex / vgg / squeeze; ``forward(x, y)`` on
    NHWC images returns the per-sample distances ``[B]``."""

    def __init__(self, net_type: str = "alex"):
        super().__init__()
        if net_type not in LPIPS_CHANNELS:
            raise ValueError(f"Unknown LPIPS net_type: {net_type!r}")
        self.net_type = net_type
        self.net = _BACKBONES[net_type]()
        for k, c in enumerate(LPIPS_CHANNELS[net_type]):
            setattr(self, f"lin_{k}", nn.Parameter(torch.zeros(c, 1)))
        self.register_buffer("shift", torch.tensor(_LPIPS_SHIFT).reshape(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_LPIPS_SCALE).reshape(1, 3, 1, 1))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        def features(img):
            return self.net((img.permute(0, 3, 1, 2) - self.shift) / self.scale)

        total = 0.0
        for k, (ax, ay) in enumerate(zip(features(x), features(y))):
            nx = ax / torch.sqrt(torch.sum(ax * ax, dim=1, keepdim=True) + 1e-10)
            ny = ay / torch.sqrt(torch.sum(ay * ay, dim=1, keepdim=True) + 1e-10)
            d = torch.einsum("bchw,c->bhw", torch.square(nx - ny),
                             getattr(self, f"lin_{k}").abs()[:, 0])
            total = total + d.mean(dim=(1, 2))
        return total


# ---------------------------------------------------------------------------
# Weight loading
# ---------------------------------------------------------------------------


def weights_dir() -> Optional[str]:
    return os.environ.get("MDIE_WEIGHTS_DIR")


# npz name → "pretrained" | "random_frozen", filled by init_frozen_params and
# written into the engine's summary.json ("pretrained_weights").
_WEIGHT_STATUS: Dict[str, str] = {}


def weight_status() -> Dict[str, str]:
    """Which feature networks loaded converted pretrained weights in this process."""
    return dict(_WEIGHT_STATUS)


def _flax_to_torch(key: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    """A Flax path of the JAX module (``net/conv_0/kernel``) → the port's
    parameter name and layout (``net.conv_0.weight``, HWIO → OIHW)."""
    parts = key.split("/")
    if parts[-1] == "kernel":
        return ".".join(parts[:-1] + ["weight"]), arr.transpose(3, 2, 0, 1)
    return ".".join(parts), arr


@torch.no_grad()
def _random_init(module: nn.Module, seed: int) -> None:
    """Seeded draws with the JAX module's initialisers' statistics: conv
    kernels LeCun normal (std 1/√fan_in), biases 0, ``lin`` U[0, 0.1)."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in module.named_parameters():
        if name.endswith("weight"):
            p.normal_(0.0, 1.0 / math.sqrt(p[0].numel()), generator=gen)
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.uniform_(0.0, 0.1, generator=gen)


@lru_cache(maxsize=4)
def _warn_once(msg: str) -> None:
    warnings.warn(msg, stacklevel=3)


@torch.no_grad()
def init_frozen_params(module: nn.Module, npz_name: str, seed: int = 42) -> nn.Module:
    """Freeze ``module`` (eval, no grad) with its weights from
    ``$MDIE_WEIGHTS_DIR/<npz_name>`` when that file exists, else the seeded
    random draws with a one-time warning.  Returns the module."""
    _random_init(module, seed)
    wdir = weights_dir()
    path = os.path.join(wdir, npz_name) if wdir else None
    if path and os.path.isfile(path):
        params = dict(module.named_parameters())
        n = 0
        with np.load(path) as npz:
            for key in npz.files:
                name, arr = _flax_to_torch(key, np.asarray(npz[key]))
                if name not in params:
                    continue
                if tuple(arr.shape) != tuple(params[name].shape):
                    raise ValueError(f"Shape mismatch for {key}: {arr.shape} vs "
                                     f"{tuple(params[name].shape)}")
                params[name].copy_(torch.from_numpy(np.ascontiguousarray(arr)))
                n += 1
        if n == 0:
            raise ValueError(f"No matching weights found in {path}")
        _WEIGHT_STATUS[npz_name] = "pretrained"
    else:
        _WEIGHT_STATUS[npz_name] = "random_frozen"
        _warn_once(
            f"Pretrained weights '{npz_name}' not found (MDIE_WEIGHTS_DIR={wdir!r}); using "
            "seeded random frozen features. Run tools/convert_torch_weights.py where "
            "torchvision weights are available for exact perceptual parity."
        )
    return module.eval().requires_grad_(False)


def frozen_lpips(args: Dict, device) -> LPIPS:
    """The frozen LPIPS of a loss term's or metric's ``args`` (``net`` or
    ``net_type``, default ``"alex"``) on ``device``."""
    net = args.get("net", args.get("net_type", "alex"))
    if net not in ("alex", "vgg", "squeeze"):
        raise ValueError(f"lpips net_type '{net}' not supported (alex/vgg/squeeze).")
    return init_frozen_params(LPIPS(net_type=net), f"lpips_{net}.npz").to(device)
