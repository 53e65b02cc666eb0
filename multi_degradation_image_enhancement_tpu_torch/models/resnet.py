"""ResNet-18 backbone (counterpart of
``multi_degradation_image_enhancement_tpu/models/resnet.py``).

torchvision's ``resnet18`` minus its fc head, with torchvision's module names
(``conv1``, ``bn1``, ``layer1`` … ``layer4`` of :class:`BasicBlock`, each with
``conv1``, ``bn1``, ``conv2``, ``bn2`` and ``downsample``), so a converted
``resnet18.npz`` loads with :func:`load_torchvision_npz`.  The public forward
takes NHWC images, as the JAX module does, and returns the ``[B, 512]``
global-mean feature.  Semantics kept from the JAX module: conv1 7×7/2 pad 3
(:54-55), max-pool 3/2 pad 1 with −inf padding (:59), the 1×1/2 downsample
when the stride is not 1 or the width changes (:39-43), the global mean
(:68).  BatchNorm is the port's ``models.norm.BatchNorm2d`` (torch's names,
eps 1e-5 and momentum 0.1 = Flax's 0.9): Flax's training semantics (biased
running variance) in train mode and in ``stats_refresh`` mode, torch's in
eval mode.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from multi_degradation_image_enhancement_tpu_torch.models.norm import BatchNorm2d


class BasicBlock(nn.Module):
    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_features, features, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(features)
        self.downsample: Optional[nn.Sequential] = None
        if stride != 1 or in_features != features:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_features, features, 1, stride, bias=False), BatchNorm2d(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(out)) + identity)


class ResNet18Features(nn.Module):
    """NHWC image → ``[B, 512]`` features, computed in the module's dtype."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        widths = [(64, 1), (128, 2), (256, 2), (512, 2)]
        c_in = 64
        for li, (features, stride) in enumerate(widths, start=1):
            setattr(self, f"layer{li}", nn.Sequential(
                BasicBlock(c_in, features, stride), BasicBlock(features, features, 1)))
            c_in = features

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = x_nhwc.permute(0, 3, 1, 2).to(self.conv1.weight.dtype)
        x = torch.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)  # pads with -inf, as nn.max_pool does
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
        return x.mean(dim=(2, 3))


# Converter npz leaf → (torch attribute, layout change) (the npz holds HWIO
# kernels and Flax BatchNorm names).
_NPZ_LEAVES = {
    "kernel": ("weight", lambda a: a.transpose(3, 2, 0, 1)),  # HWIO → OIHW
    "scale": ("weight", None),
    "bias": ("bias", None),
    "mean": ("running_mean", None),
    "var": ("running_var", None),
}


def _torchvision_key_to_name(key: str) -> str:
    """Converter npz key → the port's parameter or buffer name:
    ``layer1/0/conv1/kernel`` → ``layer1.0.conv1.weight``,
    ``layer2/0/downsample/1/var`` → ``layer2.0.downsample.1.running_var``
    (the rules of ``resnet.py:71-80``, on torchvision's own names)."""
    *path, leaf = key.split("/")
    if leaf not in _NPZ_LEAVES:
        raise KeyError(leaf)
    return ".".join(path + [_NPZ_LEAVES[leaf][0]])


@torch.no_grad()
def load_torchvision_npz(model: ResNet18Features, npz: Dict[str, np.ndarray]) -> ResNet18Features:
    """Load a converted torchvision resnet18 state (``tools/convert_torch_weights.py``
    output) into ``model`` in place (counterpart of ``load_torchvision_npz``,
    ``resnet.py:83``): the fc head is ignored, keys the model lacks are
    skipped, a shape mismatch raises, and so does a file that matches nothing."""
    own = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    loaded = 0
    for key, arr in npz.items():
        if key.startswith("fc/"):
            continue
        try:
            name = _torchvision_key_to_name(key)
        except KeyError:
            continue
        if name not in own:
            continue
        convert = _NPZ_LEAVES[key.rsplit("/", 1)[1]][1]
        value = torch.from_numpy(np.ascontiguousarray(convert(arr) if convert else arr))
        if tuple(value.shape) != tuple(own[name].shape):
            raise ValueError(f"{key}: shape {tuple(value.shape)} vs {tuple(own[name].shape)}")
        own[name].copy_(value)
        loaded += 1
    if loaded == 0:
        raise ValueError("No resnet18 weights matched the parameter tree")
    return model
