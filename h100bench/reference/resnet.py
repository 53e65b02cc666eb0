"""The degradation classifier: ResNet-18 features and two linear heads, as
plain functions of a weight dict keyed by the classifier's published module
names (``backbone.conv1.weight``, ``backbone.layer2.0.downsample.1.running_var``,
``head_cls.weight``, ...).  NHWC images in [0, 1] in, NCHW inside.

The equations are those of the published classifier
(``classification/train_multilabel_classifier.py:117-131`` of
danielluca00/Multi-Degradation-Image-Enhancement: torchvision's
``resnet18`` with its ``fc`` replaced by an identity and two
``Linear(512, 9)`` heads on the pooled feature):
ImageNet normalisation; conv1 7×7 stride 2 pad 3, BN, ReLU; a 3×3 stride 2
max-pool with pad 1 whose padding is −inf; four stages of two
``BasicBlock``s (64, 128, 256, 512 wide; the first block of stages 2–4
strides by 2 and takes a 1×1 stride-2 conv + BN as its shortcut); the
global mean; a class head and a severity head.  BatchNorm in eval mode
with eps 1e-5.

Departures: the heads take the pooled feature in float32 whatever
precision computes the backbone (the published model runs in one
precision; the port's serving classifier does this); calibration
(:meth:`RefResNet18.calibrate`) sets the running statistics to the batch
statistics of the images given, with the biased variance, where a trained
classifier's would be averages over its training set; the weights are the
harness's (seeded and fitted), not ImageNet's and a training run's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from h100bench.reference.cdan import ROUNDINGS

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))  # (width, first block's stride)


def resnet_shapes(num_classes: int = 9) -> Dict[str, tuple]:
    """Every tensor of the classifier by name, with its shape, in module
    order (``num_batches_tracked`` left out)."""
    shapes: Dict[str, tuple] = {}

    def bn(name, c):
        for key in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{name}.{key}"] = (c,)

    shapes["backbone.conv1.weight"] = (64, 3, 7, 7)
    bn("backbone.bn1", 64)
    c_in = 64
    for li, (c, stride) in enumerate(STAGES, 1):
        for bi in range(2):
            pre = f"backbone.layer{li}.{bi}"
            first_in = c_in if bi == 0 else c
            shapes[pre + ".conv1.weight"] = (c, first_in, 3, 3)
            bn(pre + ".bn1", c)
            shapes[pre + ".conv2.weight"] = (c, c, 3, 3)
            bn(pre + ".bn2", c)
            if bi == 0 and (stride != 1 or first_in != c):
                shapes[pre + ".downsample.0.weight"] = (c, first_in, 1, 1)
                bn(pre + ".downsample.1", c)
        c_in = c
    for head in ("head_cls", "head_sev"):
        shapes[head + ".weight"] = (num_classes, 512)
        shapes[head + ".bias"] = (num_classes,)
    return shapes


class RefResNet18:
    """``params`` and ``buffers`` by name (see :func:`resnet_shapes`);
    ``quant``: None (float32), ``"fp8"`` (the control: every conv's and
    head's operands in e4m3 with a per-tensor scale) or ``"bf16"``."""

    def __init__(self, params: Dict[str, torch.Tensor], buffers: Dict[str, torch.Tensor],
                 quant: Optional[str] = None):
        if quant is not None and quant not in ROUNDINGS:
            raise ValueError(f"quant must be None or one of {sorted(ROUNDINGS)}, got {quant!r}")
        self.p, self.b, self.quant = params, buffers, quant
        self.calibrating = False

    def _q(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.quant is None else ROUNDINGS[self.quant][0](t)

    def conv(self, x, name: str, stride: int, padding: int):
        return F.conv2d(self._q(x), self._q(self.p[name + ".weight"]), None, stride, padding)

    def bn(self, x, name: str, eps: float = 1e-5):
        if self.calibrating:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.b[name + ".running_mean"].copy_(mean)
            self.b[name + ".running_var"].copy_(var)
        mean, var = self.b[name + ".running_mean"], self.b[name + ".running_var"]
        scale = self.p[name + ".weight"] * torch.rsqrt(var + eps)
        return (x - mean[None, :, None, None]) * scale[None, :, None, None] + \
            self.p[name + ".bias"][None, :, None, None]

    def block(self, x, pre: str, stride: int):
        out = torch.relu(self.bn(self.conv(x, pre + ".conv1", stride, 1), pre + ".bn1"))
        out = self.bn(self.conv(out, pre + ".conv2", 1, 1), pre + ".bn2")
        if pre + ".downsample.0.weight" in self.p:
            x = self.bn(self.conv(x, pre + ".downsample.0", stride, 0), pre + ".downsample.1")
        return torch.relu(out + x)

    @torch.no_grad()
    def features(self, x01_nhwc: torch.Tensor) -> torch.Tensor:
        """ImageNet-normalised NHWC images in [0, 1] → the [B, 512] pooled feature."""
        mean = torch.tensor(IMAGENET_MEAN, dtype=x01_nhwc.dtype, device=x01_nhwc.device)
        std = torch.tensor(IMAGENET_STD, dtype=x01_nhwc.dtype, device=x01_nhwc.device)
        x = ((x01_nhwc - mean) / std).permute(0, 3, 1, 2)
        x = torch.relu(self.bn(self.conv(x, "backbone.conv1", 2, 3), "backbone.bn1"))
        x = F.max_pool2d(x, 3, 2, 1)  # pads with −inf
        for li, (_, stride) in enumerate(STAGES, 1):
            x = self.block(x, f"backbone.layer{li}.0", stride)
            x = self.block(x, f"backbone.layer{li}.1", 1)
        return x.mean(dim=(2, 3))

    def head(self, feat: torch.Tensor, name: str) -> torch.Tensor:
        return F.linear(self._q(feat), self._q(self.p[name + ".weight"]), self.p[name + ".bias"])

    @torch.no_grad()
    def __call__(self, x01_nhwc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(class logits, severity logits), [B, classes] each."""
        feat = self.features(x01_nhwc)
        return self.head(feat, "head_cls"), self.head(feat, "head_sev")

    @torch.no_grad()
    def calibrate(self, x01_nhwc: torch.Tensor) -> None:
        """Every running statistic set to its batch statistic on
        ``x01_nhwc`` (one pass over the whole batch), as a trained network's
        statistics match its activations."""
        self.calibrating = True
        try:
            self.features(x01_nhwc)
        finally:
            self.calibrating = False
