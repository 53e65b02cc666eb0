"""Multi-head degradation classifier: ResNet-18 backbone + class and severity
heads (counterpart of
``multi_degradation_image_enhancement_tpu/classification/model.py``).

Both heads are f32 ``Linear`` layers on the f32 512-d pooled feature
(``model.py:37-38``), whatever dtype the backbone runs in: the serving CLI
runs the backbone in bf16 on the card (:func:`serving_classifier`), as the
JAX pipeline runs the module with ``dtype=bfloat16``.  Pretrained ImageNet
weights load from ``$MDIE_WEIGHTS_DIR/resnet18.npz`` when present
(:func:`init_classifier`); otherwise the backbone keeps its seeded random
init.  Nothing is downloaded.
"""

from __future__ import annotations

import copy
import os
from typing import Tuple

import numpy as np
import torch
from torch import nn

from multi_degradation_image_enhancement_tpu_torch.models.resnet import (
    ResNet18Features,
    load_torchvision_npz,
)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class MultiHeadClassifier(nn.Module):
    def __init__(self, num_classes: int):
        super().__init__()
        self.backbone = ResNet18Features()
        self.head_cls = nn.Linear(512, num_classes)
        self.head_sev = nn.Linear(512, num_classes)

    def forward(self, x_nhwc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC (normalised) images → ``(class logits, severity logits)``, f32."""
        feat = self.backbone(x_nhwc).float()
        return self.head_cls(feat), self.head_sev(feat)


@torch.no_grad()
def init_classifier(generator: torch.Generator, num_classes: int = 9,
                    pretrained_backbone: bool = True) -> MultiHeadClassifier:
    """A classifier in eval mode with seeded weights (PyTorch's default init
    under a seed drawn from ``generator``, the global RNG restored after);
    the backbone from ``$MDIE_WEIGHTS_DIR/resnet18.npz`` when
    ``pretrained_backbone`` and the file exists (``model.py:52-71``)."""
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = MultiHeadClassifier(num_classes)
    wdir = os.environ.get("MDIE_WEIGHTS_DIR")
    path = os.path.join(wdir, "resnet18.npz") if wdir else None
    if pretrained_backbone and path and os.path.isfile(path):
        with np.load(path) as npz:
            load_torchvision_npz(model.backbone, dict(npz))
        print(f"[classifier] loaded pretrained backbone from {path}")
    elif pretrained_backbone:
        print(f"[classifier] resnet18.npz not found (MDIE_WEIGHTS_DIR={wdir!r}); "
              "backbone keeps its random init.")
    return model.eval()


def serving_classifier(model: MultiHeadClassifier, dtype: torch.dtype,
                       device) -> MultiHeadClassifier:
    """A frozen eval copy on ``device`` with the backbone in ``dtype`` and the
    heads in f32."""
    clf = copy.deepcopy(model).eval().requires_grad_(False).to(device)
    clf.backbone.to(dtype)
    return clf
