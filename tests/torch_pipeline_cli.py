"""Tiny artifacts for the port's serving CLI (``run_pipeline``), shared by
tests/test_torch_pipeline.py and the JAX-blocked run of
tests/test_torch_port_hygiene.py: seeded full-width CDAN experts and a
full-width classifier, written in the port's formats, and a directory of
small PNGs.  Imports nothing of JAX."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from multi_degradation_image_enhancement_tpu_torch.classification.model import init_classifier
from multi_degradation_image_enhancement_tpu_torch.classification.train import save_checkpoint
from multi_degradation_image_enhancement_tpu_torch.engine.checkpoint import save_weights
from multi_degradation_image_enhancement_tpu_torch.models.cdan import init_cdan
from multi_degradation_image_enhancement_tpu_torch.ops.degradations import DEGRADATIONS

HW = (32, 48)  # multiples of 8 (CDAN's three pools)
EXPERTS = ("noise", "blur", "low_light")


def live_cdan(gen: torch.Generator) -> torch.nn.Module:
    """``init_cdan`` with BatchNorm statistics redrawn (means U(-0.05, 0.05),
    variances U(0.1, 0.3)): at ``init_cdan``'s U(0.5, 1.5) means the decoder's
    ReLUs close, and only the global residual and ``final_dense`` would decide
    the restored pixels."""
    model = init_cdan(gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.05, 0.05, generator=gen)
                m.running_var.uniform_(0.1, 0.3, generator=gen)
    return model


def write_tiny_pipeline(root: Path, n_images: int = 3, seed: int = 0) -> dict:
    """``root/{deg,weights}`` and ``root/clf.pt`` (+ ``.json`` with the nine
    classes); returns the paths and the models written."""
    gen = torch.Generator().manual_seed(seed)
    img_dir, wdir = root / "deg", root / "weights"
    img_dir.mkdir(parents=True)
    wdir.mkdir()
    rng = np.random.RandomState(seed)
    for i in range(n_images):
        # images far apart in content, so the classifier's features differ
        base = rng.randint(0, 256, (*HW, 3)) * (i + 1) / n_images
        Image.fromarray(base.astype(np.uint8)).save(img_dir / f"im{i}.png")
    experts = {}
    for name in EXPERTS:
        experts[name] = live_cdan(gen)
        save_weights(str(wdir / f"CDAN_{name}.pt"), experts[name])
    clf = init_classifier(gen, len(DEGRADATIONS), pretrained_backbone=False)
    with torch.no_grad():  # spread the heads so routes sit far from the thresholds
        clf.head_cls.weight.mul_(40.0)
        clf.head_sev.weight.mul_(40.0)
    save_checkpoint(str(root / "clf.pt"), clf, {"classes": list(DEGRADATIONS)})
    return {"images": img_dir, "weights": wdir, "classifier": root / "clf.pt",
            "experts": experts, "clf": clf}


def write_thresholds(root: Path, thresholds: dict) -> None:
    """``thresholds_val.json`` beside the classifier, as a classifier run writes it."""
    (root / "thresholds_val.json").write_text(json.dumps({"thresholds": thresholds}))


def cli_args(paths: dict, out: Path, *extra: str) -> list:
    return ["--images", str(paths["images"]), "--out", str(out), "--classifier",
            str(paths["classifier"]), "--weights-dir", str(paths["weights"]), "--batch", "3",
            "--input-hw", str(HW[0]), str(HW[1]), "--io-threads", "2", "--device", "cpu", *extra]
