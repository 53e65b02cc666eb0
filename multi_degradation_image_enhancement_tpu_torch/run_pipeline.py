"""Full-pipeline CLI: classify degradations → route → restore a directory of
images (counterpart of the root ``run_pipeline.py``).

    python -m multi_degradation_image_enhancement_tpu_torch.run_pipeline \\
        --images degraded/ --out restored/ --classifier clf.pt --weights-dir weights/ \\
        [--mode top1|sequential] [--ordering fixed|severity|severity_asc] [--batch 16] \\
        [--input-hw 256 384] [--save-probs] [--io-threads 4] [--device cuda|cpu]

``--classifier`` is a checkpoint of ``classification.train.save_checkpoint``
(a ``state_dict`` ``.pt``; its classes come from ``<classifier>.json``);
``--weights-dir`` holds ``CDAN_<task>.pt`` engine weight files.  A missing
expert is skipped with a warning: images routed to it pass through
unrestored.  Thresholds merge per class: the classifier run's
``thresholds_val.json`` beside the checkpoint, then the JAX package's
packaged ``config/classifier_thresholds.json`` (read as a data file), then
0.5.  The device is the card unless ``--device cpu``; the pipeline runs in
bf16 on the card and in f32 on the CPU.  Output PNGs are
``clip(x·255, 0, 255)`` truncated to uint8, as the JAX CLI writes them.
``--expert-mesh`` (expert-parallel serving) is not ported.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from multi_degradation_image_enhancement_tpu_torch.classification.model import (
    MultiHeadClassifier,
    serving_classifier,
)
from multi_degradation_image_enhancement_tpu_torch.classification.train import load_checkpoint
from multi_degradation_image_enhancement_tpu_torch.data.dataset import _list_images
from multi_degradation_image_enhancement_tpu_torch.data.streaming import stream_restore
from multi_degradation_image_enhancement_tpu_torch.engine.model import resolve_device
from multi_degradation_image_enhancement_tpu_torch.ops.degradations import DEGRADATIONS
from multi_degradation_image_enhancement_tpu_torch.ops.image import true_div
from multi_degradation_image_enhancement_tpu_torch.pipeline import (
    FullPipeline,
    RoutedRestorer,
    load_expert_bank,
)

PACKAGED_THRESHOLDS = (Path(__file__).resolve().parents[1] / "multi_degradation_image_enhancement_tpu"
                       / "config" / "classifier_thresholds.json")


def resolve_thresholds(classes, packaged_path, run_path):
    """Per-class routing thresholds, merged across the priority tiers
    (``run_pipeline.py:38-59``): the run's ``thresholds_val.json`` → the
    packaged defaults → flat 0.5, merged per class (a run file that lacks a
    class falls back to the packaged value for it, not to 0.5).

    Returns ``(thresholds_list_in_class_order, source_description)``."""
    thr_by_class = {c: 0.5 for c in classes}
    source = "flat 0.5"
    for path in (packaged_path, run_path):
        if path and os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                report = json.load(f)
            found = {c: report["thresholds"][c] for c in classes if c in report["thresholds"]}
            thr_by_class.update(found)
            if found:
                source = path
    return [thr_by_class[c] for c in classes], source


def to_01(imgs_u8: np.ndarray, device) -> torch.Tensor:
    """A decoded u8 batch as f32 in [0, 1] on ``device``: ``u8 / 255``,
    correctly rounded on every device, as the JAX CLI divides."""
    return true_div(torch.from_numpy(imgs_u8).to(device).float(), 255.0)


def to_u8(restored: torch.Tensor) -> np.ndarray:
    """``clip(x·255, 0, 255)`` in f32, truncated to uint8 (not rounded), on the host."""
    return np.clip(restored.float().cpu().numpy() * 255.0, 0, 255).astype(np.uint8)


def build_full_pipeline(classifier_path: str, weights_dir: str, mode: str = "top1",
                        ordering: str = "fixed", device="cuda") -> FullPipeline:
    """The CLI's pipeline from its files, in bf16 on the card and f32 on the CPU."""
    device = resolve_device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32

    classes = list(DEGRADATIONS)
    meta_path = classifier_path + ".json"
    if os.path.exists(meta_path):
        with open(meta_path, encoding="utf-8") as f:
            classes = json.load(f).get("classes", classes)
    clf = load_checkpoint(classifier_path, MultiHeadClassifier(len(classes)))
    thr_path = os.path.join(os.path.dirname(classifier_path), "thresholds_val.json")
    thresholds, thr_source = resolve_thresholds(classes, str(PACKAGED_THRESHOLDS), thr_path)
    print(f"[pipeline] thresholds: {thr_source}")

    weight_paths = {}
    for name in DEGRADATIONS:
        p = os.path.join(weights_dir, f"CDAN_{name}.pt")
        if os.path.isfile(p):
            weight_paths[name] = p
        else:
            print(f"[pipeline] WARNING: no weights for '{name}' ({p}); passthrough")
    if not weight_paths:
        raise FileNotFoundError(f"No CDAN_<task>.pt files in {weights_dir}")
    names, forwards = load_expert_bank(weight_paths, device, dtype)
    router = RoutedRestorer(forwards, names, mode=mode, ordering=ordering)
    return FullPipeline(serving_classifier(clf, dtype, device), router, thresholds, classes)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", required=True, help="directory of degraded images")
    ap.add_argument("--out", required=True, help="output directory for restored PNGs")
    ap.add_argument("--classifier", required=True, help="classifier checkpoint (.pt)")
    ap.add_argument("--weights-dir", required=True, help="dir with CDAN_<task>.pt files")
    ap.add_argument("--mode", choices=["top1", "sequential"], default="top1",
                    help="top1: each image visits its argmax expert; sequential: every expert "
                    "above its threshold applies, at up to E x the compute")
    ap.add_argument("--ordering", choices=["fixed", "severity", "severity_asc"], default="fixed",
                    help="sequential-mode expert order: bank order, or by the severity head "
                    "(highest first; severity_asc is the control direction)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--input-hw", type=int, nargs=2, default=[256, 384])
    ap.add_argument("--save-probs", action="store_true", help="write probs.jsonl")
    ap.add_argument("--io-threads", type=int, default=4, help="PNG writer pool size")
    ap.add_argument("--expert-mesh", type=int, default=0,
                    help="expert-parallel serving over this many devices (not ported)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.expert_mesh > 1:
        raise NotImplementedError("--expert-mesh (expert-parallel serving) is not ported to "
                                  "PyTorch yet: ROADMAP.md queue 1 item 5 (DDP and meshes)")

    pipeline = build_full_pipeline(args.classifier, args.weights_dir, args.mode, args.ordering,
                                   args.device)
    files = _list_images(args.images)
    if not files:
        raise RuntimeError(f"No images in {args.images}")
    device = pipeline.mean.device

    def run_batch(imgs_u8: np.ndarray):
        restored, probs = pipeline(to_01(imgs_u8, device))
        return to_u8(restored), probs.float().cpu().numpy()

    rows = stream_restore(
        files, args.images, args.out, hw=tuple(args.input_hw), batch=args.batch,
        run_batch=run_batch, io_threads=args.io_threads,
        progress=lambda done, total: print(f"[pipeline] {done}/{total}"),
    )
    if args.save_probs:
        names = pipeline.router.expert_names
        with open(os.path.join(args.out, "probs.jsonl"), "w", encoding="utf-8") as f:
            for fname, p in rows:
                f.write(json.dumps({"file": fname, "probs": {n: float(p[k]) for k, n in
                                                               enumerate(names)}}) + "\n")
    print(f"[OK] restored {len(files)} images -> {args.out}")


if __name__ == "__main__":
    main()
