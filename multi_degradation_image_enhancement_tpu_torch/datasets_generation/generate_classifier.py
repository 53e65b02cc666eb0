#!/usr/bin/env python
"""Materialize the multi-label classifier dataset on disk (counterpart of
``multi_degradation_image_enhancement_tpu/datasets_generation/generate_classifier.py``).

    python -m multi_degradation_image_enhancement_tpu_torch.datasets_generation.generate_classifier \\
        --clean-dir clean/ --out classifier_dataset/ [--device cpu]

The sampling is the JAX package's, on the host in Python's ``random``
(bit-identical plans): degradation count 1/2/3 w.p. 0.6/0.3/0.1,
co-occurrence bias rules, three pipeline-order templates, severity ~
Beta(2,5) mild (85%) / Beta(5,2) hard (15%), 10% clean samples, 5 variants
per clean image, a 0.70/0.15/0.15 split, md5-keyed per-(file, variant)
streams.  The degradations run on the device through ``ops.severity``, one
``torch.Generator`` per (file, variant, degradation) seeded with
``md5_int(f"{seed}::{name}::v{variant}::{d}") & 0x7FFFFFFF`` (the JAX
package's key seed; the draws themselves differ).  Layout:
``<out>/{train,val,test}/images/*.png`` + ``labels.jsonl`` rows ``{file,
source_clean, variant_id, chosen_degradations, labels, severity, params}``
+ ``meta/classes.json`` + ``meta/config.json``.  The device is the card
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from typing import Dict, List

import numpy as np
import torch

from multi_degradation_image_enhancement_tpu_torch.datasets_generation.common import (
    TARGET_SIZE,
    list_images,
    load_letterboxed_rgb,
    load_or_create_split,
    md5_int,
    save_rgb,
    stable_rng,
)
from multi_degradation_image_enhancement_tpu_torch.engine.model import resolve_device
from multi_degradation_image_enhancement_tpu_torch.ops.degradations import DEGRADATIONS
from multi_degradation_image_enhancement_tpu_torch.ops.severity import apply_severity

NUM_DEGRADS_CHOICES = [1, 2, 3]
NUM_DEGRADS_PROBS = [0.60, 0.30, 0.10]

CLEAN_SAMPLE_PROB = 0.10
HARD_SEV_PROB = 0.15
SEV_BETA_MILD = (2.0, 5.0)
SEV_BETA_HARD = (5.0, 2.0)

COOCCUR_RULES = {
    "jpeg": [("noise", 0.25), ("low_contrast", 0.25)],
    "high_light": [("low_contrast", 0.20)],
    "low_light": [("noise", 0.15), ("low_contrast", 0.20)],
}

PIPELINES = [
    ["low_light", "high_light", "blur", "motion_blur", "jpeg", "low_contrast",
     "color_distortion", "noise", "pixelation"],
    ["jpeg", "pixelation", "noise", "blur", "motion_blur", "low_contrast",
     "color_distortion", "low_light", "high_light"],
    ["color_distortion", "low_contrast", "low_light", "high_light", "jpeg",
     "noise", "blur", "motion_blur", "pixelation"],
]


def sample_severity(rng) -> float:
    a, b = SEV_BETA_HARD if rng.random() < HARD_SEV_PROB else SEV_BETA_MILD
    return float(max(0.0, min(1.0, rng.betavariate(a, b))))


def choose_num_degradations(rng) -> int:
    r = rng.random()
    cum = 0.0
    for n, p in zip(NUM_DEGRADS_CHOICES, NUM_DEGRADS_PROBS):
        cum += p
        if r <= cum:
            return n
    return NUM_DEGRADS_CHOICES[-1]


def apply_cooccurrence_bias(chosen: List[str], rng) -> List[str]:
    chosen_set = set(chosen)
    for d in list(chosen):
        for other, prob in COOCCUR_RULES.get(d, []):
            if other not in chosen_set and rng.random() < prob:
                chosen_set.add(other)
    return list(chosen_set)


def order_by_pipeline(chosen: List[str], rng) -> List[str]:
    pipeline = rng.choice(PIPELINES)
    rank = {d: i for i, d in enumerate(pipeline)}
    return sorted(chosen, key=lambda d: rank.get(d, 10_000))


def plan_variant(name: str, variant_id: int, seed: int) -> Dict:
    """Deterministically plan one sample: which degradations, what severities."""
    rng = stable_rng(name, variant_id, seed)
    if rng.random() < CLEAN_SAMPLE_PROB:
        return {"chosen": [], "severities": {}}
    chosen = rng.sample(list(DEGRADATIONS), k=choose_num_degradations(rng))
    chosen = apply_cooccurrence_bias(chosen, rng)
    chosen = order_by_pipeline(chosen, rng)
    return {"chosen": chosen, "severities": {d: sample_severity(rng) for d in chosen}}


def _apply_plan_on_device(img_u8: np.ndarray, plan: Dict, name: str, variant_id: int, seed: int,
                          device: torch.device):
    """Run the planned degradation chain on ``device``; returns (img_u8, params).
    Each degradation draws from its own generator, seeded as the JAX package
    seeds its key."""
    out = torch.from_numpy(img_u8[None]).to(device).float()
    params: Dict[str, Dict] = {}
    for d in plan["chosen"]:
        sev = torch.tensor([plan["severities"][d]], dtype=torch.float32)
        gen = torch.Generator(device=device).manual_seed(
            md5_int(f"{seed}::{name}::v{variant_id}::{d}") & 0x7FFFFFFF)
        out, p = apply_severity(d, out, sev, gen)
        params[d] = {k: v.tolist()[0] for k, v in p.items()}
    return out[0].to(torch.uint8).cpu().numpy(), params


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clean-dir", default="clean_images")
    ap.add_argument("--out", default="classifier_dataset")
    ap.add_argument("--variants-per-image", type=int, default=5)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--ratios", nargs=3, type=float, default=[0.70, 0.15, 0.15],
                    metavar=("TRAIN", "VAL", "TEST"))
    ap.add_argument("--target-hw", nargs=2, type=int, default=list(TARGET_SIZE),
                    metavar=("H", "W"))
    ap.add_argument("--no-overwrite", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    target_hw = tuple(args.target_hw)
    device = resolve_device(args.device)

    if os.path.exists(args.out) and not args.no_overwrite:
        shutil.rmtree(args.out)
    os.makedirs(args.out, exist_ok=True)

    names = list_images(args.clean_dir)
    if not names:
        raise RuntimeError(f"No images found in {os.path.abspath(args.clean_dir)}")

    tr, va, te = args.ratios
    split_path = os.path.join(
        args.out, "meta", f"split_seed{args.seed}_tr{tr}_va{va}_te{te}.json"
    )
    split = load_or_create_split(
        names, split_path, {"train": tr, "val": va, "test": te}, args.seed
    )

    meta_dir = os.path.join(args.out, "meta")
    os.makedirs(meta_dir, exist_ok=True)
    with open(os.path.join(meta_dir, "classes.json"), "w", encoding="utf-8") as f:
        json.dump(list(DEGRADATIONS), f, indent=2)
    with open(os.path.join(meta_dir, "config.json"), "w", encoding="utf-8") as f:
        json.dump(
            {
                "seed": args.seed,
                "target_size_hw": list(target_hw),
                "variants_per_image": args.variants_per_image,
                "include_clean_samples": True,
                "clean_sample_prob": CLEAN_SAMPLE_PROB,
                "num_degrads_choices": NUM_DEGRADS_CHOICES,
                "num_degrads_probs": NUM_DEGRADS_PROBS,
                "hard_sev_prob": HARD_SEV_PROB,
                "sev_beta_mild": list(SEV_BETA_MILD),
                "sev_beta_hard": list(SEV_BETA_HARD),
                "cooccur_rules": COOCCUR_RULES,
                "pipelines": PIPELINES,
                "split_ratios": {"train": tr, "val": va, "test": te},
            },
            f, indent=2,
        )

    for split_name, file_list in split.items():
        img_dir = os.path.join(args.out, split_name, "images")
        os.makedirs(img_dir, exist_ok=True)
        lbl_path = os.path.join(args.out, split_name, "labels.jsonl")
        written = 0
        with open(lbl_path, "w", encoding="utf-8") as f:
            for name in file_list:
                src = os.path.join(args.clean_dir, name)
                if not os.path.exists(src):
                    continue
                try:
                    base_img = load_letterboxed_rgb(src, target_hw)
                except (OSError, RuntimeError, ValueError):
                    continue  # unreadable images are skipped, as in the JAX package
                for variant_id in range(args.variants_per_image):
                    plan = plan_variant(name, variant_id, args.seed)
                    out, params = _apply_plan_on_device(
                        base_img, plan, name, variant_id, args.seed, device
                    )
                    stem = os.path.splitext(name)[0]
                    out_name = f"{stem}__v{variant_id}.png"
                    save_rgb(out, os.path.join(img_dir, out_name))
                    labels = {c: int(c in plan["chosen"]) for c in DEGRADATIONS}
                    severity = {c: float(plan["severities"].get(c, 0.0)) for c in DEGRADATIONS}
                    rec = {
                        "file": os.path.join(split_name, "images", out_name),
                        "source_clean": name,
                        "variant_id": int(variant_id),
                        "chosen_degradations": plan["chosen"],
                        "labels": labels,
                        "severity": severity,
                        "params": params,
                    }
                    f.write(json.dumps(rec) + "\n")
                    written += 1
        print(f"[OK] split={split_name}: {written} samples")

    print(f"[OK] Classifier dataset at {os.path.abspath(args.out)}")
    print(f"Classes: {list(DEGRADATIONS)}")


if __name__ == "__main__":
    main()
