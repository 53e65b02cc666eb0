#!/usr/bin/env python
"""Materialize paired degradation datasets on disk (counterpart of
``multi_degradation_image_enhancement_tpu/datasets_generation/generate_paired.py``).

    python -m multi_degradation_image_enhancement_tpu_torch.datasets_generation.generate_paired \\
        --clean-dir clean_images --out paired_datasets --generate noise blur [--device cpu]

Letterboxed 256×384 clean images, the nine standard degradations at the
reference severity ranges (``ops.degradations``, batched on the device), the
pixelation curriculum presets (easy = [4, 6, 8], hard = [10, 12, 16]) with
md5-stable per-file factors (deterministic: the same files as the JAX
package's, bit for bit), a persisted seed-42 / test-0.15 split, and the
``<out>/<degradation>/{train,test}/{clean,degraded}/<stem>.png`` layout that
``data.dataset.PairedDataset`` reads.  Each file's severity (and noise's
normals) come from its own ``torch.Generator`` seeded with
``md5_int(f"{seed}::{name}::{file}") & 0x7FFFFFFF``, the JAX package's key
seed, so any subset regenerates identically; the draws differ from JAX's.
The device is the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
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
    save_rgb,
    stable_index,
    md5_int,
)
from multi_degradation_image_enhancement_tpu_torch.engine.model import resolve_device
from multi_degradation_image_enhancement_tpu_torch.ops.degradations import (
    DEGRADATIONS,
    apply_with_params,
    pixelate,
    sample_params,
)

PIXELATION_PRESETS = {
    "pixelation_easy": [4, 6, 8],
    "pixelation_hard": [10, 12, 16],
}


def _degrade_batch_on_device(name: str, images_u8: np.ndarray, file_names: List[str], seed: int,
                             device: torch.device) -> np.ndarray:
    """Degrade a uint8 batch on ``device`` with per-file md5-stable
    parameters: each file's own generator (regeneration-stable for any
    subset) draws its severity and, for noise, its normals."""
    imgs = torch.from_numpy(images_u8).to(device).float()
    per_file = []
    for n in file_names:
        gen = torch.Generator(device=device).manual_seed(md5_int(f"{seed}::{name}::{n}") & 0x7FFFFFFF)
        p = sample_params(name, gen, 1)
        if name == "noise":
            p["normal"] = torch.randn((1, *imgs.shape[1:]), generator=gen, device=device)
        per_file.append(p)
    params = {k: torch.cat([p[k] for p in per_file]) for k in per_file[0]}
    return apply_with_params(name, imgs, params).to(torch.uint8).cpu().numpy()


def _pixelate_preset(images_u8: np.ndarray, file_names: List[str], factors: List[int],
                     device: torch.device) -> np.ndarray:
    f = torch.tensor([factors[stable_index(n, len(factors))] for n in file_names], dtype=torch.int32)
    out = pixelate(torch.from_numpy(images_u8).to(device).float(), f.to(device))
    return out.to(torch.uint8).cpu().numpy()


def generate_dataset(
    item: str,
    split: Dict[str, List[str]],
    clean_dir: str,
    out_root: str,
    seed: int,
    batch_size: int = 32,
    overwrite: bool = True,
    target_hw=TARGET_SIZE,
    device: torch.device = torch.device("cuda"),
) -> None:
    base = os.path.join(out_root, item)
    if os.path.exists(base):
        if not overwrite:
            print(f"[SKIP] '{base}' already exists")
            return
        shutil.rmtree(base)

    for split_name, file_list in split.items():
        for i in range(0, len(file_list), batch_size):
            chunk = file_list[i : i + batch_size]
            imgs, names = [], []
            for name in chunk:
                src = os.path.join(clean_dir, name)
                if not os.path.exists(src):
                    continue
                try:
                    imgs.append(load_letterboxed_rgb(src, target_hw))
                    names.append(name)
                except (OSError, RuntimeError, ValueError):
                    continue  # unreadable images are skipped, as in the JAX package
            if not imgs:
                continue
            batch = np.stack(imgs)

            if item in PIXELATION_PRESETS:
                degraded = _pixelate_preset(batch, names, PIXELATION_PRESETS[item], device)
            else:
                degraded = _degrade_batch_on_device(item, batch, names, seed, device)

            for img, deg, name in zip(batch, degraded, names):
                stem = os.path.splitext(name)[0] + ".png"
                save_rgb(img, os.path.join(base, split_name, "clean", stem))
                save_rgb(deg, os.path.join(base, split_name, "degraded", stem))

    print(f"[OK] Dataset '{item}' written to {os.path.abspath(base)}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clean-dir", default="clean_images")
    ap.add_argument("--out", default="paired_datasets")
    ap.add_argument(
        "--generate", nargs="+", default=["all"],
        help=f"degradations to generate; 'all' or any of {list(DEGRADATIONS) + list(PIXELATION_PRESETS)}",
    )
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--test-ratio", type=float, default=0.15)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--target-hw", nargs=2, type=int, default=list(TARGET_SIZE),
                    metavar=("H", "W"))
    ap.add_argument("--no-overwrite", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    names = list_images(args.clean_dir)
    if not names:
        raise RuntimeError(f"No images found in {os.path.abspath(args.clean_dir)}")

    split_path = os.path.join(
        args.out, "_splits", f"split_seed{args.seed}_test{args.test_ratio}.json"
    )
    # test listed first → identical split membership to the reference's
    # files[:n_test]=test convention (generate_paired...py:215-231)
    split = load_or_create_split(
        names, split_path, {"test": args.test_ratio, "train": 1.0 - args.test_ratio}, args.seed
    )

    to_generate = (
        list(DEGRADATIONS) + list(PIXELATION_PRESETS)
        if args.generate == ["all"]
        else args.generate
    )
    valid = set(DEGRADATIONS) | set(PIXELATION_PRESETS)
    for item in to_generate:
        if item not in valid:
            raise ValueError(f"Unknown dataset '{item}'. Available: {sorted(valid)}")
        generate_dataset(
            item, split, args.clean_dir, args.out, args.seed,
            batch_size=args.batch_size, overwrite=not args.no_overwrite,
            target_hw=tuple(args.target_hw), device=device,
        )

    print(f"Split: seed={args.seed}, test_ratio={args.test_ratio}")
    print(f"Resize target: {args.target_hw[0]}x{args.target_hw[1]} (HxW), padding RGB(128,128,128)")


if __name__ == "__main__":
    main()
