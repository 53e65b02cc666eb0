#!/usr/bin/env python
"""Sample clean source images from a class-per-directory corpus, e.g. ImageNet
(counterpart of
``multi_degradation_image_enhancement_tpu/datasets_generation/select_clean_images.py``).

    python -m multi_degradation_image_enhancement_tpu_torch.datasets_generation.select_clean_images \\
        --imagenet-dir /data/imagenet/train --out clean_images [--num-classes 100]

A seeded shuffle of the class directories, then N classes × M images copied
flat as ``<class>__<name>`` (or into per-class directories with
``--nested``): the JAX package's selection for the same seed.  Host only.
"""

from __future__ import annotations

import argparse
import os
import random
import shutil

from multi_degradation_image_enhancement_tpu_torch.datasets_generation.common import IMG_EXTS


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--imagenet-dir", required=True, help="root with one subdir per class")
    ap.add_argument("--out", default="clean_images")
    ap.add_argument("--num-classes", type=int, default=100)
    ap.add_argument("--images-per-class", type=int, default=20)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--nested", action="store_true", help="keep per-class subdirs")
    args = ap.parse_args(argv)

    rng = random.Random(args.seed)
    os.makedirs(args.out, exist_ok=True)

    classes = sorted(
        d for d in os.listdir(args.imagenet_dir)
        if os.path.isdir(os.path.join(args.imagenet_dir, d))
    )
    if not classes:
        raise RuntimeError(f"No class directories found in {args.imagenet_dir}")
    rng.shuffle(classes)

    copied = 0
    for cls in classes[: args.num_classes]:
        cls_dir = os.path.join(args.imagenet_dir, cls)
        images = sorted(
            f for f in os.listdir(cls_dir)
            if os.path.isfile(os.path.join(cls_dir, f)) and f.lower().endswith(IMG_EXTS)
        )
        if not images:
            continue
        rng.shuffle(images)
        for img in images[: args.images_per_class]:
            if args.nested:
                dst_dir = os.path.join(args.out, cls)
                os.makedirs(dst_dir, exist_ok=True)
                dst = os.path.join(dst_dir, img)
            else:
                dst = os.path.join(args.out, f"{cls}__{img}")
            shutil.copy2(os.path.join(cls_dir, img), dst)
            copied += 1

    print(f"[OK] Copied {copied} images into {os.path.abspath(args.out)}")


if __name__ == "__main__":
    main()
