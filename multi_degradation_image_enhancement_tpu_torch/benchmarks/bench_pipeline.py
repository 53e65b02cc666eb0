"""Full-pipeline throughput on the card: classify → route → restore
(counterpart of ``benchmarks/bench_pipeline.py``).

    python -m multi_degradation_image_enhancement_tpu_torch.benchmarks.bench_pipeline \\
        [--batch 32] [--iters 20] [--hw 256 384] [--mode top1|sequential] [--capacity-factor 2.0]

The ResNet-18 two-head classifier and a nine-expert CDAN bank (one seeded
random CDAN served nine times, as the JAX bench stacks one tree; the values
do not set the compute; each expert the hand-kernel serving forward replayed
from a CUDA graph per row count, as ``pipeline.load_expert_bank`` builds it
on the card) at the reference serving resolution, in bf16, timed
by CUDA events: the classifier alone, the expert bank alone on the
classifier's probabilities, and the whole step, with the expert forwards a
step runs (the routing mix is that of the untrained classifier at
thresholds 0.5, as in the JAX bench); then top1's capacity-drop rate on
skewed traffic, computed with the router's own rank-in-bucket rule.  Prints
one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from multi_degradation_image_enhancement_tpu_torch.benchmarks import cuda_ms, require_cuda


def capacity_drop_rate(expert_ids: np.ndarray, n_experts: int, batch: int,
                       capacity_factor: float) -> float:
    """Fraction of images top1 passes through unrestored because their
    expert's bucket overflowed (rank in bucket by batch order < capacity, the
    rule of ``pipeline.RoutedRestorer.route``)."""
    capacity = max(1, int(math.ceil(batch / n_experts * capacity_factor)))
    dropped = 0
    counts = np.zeros(n_experts, np.int64)
    for e in expert_ids:
        if counts[e] >= capacity:
            dropped += 1
        counts[e] += 1
    return dropped / len(expert_ids)


def skewed_drop_rates(n_experts: int, batch: int, capacity_factor: float, seed: int = 0) -> dict:
    """Drop rate when a share ``skew`` of the batch argmaxes to one expert and
    the rest spreads uniformly over the others (the JAX bench's traffic)."""
    rng = np.random.RandomState(seed)
    drops = {}
    for skew in (0.0, 0.3, 0.6, 0.9):
        n_hot = int(round(batch * skew))
        ids = np.concatenate([np.zeros(n_hot, np.int64), rng.randint(1, n_experts, batch - n_hot)])
        rng.shuffle(ids)
        drops[f"skew_{skew:.1f}"] = capacity_drop_rate(ids, n_experts, batch, capacity_factor)
    return drops


def expert_forwards(router, probs: torch.Tensor, thresholds) -> int:
    """Expert forwards one step of ``router`` runs on ``probs`` [B,E]: one
    for each expert with a row to restore (top1: its bucket after capacity;
    sequential: any row at its threshold)."""
    thr = torch.as_tensor(thresholds, dtype=torch.float32, device=probs.device)
    if router.mode == "top1":
        return int((router.route(probs, thr).unique() >= 0).sum())
    return int((probs >= thr).any(dim=0).sum())


def time_step(pipe, images: torch.Tensor, iters: int, probs=None) -> dict:
    """CUDA-event means (ms) of the classifier, the bank, and the whole step
    of ``pipe`` (a ``FullPipeline``) on ``images``, with img/s of the whole
    step and the expert forwards a step runs.  The bank routes by the
    classifier's probabilities, or by ``probs`` ([B,E] in expert order) when
    given: traffic whose degradations are known, and the whole step is then
    the classifier followed by the bank on ``probs``."""
    severity = pipe.router.mode == "sequential" and pipe.router.ordering != "fixed"
    thr = pipe.thresholds
    own, sevs = pipe.classify_full(images)
    route = own if probs is None else probs
    sevs = sevs if severity else None

    def step():
        if probs is None:
            return pipe(images)
        _, s = pipe.classify_full(images)
        return pipe.router(images, probs, thr, s if severity else None)

    with torch.inference_mode():
        classify_ms = cuda_ms(lambda: pipe.classify_full(images), iters)
        bank_ms = cuda_ms(lambda: pipe.router(images, route, thr, sevs), iters)
        step_ms = cuda_ms(step, iters)
    return {"classify_ms": classify_ms, "bank_ms": bank_ms, "pipeline_ms": step_ms,
            "pipeline_img_s": images.shape[0] / step_ms * 1e3,
            "expert_forwards": expert_forwards(pipe.router, route, thr)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--hw", type=int, nargs=2, default=[256, 384])
    ap.add_argument("--mode", choices=["top1", "sequential"], default="top1")
    ap.add_argument("--capacity-factor", type=float, default=2.0)
    args = ap.parse_args()
    require_cuda()

    from multi_degradation_image_enhancement_tpu_torch.classification.model import (
        init_classifier,
        serving_classifier,
    )
    from multi_degradation_image_enhancement_tpu_torch.models.cdan import init_cdan
    from multi_degradation_image_enhancement_tpu_torch.ops.degradations import DEGRADATIONS
    from multi_degradation_image_enhancement_tpu_torch.pipeline import (
        FullPipeline,
        RoutedRestorer,
        _serving_expert,
        cuda_graphed,
    )

    b, (h, w) = args.batch, args.hw
    names = list(DEGRADATIONS)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    clf = serving_classifier(init_classifier(gen, len(names), pretrained_backbone=False),
                             torch.bfloat16, dev)
    forward = _serving_expert(init_cdan(gen).to(dev), torch.bfloat16, dev)
    forward.forward = cuda_graphed([forward.forward])[0]
    router = RoutedRestorer([forward] * len(names), names, mode=args.mode,
                            capacity_factor=args.capacity_factor)
    pipe = FullPipeline(clf, router, [0.5] * len(names))
    images = torch.sin(torch.arange(b * h * w * 3, dtype=torch.float32, device=dev) * 0.001)
    images = images.abs().reshape(b, h, w, 3)

    row = {"mode": args.mode, "batch": b, "hw": [h, w], "n_experts": len(names),
           "iters": args.iters, "device": torch.cuda.get_device_name(0),
           **time_step(pipe, images, args.iters), "capacity_factor": args.capacity_factor,
           "capacity_drop_rate_by_skew": skewed_drop_rates(len(names), b, args.capacity_factor)}
    print(json.dumps(row))


if __name__ == "__main__":
    main()
