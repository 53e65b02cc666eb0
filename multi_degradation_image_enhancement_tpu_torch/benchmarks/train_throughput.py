"""Training throughput at the recipe's shape (counterpart of
``benchmarks/train_throughput.py``).

    python -m multi_degradation_image_enhancement_tpu_torch.benchmarks.train_throughput \\
        [--iters 3] [--chunk 8] [--rows b16,b16_fused,b32,b64_remat] [--hw 256 384] \\
        [--batch N] [--device cuda|cpu] [--json-out build/train_throughput.json]

The step is the engine's (``engine.model.make_train_step``): forward,
Charbonnier + 0.5·SSIM, backward, Adam at 1e-3, BatchNorm statistics; bf16
autocast on the card (fp32 on the CPU), on one pair from
``degrade_batch(…, "noise")`` of a ``linspace`` clean batch, the weights
Flax's default init from seed 0.  ``fused_dense`` rows run the
DenseBlocks' growth layers through kernels #4–#7; ``remat`` rows
rematerialise every block (``models.norm.Rematerialized``).

A chunk of ``--chunk`` steps runs with no host read between them, closed by
one readback of the last loss; the best of ``--iters`` chunks gives ms a
step and img/s (the JAX script's ``lax.scan`` chunk; here the steps queue
on the card as the engine's loop queues them).  Each row also records the
growth-kernel launches of its timed chunks.  A row that fails (out of
memory, say) is recorded with its error; the script exits 1 when every row
failed.  ``--batch`` replaces every row's batch (a smoke at a small size).
Rows are merged into ``--json-out``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Optional, Sequence

ROWS = {
    # name: (batch, fused_dense, remat)
    "b16": (16, False, False),
    "b16_fused": (16, True, False),
    "b32": (32, False, False),
    "b32_fused": (32, True, False),
    "b64": (64, False, False),
    "b64_remat": (64, False, True),
}
LOSS = {"enabled": True, "terms": [
    {"name": "charbonnier", "weight": 1.0, "args": {"eps": 1e-3}},
    {"name": "ssim", "weight": 0.5},
]}


def build_row(batch: int, fused: bool, remat: bool, hw, device, seed: int = 0):
    """``(step, state, degraded01, clean01, precision)`` of one row: the
    engine's train step, a fresh CDAN's state and one noise pair."""
    import torch

    from multi_degradation_image_enhancement_tpu_torch.engine.model import make_train_step
    from multi_degradation_image_enhancement_tpu_torch.engine.state import TrainState
    from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN
    from multi_degradation_image_enhancement_tpu_torch.models.torch_init import flax_default_init_
    from multi_degradation_image_enhancement_tpu_torch.ops.degradations import degrade_batch
    from multi_degradation_image_enhancement_tpu_torch.ops.losses import build_loss_pipeline

    h, w = hw
    model = flax_default_init_(CDAN(), torch.Generator().manual_seed(seed))
    model.fused_dense = fused
    model.remat = remat
    state = TrainState.create(model.to(device), 1e-3)
    precision = "bf16" if device.type == "cuda" else "fp32"
    step = make_train_step(build_loss_pipeline(LOSS, device), precision)
    clean = torch.linspace(0.0, 255.0, batch * h * w * 3, device=device).reshape(batch, h, w, 3)
    degraded01, clean01 = degrade_batch(clean, "noise", torch.Generator(device).manual_seed(7))
    return step, state, degraded01, clean01, precision


def measure(batch: int, fused: bool, remat: bool, chunk: int, iters: int, hw, device) -> dict:
    import torch

    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.growth_train import (
        growth_layer_bwd,
        growth_layer_fwd,
    )

    step, state, x, y, precision = build_row(batch, fused, remat, hw, device)
    dropout = torch.Generator(device).manual_seed(1)

    def run_chunk() -> float:
        for _ in range(chunk):
            losses = step(state, x, y, dropout)
        return float(losses["total"])  # one readback closes the chunk

    run_chunk()  # warm-up: kernel build, cuDNN's choice
    n0 = (growth_layer_fwd.launches, growth_layer_bwd.launches)
    best, loss = math.inf, math.nan
    for _ in range(iters):
        t0 = time.perf_counter()
        loss = run_chunk()
        best = min(best, time.perf_counter() - t0)
    return {"batch": batch, "fused_dense": fused, "remat": remat, "hw": list(hw),
            "chunk": chunk, "iters": iters, "precision": precision,
            "step_ms": best / chunk * 1e3, "img_s": batch * chunk / best, "last_loss": loss,
            "growth_launches": {"fwd": growth_layer_fwd.launches - n0[0],
                                "bwd": growth_layer_bwd.launches - n0[1]}}


def main(argv: Optional[Sequence[str]] = None) -> int:
    import torch

    from multi_degradation_image_enhancement_tpu_torch.benchmarks import card_identity
    from multi_degradation_image_enhancement_tpu_torch.engine.model import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--rows", default="b16,b16_fused,b32,b64_remat")
    ap.add_argument("--hw", type=int, nargs=2, default=[256, 384])
    ap.add_argument("--batch", type=int, default=None, help="replaces every row's batch")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--json-out", default=os.path.join("build", "train_throughput.json"))
    args = ap.parse_args(argv)
    names = [r for r in args.rows.split(",") if r]
    unknown = sorted(set(names) - set(ROWS))
    if unknown:
        raise ValueError(f"unknown rows {unknown}; known: {sorted(ROWS)}")
    device = resolve_device(args.device)

    out = {}
    if os.path.isfile(args.json_out):
        try:
            with open(args.json_out, encoding="utf-8") as f:
                out = json.load(f)
        except ValueError:
            out = {}
    if device.type == "cuda":
        out.update(device=torch.cuda.get_device_name(device), power_limit=card_identity()[1])
    else:
        out.update(device="cpu", power_limit=None)
    failed = 0
    for name in names:
        batch, fused, remat = ROWS[name]
        batch = args.batch or batch
        print(f"[train_tp] {name}: b{batch} fused={fused} remat={remat} ...", flush=True)
        try:
            row = measure(batch, fused, remat, args.chunk, args.iters, tuple(args.hw), device)
            print(f"[train_tp] {name}: {row['img_s']:.1f} img/s ({row['step_ms']:.3f} ms/step), "
                  f"last loss {row['last_loss']:.5f}, growth launches {row['growth_launches']}",
                  flush=True)
        except Exception as e:  # an out-of-memory row is data, not a crash
            failed += 1
            row = {"batch": batch, "fused_dense": fused, "remat": remat, "error": str(e)[:300]}
            print(f"[train_tp] {name}: FAILED {str(e)[:160]}", flush=True)
            if device.type == "cuda":
                torch.cuda.empty_cache()
        out[name] = row
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
        with open(args.json_out, "w", encoding="utf-8") as f:
            json.dump(out, f, indent=2)
    print(f"[train_tp] -> {args.json_out}")
    return 1 if failed == len(names) else 0


if __name__ == "__main__":
    sys.exit(main())
