"""Measure the serving forward's variants on the card and write the winner
to the port's ``config/serving_tuning.json`` (counterpart of
``benchmarks/tune_serving.py``), so the port's serving defaults follow its
own card's measurements, not the TPU's.

    python -m multi_degradation_image_enhancement_tpu_torch.benchmarks.tune_serving \\
        [--batch 128] [--size 256] [--iters 20] [--dry-run] [--max-diff 0.25] \\
        [--device cuda|cpu] [--out PATH]

The sweep is the one choice left on the card (the JAX sweep's K-stack and
``nhwc_io`` are TPU layouts; its per-block / CM choice and the CM conv
table are gone, since the card's A/B put the CM forward with every conv on
#8 ahead of both, ``models/cdan_fast.py``): the served forward with the
DenseBlocks' affine + ReLU in f32 or in bf16 (``db_bf16_act``, at
``db_k_stack_max_ci`` 56, the shipped rounding point).  The first variant,
f32 activations, is the baseline of the sanity gate: a variant whose output
is not finite or lies more than ``--max-diff`` from the baseline's on the
same degraded batch can win nothing, however fast.

Each variant is the whole degrade→restore step of ``serving.build_pipeline``
(bf16 on the card, f32 on the CPU), timed with CUDA events over ``--iters``
steps (on the CPU by the host clock), in turns: every variant once, then
every variant again in reverse order, the two means averaged, so drift over
the run does not rank them.

The winner's ``db_bf16_act`` and ``db_k_stack_max_ci`` are merged into
``--out`` (the port's file unless named; other keys are kept), with
``provenance.forward_variants``: the card's name and power limit, the date
and every variant's ms.  With no sane variant it exits 1 and leaves the file
untouched; ``--dry-run`` measures only.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import List, Optional, Sequence

K_STACK = 56
KEYS = ("db_bf16_act", "db_k_stack_max_ci")
# db_bf16_act of each variant; the first is the sanity gate's baseline
VARIANTS = [False, True]
SCRIPT = "multi_degradation_image_enhancement_tpu_torch/benchmarks/tune_serving.py"


def label(v: dict) -> str:
    return f"bf16_act={int(v['db_bf16_act'])}"


def build_step(batch: int, size: int, dtype, device, variant: dict):
    """The serving step of one variant and its clean batch: the forward built
    under ``variant``'s tuning keys."""
    from multi_degradation_image_enhancement_tpu_torch import serving

    return serving.build_pipeline(batch, size, dtype, device,
                                  tuning={k: variant[k] for k in KEYS})


def sweep(batch: int, size: int, iters: int, device, max_diff: float) -> List[dict]:
    """Every variant's output against the baseline's, then its ms in turns."""
    import torch

    from multi_degradation_image_enhancement_tpu_torch.benchmarks import cuda_ms, host_ms

    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    timer = cuda_ms if device.type == "cuda" else host_ms
    results, steps = [], {}
    ref = None
    for bf16_act in VARIANTS:
        v = {"db_bf16_act": bf16_act, "db_k_stack_max_ci": K_STACK}
        try:
            step, clean = build_step(batch, size, dtype, device, v)
            # the same σ and noise seed for every variant
            out = step(clean, torch.Generator().manual_seed(7)).float().cpu()
        except Exception as e:  # a variant that does not run is data, not a crash
            v.update(error=str(e)[:300], sane=False)
            print(f"{label(v)}: FAILED {e}", flush=True)
            results.append(v)
            continue
        if ref is None:
            ref = out
        diff = float((out - ref).abs().max()) if bool(torch.isfinite(out).all()) else math.inf
        v.update(maxdiff_vs_baseline_variant=diff, sane=diff <= max_diff)  # NaN: not sane
        steps[len(results)] = (step, clean)
        results.append(v)

    order = list(steps)
    gen = torch.Generator().manual_seed(11)
    turns = {i: [] for i in order}
    for turn in (order, order[::-1]):
        for i in turn:
            step, clean = steps[i]
            turns[i].append(timer(lambda: step(clean, gen), iters))
    for i in order:
        v = results[i]
        ms = sum(turns[i]) / len(turns[i])
        v.update(ms_per_step=ms, ms_turns=turns[i], img_per_s=batch / ms * 1e3)
        print(f"{label(v):28s} {ms:8.3f} ms/step ({turns[i][0]:.3f}, {turns[i][1]:.3f}) "
              f"{v['img_per_s']:8.1f} img/s  maxdiff {v['maxdiff_vs_baseline_variant']:.3e}"
              f"{'' if v['sane'] else '  INSANE: excluded'}", flush=True)
    return results


def write_tuning(path: str, best: dict, provenance: dict) -> None:
    """Merge the winner's keys into ``path``, keeping keys other tuners own."""
    cfg = {}
    if os.path.isfile(path):
        try:
            with open(path, encoding="utf-8") as f:
                cfg = json.load(f)
        except ValueError:
            cfg = {}
    cfg.update({k: best[k] for k in KEYS})
    prov = cfg.get("provenance")
    if not isinstance(prov, dict):
        prov = {}
    prov["forward_variants"] = provenance
    cfg["provenance"] = prov
    with open(path, "w", encoding="utf-8") as f:
        json.dump(cfg, f, indent=2)
        f.write("\n")


def main(argv: Optional[Sequence[str]] = None) -> int:
    import torch

    from multi_degradation_image_enhancement_tpu_torch.benchmarks import card_identity
    from multi_degradation_image_enhancement_tpu_torch.engine.model import resolve_device
    from multi_degradation_image_enhancement_tpu_torch.models import cdan_fast

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--dry-run", action="store_true", help="measure only")
    ap.add_argument("--max-diff", type=float, default=0.25,
                    help="sanity gate: the largest |out - baseline variant's| a winner may "
                         "show (outputs are [0, 1] images; bf16 drift is ~1e-2, garbage ~1)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=str(cdan_fast._TUNING_PATH))
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    results = sweep(args.batch, args.size, args.iters, device, args.max_diff)
    eligible = [r for r in results if r["sane"] and "ms_per_step" in r]
    if not eligible:
        print("no sane variant; tuning file untouched", flush=True)
        return 1
    best = min(eligible, key=lambda r: r["ms_per_step"])
    print(f"winner: {label(best)} ({best['ms_per_step']:.3f} ms/step, "
          f"{best['img_per_s']:.1f} img/s)", flush=True)
    if args.dry_run:
        return 0
    if device.type == "cuda":
        name, power = card_identity()
        card = {"device": name or torch.cuda.get_device_name(device), "power_limit": power,
                "timing": "CUDA events, in turns (every variant, then every variant in "
                          "reverse); ms_per_step the mean of the two turns"}
    else:
        card = {"device": "cpu", "power_limit": None,
                "timing": "host clock on the CPU, in turns; not a device measurement"}
    write_tuning(args.out, best, {
        "script": SCRIPT, **card, "batch": args.batch, "size": args.size, "iters": args.iters,
        "dtype": "bfloat16" if device.type == "cuda" else "float32",
        "date_utc": time.strftime("%Y-%m-%d", time.gmtime()), "results": results})
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
