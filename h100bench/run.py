"""Run one cell of the benchmark once.

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell named in ``BENCHMARK.json`` (its configuration, traffic mix
and limits are files of their own under ``h100bench/``) and hands it to the
driver that its mix's ``kind`` names, ``drive_<kind>.py`` (see ``drivers``),
which makes the inputs and weights on the card from ``--seed``, warms up,
measures for ``--seconds`` and checks the timed path's outputs against the
plain reference.  It prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device`` and, traced, ``breakdown``; the numbers compared, each beside its
limit, are the last lines on standard error and the last key of the line
(``compared``).

Without a CUDA card, or with fewer cards than the cell asks for, it exits
with 2 and prints no result.  ``--device cpu`` is for the tests only: it
replaces the mix's sizes by its ``cpu_dry_run`` ones and reports the CPU.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is counted from here: before torch is imported

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "multi_degradation_image_enhancement_tpu")


def _pin_caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    program's own kernel library already builds into ``build/torch_kernels``)."""
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton_cache"))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: the port's name only begins with it)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"[h100bench] {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    _pin_caches()

    import torch

    from h100bench import cell as cells
    from h100bench import drivers
    from h100bench.outcome import setup_marks

    mark = setup_marks(log, T_START)
    mark("torch imported")

    dry = args.device == "cpu"
    cell = cells.load(args.workload, cpu_dry_run=dry)
    if not dry:
        if not torch.cuda.is_available():
            log("no CUDA device: nothing measured")
            return 2
        if torch.cuda.device_count() < cell.chips:
            log(f"{cell.name} needs {cell.chips} cards, {torch.cuda.device_count()} found")
            return 2
    device = torch.device("cuda:0" if not dry else "cpu")
    if not dry:
        torch.cuda.set_device(device)
        torch.ones(1, device=device).sum().item()
        mark("CUDA context")
    torch.set_num_threads(min(4, os.cpu_count() or 1))

    drive = drivers.load(cell.kind)
    out = drive.run(cell, args.seed, args.seconds, bool(args.trace), device, T_START, log)

    if args.trace:
        from h100bench import traces

        tr = out.ctx.get("trace")
        values = traces.read_metrics(traces.load_readers([m["name"] for m in cell.per_layer]),
                                     out.ctx)
        wanted = cell.per_layer
    else:
        values, wanted = out.e2e, cell.end_to_end
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in wanted
               if values.get(m["name"]) is not None}
    if dry:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    else:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": cell.chips,
               "memory_peak_bytes": int(out.memory_peak)}
    result = {"correct": all(c.ok for c in out.checks) and out.failed == 0,
              "attempted": out.attempted, "failed": out.failed, "metrics": metrics, "device": dev}
    if args.trace and tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": out.ctx["host_trace"].idle_gaps()}
        log(f"traced {tr.steps} steps: {len(tr.kernels)} device ops, busy {tr.busy_s:.6f} s of "
            f"{tr.window_s:.6f} s")
    if not dry:
        from h100bench.timing import card_identity

        log("card {} at {}".format(*card_identity()))
    for name, v in values.items():
        log(f"metric {name} = {v!r}")
    result["compared"] = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}

    found = forbidden_modules()
    if found:
        log(f"loaded in this process: {found}; a run of the port may load none of them")
        return 3
    for c in out.checks:
        log("compared " + c.line())
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
