"""The control and the planted faults, on the card at a cell's own size: the
upper readings the limits of ``correct`` are set below.  The benchmark's
own runs never run this.

    python3 -m h100bench.control --workload <cell> --seeds 5,6,7

For each seed it makes the run's inputs and weights
(``drive_serve.prepare``, ``drive_train.prepare``) and prints, as one JSON
line each, the cell's numbers with the reference itself put in the
program's place:

* ``control``: the reference in FP8 (every CDAN conv and linear takes e4m3
  operands and, in the backward, e5m2 gradients, with per-tensor scales),
  the precision below the configuration's bf16;
* train cells also ``half_batch`` (each step on half its batch, the mean
  taken over the rest) and ``unchanged`` (a step that returns its state
  unchanged: the parameters and statistics left at their start).

``--program`` reads the program's own numbers instead, for the lower
readings, every seed in one process: for a train cell the run's set-up
steps; for a serve cell a run with a window of ``--seconds`` (long enough
to serve the requests the check samples).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def serve_readings(cell, seed, device):
    from h100bench import drive_serve, traffic

    pool, state = drive_serve.prepare(cell, seed, device)
    steps = traffic.sample_steps(seed, cell.mix["sample"])
    got = {k: (k % len(pool), None) for k in steps}
    return {"control": drive_serve.serve_numbers(cell, seed, pool, state, got, quant="fp8")}


def train_readings(cell, seed, device, witness=False):
    from h100bench import checks, drive_train
    from h100bench.reference import exact_f32
    from h100bench.reference.train import train_steps

    degraded, clean, state0, perceptual = drive_train.prepare(cell, seed, device)
    feed = drive_train.Feed(seed, cell.mix, degraded, clean, device)
    batches = [feed(i) for i in range(int(cell.mix["reference_steps"]))]
    terms, lr = cell.recipe["loss"]["terms"], float(cell.config["train"]["lr"])
    with exact_f32():
        ref = train_steps(state0, batches, terms, perceptual, lr)
        out = {"control": checks.train_numbers(
                   train_steps(state0, batches, terms, perceptual, lr, quant="fp8"), ref, state0),
               "half_batch": checks.train_numbers(
                   train_steps(state0, batches, terms, perceptual, lr, half_batch=True), ref,
                   state0)}
        if witness:
            out["bf16_witness"] = checks.train_numbers(
                train_steps(state0, batches, terms, perceptual, lr, quant="bf16"), ref, state0)
    params = {k: state0[k] for k in ref["params"]}
    still = {"losses": ref["losses"], "grads": {k: torch.zeros_like(v) for k, v in params.items()},
             "params": params, "buffers": {k: state0[k] for k in ref["buffers"]},
             "buffers1": {k: state0[k] for k in ref["buffers"]}}
    out["unchanged"] = checks.train_numbers(still, ref, state0)
    return out


def program_readings(cell, seed, device, seconds):
    """The program's own numbers against the reference: for a train cell
    its set-up steps (the window's step function on the run's state, no
    window); for a serve cell a whole run with a window of ``seconds``."""
    if cell.kind == "serve":
        from h100bench import drive_serve

        out = drive_serve.run(cell, seed, seconds, False, device, time.perf_counter(),
                              lambda msg: None)
        return {"program": out.readings}
    from h100bench import drive_train

    ses = drive_train.Trainer(cell, seed, device)
    ses.free_program(device)
    return {"program": ses.numbers()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--program", action="store_true",
                    help="the program's own numbers instead of the control's")
    ap.add_argument("--seconds", type=float, default=4.0,
                    help="serve cells with --program: the window of each run")
    ap.add_argument("--witness", action="store_true",
                    help="train cells: also the reference in bf16, the program's precision")
    args = ap.parse_args(argv)
    from h100bench import cell as cells

    cell = cells.load(args.workload, cpu_dry_run=args.device == "cpu")
    device = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    read = serve_readings if cell.kind == "serve" else train_readings
    if args.witness and cell.kind == "train":
        def read(c, s, d):
            return train_readings(c, s, d, witness=True)
    if args.program:
        def read(c, s, d):
            return program_readings(c, s, d, args.seconds)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": cell.name, "seed": seed, **read(cell, seed, device)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
