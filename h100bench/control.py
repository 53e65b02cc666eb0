"""The control and the planted faults, on the card at a cell's own size: the
upper readings the limits of ``correct`` are set below.  The benchmark's
own runs never run this.

    python3 -m h100bench.control --workload <cell> --seeds 5,6,7

For each seed it has the cell's driver (``drive_<kind>.py``, found by the
mix's ``kind``; see ``drivers``) make the run's inputs and weights and
prints, as one JSON line each, the cell's numbers with the reference itself
put in the program's place (the driver's ``control_readings``): ``control``,
the reference in the precision below the configuration's, and each planted
fault the cell can have under its own name.

``--program`` reads the program's own numbers instead (the driver's
``program_readings``), for the lower readings, every seed in one process.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from h100bench import drivers

# The serve and train drivers' controls, under the names they had here before
# the drivers held them.
from h100bench.drive_serve import control_readings as serve_readings  # noqa: F401
from h100bench.drive_train import control_readings as train_readings  # noqa: F401


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--program", action="store_true",
                    help="the program's own numbers instead of the control's")
    ap.add_argument("--seconds", type=float, default=4.0,
                    help="with --program, the window of each run where the driver has one")
    ap.add_argument("--witness", action="store_true",
                    help="train cells: also the reference in bf16, the program's precision")
    args = ap.parse_args(argv)
    from h100bench import cell as cells

    cell = cells.load(args.workload, cpu_dry_run=args.device == "cpu")
    device = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    drive = drivers.load(cell.kind)
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.program:
            got = drive.program_readings(cell, seed, device, args.seconds)
        else:
            got = drive.control_readings(cell, seed, device, witness=args.witness)
        print(json.dumps({"workload": cell.name, "seed": seed, **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
