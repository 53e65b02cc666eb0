"""The control and the planted faults come out not correct: the reference in
FP8 in the program's place, and for the train cell a step on half its batch
and a step that leaves its state unchanged, each fail at least one of the
cell's compared numbers.  Here at the mixes' ``cpu_dry_run`` sizes on the
CPU; ``python3 -m h100bench.control`` reads them on the chip at the cells'
own sizes (PERF.md holds those readings and the limits set from them)."""

import pytest
import torch

from h100bench import cell as cells
from h100bench import checks, control

CPU = torch.device("cpu")


def _fails(values, cell):
    return [c.name for c in checks.judge(values, cell.limits) if not c.ok]


@pytest.mark.parametrize("seed", [2**31 + 5, 17])
def test_serve_control_is_not_correct(seed):
    cell = cells.load("cdan_noise.serve_b128", cpu_dry_run=True)
    assert _fails(control.serve_readings(cell, seed, CPU)["control"], cell)


@pytest.mark.parametrize("seed", [2**31 + 5, 17, 2147483721])
def test_train_control_and_faults_are_not_correct(seed):
    cell = cells.load("cdan_jpeg.train_b32", cpu_dry_run=True)
    readings = control.train_readings(cell, seed, CPU)
    for kind in ("control", "half_batch", "unchanged"):
        assert _fails(readings[kind], cell), kind
