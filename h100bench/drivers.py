"""A cell's driver, found by its traffic mix's ``kind``: ``drive_<kind>.py``
beside this file.  A kind of cell the harness has not run before comes in
as a new driver file, with its mix, configuration, limits and readers; no
file that is there changes.

A driver module exports three functions:

* ``run(cell, seed, seconds, trace, device, t_start, log) -> Outcome``:
  one run of the cell (``run.py``): set-up from the seed, warm-up, the
  window of ``seconds``, with ``trace`` the traced windows in
  ``Outcome.ctx`` for the per-layer readers, then the check against the
  plain reference (``Outcome.checks``, ``Outcome.readings``);
* ``control_readings(cell, seed, device, witness=False) -> dict``: the
  control's readings (the reference in the precision below the
  configuration's, in the program's place) and each planted fault's, by
  name; ``witness`` asks a driver that has one for the reference in the
  program's own precision besides, and the others ignore it;
* ``program_readings(cell, seed, device, seconds) -> dict``: the program's
  own readings, ``{"program": ...}``, for the lower readings of the limits.
"""

from __future__ import annotations

import importlib
import re
from pathlib import Path
from types import ModuleType
from typing import List

HERE = Path(__file__).resolve().parent
KIND = re.compile(r"^[a-z][a-z0-9_]*$")
EXPORTS = ("run", "control_readings", "program_readings")


def known() -> List[str]:
    """The driver files beside this one."""
    return sorted(p.name for p in HERE.glob("drive_*.py"))


def load(kind: str) -> ModuleType:
    """``h100bench.drive_<kind>``; a kind that is no name, or has no file,
    stops the run naming the drivers there are."""
    if not KIND.match(kind) or not (HERE / f"drive_{kind}.py").is_file():
        raise SystemExit(f"no driver for traffic kind {kind!r}: a kind names a file "
                         f"h100bench/drive_<kind>.py; found {known()}")
    return importlib.import_module(f"h100bench.drive_{kind}")
