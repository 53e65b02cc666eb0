"""Every cell, configuration, traffic mix, limit file and per-layer metric of
``BENCHMARK.json`` is found by its name, and the file keeps its
shape (names, units, bounds, the metrics each cell reports).  Nothing here
names today's cells: a cell's kind has a driver file, a cut of a
configuration is written down beside its published value, and four-chip
cells stay within a quarter of the cells."""

import json
import re
from pathlib import Path

import pytest

from h100bench import cell as cells
from h100bench import drivers, traces

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _entry(group, name):
    return next(e for e in BENCH[group] if e["name"] == name)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(cell):
    c = cells.load(cell)
    drive = drivers.load(c.kind)  # a kind with no drive_<kind>.py stops here
    assert all(callable(getattr(drive, f, None)) for f in drivers.EXPORTS)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    assert set(c.limits["numbers"])  # every cell holds limits for correct
    for m in c.per_layer:  # a per-layer metric's cells report the metric it moves
        assert m["moves"] in names
    reduced = _entry("configs", _entry("workloads", cell)["config"])["reduced"]
    assert c.config.get("reduced", []) == reduced
    for key in reduced:  # each cut names a key the file holds, its published value beside it
        assert key in c.config and key in c.config["published"], key
    if reduced:
        assert isinstance(c.config["deployment"], str) and c.config["deployment"].strip()
    traces.load_readers([m["name"] for m in c.per_layer])


def test_metric_readers_load_and_find_nothing_without_a_trace():
    readers = traces.load_readers([m["name"] for m in BENCH["per_layer"]])
    ctx = {"kind": "none", "batch": 1, "height": 8, "width": 8}
    assert all(fn(ctx) is None for fn in readers.values())


def test_names_units_and_bounds():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]) and entry["name"] not in seen
            seen.add(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("h100bench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    chips = [w["chips"] for w in BENCH["workloads"]]
    assert set(chips) <= {1, 4} and chips.count(4) <= max(1, len(chips) // 4)
