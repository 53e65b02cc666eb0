"""A cell as ``BENCHMARK.json`` names it, with everything found by name:
``configs/<config>.json`` (and the training recipe it points to, where it
names one), ``traffic/<mix>.json``, ``workloads/<cell>.json`` (the limits of
``correct``), and the metrics of ``BENCHMARK.json`` that the cell reports."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

from h100bench import traffic

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def _json(path: Path) -> Dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    recipe: Dict
    mix: Dict
    limits: Dict
    end_to_end: List[Dict] = field(default_factory=list)
    per_layer: List[Dict] = field(default_factory=list)

    @property
    def kind(self) -> str:
        return self.mix["kind"]


def load(name: str, cpu_dry_run: bool = False) -> Cell:
    bench = _json(BENCHMARK)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in {BENCHMARK.name}; known: "
                         f"{[w['name'] for w in bench['workloads']]}")
    config = _json(HERE / "configs" / f"{entry['config']}.json")
    return Cell(
        name=name, chips=int(entry["chips"]), config=config,
        recipe=_json(HERE / "configs" / config["recipe"]) if "recipe" in config else {},
        mix=traffic.load(entry["traffic"], cpu_dry_run),
        limits=_json(HERE / "workloads" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )
