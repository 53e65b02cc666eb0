"""What a cell's ``drive_*`` module hands back to ``run``, and the helpers both use."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List

import torch


@dataclass
class Outcome:
    attempted: int
    failed: int
    e2e: Dict[str, float] = field(default_factory=dict)
    memory_peak: int = 0
    checks: List = field(default_factory=list)
    readings: Dict = field(default_factory=dict)  # every number read against the reference
    ctx: Dict = field(default_factory=dict)  # what the per-layer readers read


def event_sync(device) -> None:
    """Wait for the work queued so far on the current stream (an event
    recorded and synchronised); nothing on the CPU."""
    if device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()



def setup_marks(log, t_start: float) -> Callable[[str], None]:
    """``mark(what)`` logs the seconds since ``t_start`` at which a phase of
    set-up ended, so a run's standard error says where ``setup_s`` went."""
    def mark(what: str) -> None:
        log(f"set-up {time.perf_counter() - t_start:.3f} s: {what}")

    return mark
