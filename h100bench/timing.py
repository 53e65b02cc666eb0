"""Timing helpers, copied from the port's ``benchmarks/__init__.py`` so that
a change to the program cannot move them."""

from __future__ import annotations

from typing import Optional, Tuple


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events around ``reps``
    calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_identity() -> Tuple[Optional[str], Optional[str]]:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them
    (``("NVIDIA H100 80GB HBM3", "700.00 W")``), or ``(None, None)`` where
    ``nvidia-smi`` does not answer."""
    import subprocess

    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None, None
    name, _, power = line.rpartition(",")
    return name.strip(), power.strip()
