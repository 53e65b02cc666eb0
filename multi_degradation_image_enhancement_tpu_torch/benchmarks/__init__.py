"""Benchmarks and probes of the PyTorch port (run on a CUDA device)."""

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


def require_cuda() -> None:
    """A measurement without a card is no measurement: raise."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("this benchmark times a CUDA device, and none is available")


def host_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean host-clock time of ``fn()`` in ms over ``reps`` calls after
    ``warmup`` calls: the CPU's time, never a device metric."""
    import time

    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


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
