"""Benchmarks and probes of the PyTorch port (run on a CUDA device)."""

from __future__ import annotations


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
