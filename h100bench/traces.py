"""The traced window: ``torch.profiler`` over a fixed number of steps, reduced
to what the per-layer readers and the result line need.

* ``kernels``: every device operation (kernel, memcpy, memset) in time
  order, as (name, start µs, duration µs);
* ``busy_s``: the union of their intervals; ``window_s``: the host's wall
  clock over the traced steps, closed by a synchronise;
* ``device_ops``: the ten names with the most device time;
* ``idle_gaps``: the device's idle time between operations, each gap named
  by the innermost host op running at its midpoint (``host:python`` where
  none was), summed by name, the ten largest; read from a second window
  traced with the host's ops, whose tracing stretches the gaps.

Kernel families follow the program's kernel names (``csrc/*.cu``).  The
NCHW→NHWC pass is shared by the conv kernel's entry and the DenseBlock's:
each launch is counted with the next hand kernel after it on the stream.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

FAMILIES: Dict[str, Tuple[str, ...]] = {
    "dense_block": ("growth_wgmma_kernel", "transition_wgmma_kernel", "nhwc_to_slot_kernel"),
    "conv_cm": ("conv3x3_wgmma_kernel", "conv3x3_pool_wgmma_kernel"),
    "growth_train": ("growth_fwd_kernel", "growth_bwd_kernel", "growth_bwd_sum_kernel"),
}
SHARED_PASS = "nchw_to_nhwc_kernel"
HAND_PREFIXES = tuple(k for ks in FAMILIES.values() for k in ks) + (SHARED_PASS,)


@dataclass
class Trace:
    kernels: List[Tuple[str, float, float]]
    cpu_ops: List[Tuple[str, float, float]]
    window_s: float
    steps: int

    @property
    def device_s(self) -> float:
        return sum(d for _, _, d in self.kernels) * 1e-6

    def intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for _, s, d in sorted(self.kernels, key=lambda k: k[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], s + d)
            else:
                merged.append([s, s + d])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals()) * 1e-6

    def family_s(self, family: str) -> float:
        """Device seconds of one hand-kernel family, the shared NCHW→NHWC
        passes given to the family of the next hand kernel after each."""
        names = FAMILIES[family]
        total = 0.0
        ks = self.kernels
        for i, (name, _, dur) in enumerate(ks):
            if _matches(name, names):
                total += dur
            elif SHARED_PASS in name:
                nxt = next((n for n, _, _ in ks[i + 1:] if _matches(n, HAND_PREFIXES)
                            and SHARED_PASS not in n), "")
                if _matches(nxt, names):
                    total += dur
        return total * 1e-6

    def hand_s(self) -> float:
        return sum(d for n, _, d in self.kernels if _matches(n, HAND_PREFIXES)) * 1e-6

    def device_ops(self, top: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, _, dur in self.kernels:
            by[name] = by.get(name, 0.0) + dur * 1e-6
        return [[k[:160], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10, min_us: float = 1.0) -> List[List]:
        ops = sorted(self.cpu_ops, key=lambda o: o[1])
        starts = [o[1] for o in ops]
        by: Dict[str, float] = {}
        iv = self.intervals()
        for (_, end), (start, _) in zip(iv, iv[1:]):
            gap = start - end
            if gap < min_us:
                continue
            mid = end + gap / 2
            name = "host:python"
            j = bisect.bisect_right(starts, mid) - 1
            for k in range(j, max(j - 400, -1), -1):  # the latest-starting op covering mid
                n, s, d = ops[k]
                if s + d >= mid:
                    name = n
                    break
            by[name] = by.get(name, 0.0) + gap * 1e-6
        return [[k[:160], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def _matches(name: str, keys: Sequence[str]) -> bool:
    return any(k in name for k in keys)


def profile(step: Callable[[int], None], steps: int, sync: Callable[[], None],
            host: bool = False) -> Trace:
    """``step(i)`` for i < ``steps`` under ``torch.profiler``, closed by
    ``sync()``; the events reduced to a :class:`Trace`.  The device alone
    by default: tracing every host op slows a host-bound step by half, so
    the busy share is read without it; ``host=True`` adds the host ops, to
    name the idle gaps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    card = torch.cuda.is_available()  # a CPU dry run traces the host alone
    activities = [ProfilerActivity.CUDA] * card + [ProfilerActivity.CPU] * (host or not card)
    with torch_profile(activities=activities) as prof:
        sync()
        t0 = time.perf_counter()
        for i in range(steps):
            step(i)
        sync()
        window = time.perf_counter() - t0
    kernels, cpu = [], []
    for e in prof.events():
        rng = e.time_range
        item = (e.name, float(rng.start), float(rng.end - rng.start))
        if e.device_type == DeviceType.CUDA:
            kernels.append(item)
        elif e.device_type == DeviceType.CPU and not e.name.startswith("ProfilerStep"):
            cpu.append(item)
    kernels.sort(key=lambda k: k[1])
    return Trace(kernels=kernels, cpu_ops=cpu, window_s=window, steps=steps)


def load_readers(names: Sequence[str]) -> Dict[str, Callable]:
    """Each per-layer metric's reader, ``metrics/<name>.py``'s ``read``."""
    import importlib.util
    from pathlib import Path

    out = {}
    for name in names:
        path = Path(__file__).resolve().parent / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"h100bench_metric_{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        out[name] = module.read
    return out


def read_metrics(readers: Dict[str, Callable], ctx) -> Dict[str, Optional[float]]:
    """Every reader's value; a reader that finds nothing returns None and
    the metric is left out."""
    return {name: fn(ctx) for name, fn in readers.items()}
