"""Spans: named ranges of the port's work, recorded only while a
``torch.profiler`` session runs.

``span(name, device=None)`` is a context manager:

* off (no profiler session): one ``torch.autograd._profiler_enabled()``
  check, then a shared no-op context.  Nothing is allocated, no op is
  dispatched and no CUDA event is recorded;
* on: a host range, ``torch._C._profiler._RecordFunctionFast(name)``, a
  FUNCTION-scope host op on the profiler's own clock beside the aten ops.
  It is not a user annotation (``torch.profiler.record_function``), which
  the profiler turns into a device event under CUDA;
* on, with ``device`` a CUDA device (pass the work's ``x.device``): also a
  pair of timing CUDA events on that device's stream current at entry, one
  at entry and one at exit.
  Stream order makes the range hold everything queued between the two,
  whichever thread queued it, the backward that autograd's device thread
  launches included.  The events come from a reused pool, one a card, since
  an event serves only the card it was first recorded on.  Nothing waits
  on the way: a pair is folded into its name's totals by
  :func:`device_totals`, or earlier, once :data:`MAX_PENDING` pairs wait,
  where ``query()`` says its end has passed.

:func:`device_totals` synchronises once and returns ``{name: (count,
device ms)}`` of the device ranges since :func:`reset`.  The registry is
bounded: at most :data:`MAX_PENDING` pairs wait to be folded, and a range
opened while that many wait unfinished records no events;
:func:`dropped` counts the ranges so left out.

A device range does on the way only what it must: one lookup of its
card's current stream and two event records (35.6–36.4 µs a range in all
under a profiler, on the host of an NVIDIA H100 80GB HBM3 machine);
``query()`` and ``elapsed_time()`` (2–3 µs and 8–11 µs there) wait for the
fold.

Names are ``layer/what`` (``serve/forward``, ``cdan/upsample``,
``kernel/dense_block``, ``train/backward``, ``loss/lpips``, ...); ``PERF.md``
§3 lists each with what reads it.  The kernels' launch counters stay the
entry points' own ``.launches`` attributes.
"""

from __future__ import annotations

import contextlib
import threading
from collections import deque
from typing import Dict, Optional, Tuple

import torch

MAX_PENDING = 2048  # event pairs waiting to be folded

_profiler_enabled = torch.autograd._profiler_enabled
_current_stream = torch.cuda.current_stream
_host_range = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()

_lock = threading.Lock()
_free: Dict[int, list] = {}  # card index -> timing events ready to record again
_pending: deque = deque()  # (name, card index, start, end) recorded, not yet folded
_totals: Dict[str, list] = {}  # name -> [count, device ms]
_dropped = 0


def _new_event():
    return torch.cuda.Event(enable_timing=True)


def span(name: str, device: Optional[torch.device] = None):
    """A range named ``name`` around the ``with`` block: nothing with no
    profiler running; else a host range and, where ``device`` is a CUDA
    device, a device range on its current stream (see the module's
    docstring)."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name, device)


class _Span:
    __slots__ = ("name", "device", "host", "events", "stream")

    def __init__(self, name: str, device: Optional[torch.device]):
        self.name, self.device = name, device
        self.host, self.events = _host_range(name), None

    def __enter__(self):
        self.host.__enter__()
        if self.device is not None and self.device.type == "cuda":
            self.stream = _current_stream(self.device)
            self.events = _take_pair(self.stream.device_index)
            if self.events is not None:
                self.events[0].record(self.stream)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(self.stream)
            with _lock:
                _pending.append((self.name, self.stream.device_index, *self.events))
        self.host.__exit__(*exc)
        return False


def _take_pair(card: int):
    global _dropped
    with _lock:
        while len(_pending) >= MAX_PENDING and _pending[0][3].query():
            _fold(*_pending.popleft())
        if len(_pending) >= MAX_PENDING:
            _dropped += 1
            return None
        free = _free.setdefault(card, [])
        return (free.pop() if free else _new_event(), free.pop() if free else _new_event())


def _fold(name: str, card: int, start, end) -> None:
    """Add one finished pair to ``name``'s totals (the lock held)."""
    total = _totals.setdefault(name, [0, 0.0])
    total[0] += 1
    total[1] += start.elapsed_time(end)
    _free[card].extend((start, end))


def device_totals() -> Dict[str, Tuple[int, float]]:
    """``{name: (ranges, device ms)}`` of every device range since
    :func:`reset`, after waiting for the ranges still in flight."""
    with _lock:
        while _pending:
            name, card, start, end = _pending.popleft()
            end.synchronize()
            _fold(name, card, start, end)
        return {name: (count, ms) for name, (count, ms) in _totals.items()}


def dropped() -> int:
    """Device ranges since :func:`reset` left out of the totals because
    :data:`MAX_PENDING` pairs waited unfinished."""
    return _dropped


def reset() -> None:
    """Forget every total and every range still in flight."""
    global _dropped
    with _lock:
        while _pending:
            _, card, start, end = _pending.popleft()
            _free[card].extend((start, end))
        _totals.clear()
        _dropped = 0
