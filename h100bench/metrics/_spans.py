"""What the readers of the program's spans share.  While a profiler runs,
the program times named device ranges (``utils.tracing``: ``serve/forward``,
``cdan/upsample``, ``train/step``, ``loss/lpips``, ...) with CUDA events on
its own stream; ``device_totals()`` sums them over both traced windows, the
only time a profiler runs in a run."""

from __future__ import annotations

import json
import sys


def totals(ctx):
    """``{name: (ranges, device ms)}`` of the traced windows, read once a
    run, or None: without a trace, for a program without the span facility,
    or where it recorded no device range (a CPU dry run)."""
    if ctx.get("trace") is None:
        return None
    if "span_totals" not in ctx:
        try:
            from multi_degradation_image_enhancement_tpu_torch.utils import tracing
        except ImportError:
            ctx["span_totals"] = None
        else:
            ctx["span_totals"] = tracing.device_totals() or None
            _log(ctx, tracing.dropped())
    return ctx["span_totals"]


def share(ctx, parts, whole):
    """The device ms of the ranges named in ``parts`` over those of
    ``whole``, in %; None where ``whole`` or every part is missing."""
    got = totals(ctx)
    if not got or got.get(whole, (0, 0.0))[1] <= 0 or not any(p in got for p in parts):
        return None
    return 100.0 * sum(got[p][1] for p in parts if p in got) / got[whole][1]


def _log(ctx, dropped: int) -> None:
    """A sanity line on standard error, not a metric: the totals (and the
    ranges a full registry left out) beside the device-only window's busy
    time and the host window's wall, a step."""
    tr, host = ctx["trace"], ctx.get("host_trace")
    line = {"span_totals": ctx["span_totals"], "dropped": dropped,
            "busy_ms_a_step": 1e3 * tr.busy_s / tr.steps,
            "host_window_wall_ms_a_step": host and 1e3 * host.window_s / host.steps}
    print(f"[h100bench] program spans {json.dumps(line)}", file=sys.stderr, flush=True)
