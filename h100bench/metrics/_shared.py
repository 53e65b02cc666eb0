"""What several per-layer readers compute alike.  Each reader takes the
run's context (``ctx``: the cell's sizes, the window's rate, the traced
window ``ctx["trace"]``) and returns a number, or None
where it finds nothing to read (the metric is then left out)."""

from __future__ import annotations

from h100bench import flops


def serve_mfu(ctx):
    """The served forward's FLOPs a second, over the bf16 peak, in %."""
    if ctx.get("kind") != "serve":
        return None
    per_image = flops.cdan_forward_flops(ctx["height"], ctx["width"])
    return 100.0 * per_image * ctx["images_per_s"] / flops.PEAK_FLOPS["bf16"]


def device_idle(ctx):
    """The traced window's share with no device operation running, in %."""
    tr = ctx.get("trace")
    if tr is None or not tr.kernels or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def roofline(ctx, family, work):
    """The bound of ``steps`` × ``work`` over the family's device time, in %."""
    tr = ctx.get("trace")
    if tr is None:
        return None
    seconds = tr.family_s(family)
    if seconds <= 0:
        return None
    return flops.roofline_share((work[0] * tr.steps, work[1] * tr.steps), seconds)
