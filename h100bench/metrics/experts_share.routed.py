"""experts_share.routed: the device time of the experts' gathers, forwards
and scatters (the program's ``pipeline/expert`` device ranges) over the
whole routed batch's (``pipeline/forward``), both summed over the traced
windows, in %."""

from h100bench.metrics._spans import share


def read(ctx):
    return share(ctx, ("pipeline/expert",), "pipeline/forward")
