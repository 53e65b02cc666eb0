"""classify_share.routed: the device time of the classifier, its
normalisation and its sigmoids (the program's ``pipeline/classify`` device
ranges) over the whole routed batch's (``pipeline/forward``), both summed
over the traced windows, in %."""

from h100bench.metrics._spans import share


def read(ctx):
    return share(ctx, ("pipeline/classify",), "pipeline/forward")
