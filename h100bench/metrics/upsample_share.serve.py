"""upsample_share.serve: the device time of the served forward's bilinear ×2
upsamples (the program's ``cdan/upsample`` device ranges) over the forward's
own (``serve/forward``), both summed over the traced windows, in %."""

from h100bench.metrics._spans import share


def read(ctx):
    return share(ctx, ("cdan/upsample",), "serve/forward")
