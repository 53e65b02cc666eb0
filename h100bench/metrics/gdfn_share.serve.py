"""gdfn_share.serve: the device time of the served forward's 44 LN2 + GDFN +
residual-add halves (the program's ``restormer/gdfn`` device ranges) over
the forward's own (``serve/forward``), both summed over the traced windows,
in %."""

from h100bench.metrics._spans import share


def read(ctx):
    return share(ctx, ("restormer/gdfn",), "serve/forward")
