"""forward_share.train: the device time of the train step's autocast forward
(``train/forward``) over the whole step's (``train/step``), both summed over
the traced windows, in %."""

from h100bench.metrics._spans import share


def read(ctx):
    return share(ctx, ("train/forward",), "train/step")
