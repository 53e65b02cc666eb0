"""backward_share.train: the device time of the train step's ``zero_grad`` and
``.backward()`` (``train/backward``, the kernels autograd's device thread
queues included) over the whole step's (``train/step``), both summed over
the traced windows, in %."""

from h100bench.metrics._spans import share


def read(ctx):
    return share(ctx, ("train/backward",), "train/step")
