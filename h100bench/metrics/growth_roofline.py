"""growth_roofline: the bound of the 16 forward and 16 backward growth-layer
calls of a train step (``flops.growth_train_work``) over the device time of
kernels #4–#7, in %."""

from h100bench import flops
from h100bench.metrics._shared import roofline


def read(ctx):
    b, h, w = ctx["batch"], ctx["height"], ctx["width"]
    fwd, bwd = flops.growth_train_work(b, h, w, False), flops.growth_train_work(b, h, w, True)
    return roofline(ctx, "growth_train", (fwd[0] + bwd[0], fwd[1] + bwd[1]))
