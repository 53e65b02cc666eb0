"""conv_cm_roofline: the bound of conv1 + pool (#9) and the seven CM convs
(#8) (``flops.conv_cm_work``) over their kernels' device time, the NHWC
passes in front of #8 included, in %."""

from h100bench import flops
from h100bench.metrics._shared import roofline


def read(ctx):
    return roofline(ctx, "conv_cm", flops.conv_cm_work(ctx["batch"], ctx["height"], ctx["width"]))
