"""dense_block_roofline: the bound of the four inference DenseBlocks' work
(``flops.dense_block_work``, bf16) over the device time of their kernels
(#2: entry, growth and transition launches), in %."""

from h100bench import flops
from h100bench.metrics._shared import roofline


def read(ctx):
    shapes = flops.dense_block_shapes(ctx["batch"], ctx["height"], ctx["width"])
    return roofline(ctx, "dense_block", flops.dense_block_work(shapes))
