"""routed_mfu: a routed batch's FLOPs (ResNet-18 and its heads over every
row, a CDAN forward for each row the reference routes to an expert; from
layer shapes, ``flops_routed9``) times the batches served a second in the
window, over 989 TFLOP/s, in %."""

from h100bench import flops, flops_routed9


def read(ctx):
    if ctx.get("kind") != "routed":
        return None
    work = flops_routed9.routed_batch_flops(ctx["batch"], ctx["height"], ctx["width"],
                                            ctx["routed_rows_a_batch"])
    return 100.0 * work * ctx["batches_per_s"] / flops.PEAK_FLOPS["bf16"]
