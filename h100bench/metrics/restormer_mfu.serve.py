"""restormer_mfu.serve: the Restormer forward's FLOPs (from its layer shapes,
``flops_restormer``) times the images restored a second in the window, over
989 TFLOP/s, in %."""

from h100bench import flops, flops_restormer


def read(ctx):
    if ctx.get("kind") != "restormer_serve":
        return None
    per_image = flops_restormer.forward_flops(ctx["height"], ctx["width"], ctx["network"])
    return 100.0 * per_image * ctx["images_per_s"] / flops.PEAK_FLOPS["bf16"]
