"""train_mfu: a train step's FLOPs (``flops.train_step_flops``: CDAN forward
and backward, the loss networks' forwards on output and target and their
backward to the output) times the window's steps a second, over 989 TFLOP/s,
in %."""

from h100bench import flops


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    step = flops.train_step_flops(ctx["batch"], ctx["height"], ctx["width"], ctx["terms"])
    return 100.0 * step * ctx["steps_per_s"] / flops.PEAK_FLOPS["bf16"]
