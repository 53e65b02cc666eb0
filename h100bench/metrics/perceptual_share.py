"""perceptual_share: the loss networks' terms (VGG19 features[:20] and
LPIPS-alex: forward on output and target, backward to the output), timed by
CUDA events from the benchmark's side on one step's batch, over the traced
step's device time, in %.  The layer is timed from outside: its kernels
cannot be told from CDAN's convs by name."""


def read(ctx):
    tr, ms = ctx.get("trace"), ctx.get("perceptual_ms")
    if tr is None or not ms or tr.device_s <= 0:
        return None
    return 100.0 * ms * 1e-3 / (tr.device_s / tr.steps)
