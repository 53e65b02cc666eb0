"""glue_share.serve: the served forward's device time outside the hand
kernels (upsample, CBAM, pools, elementwise, copies) over all its device
time, in %."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.device_s <= 0:
        return None
    return 100.0 * (tr.device_s - tr.hand_s()) / tr.device_s
