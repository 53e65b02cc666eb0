"""dwconv_roofline: the bytes bound of the depthwise 3×3 convs the traced
windows ran (each call's input read once and its output written once in
bf16, plus its weights, at 3.35 TB/s) over their ``restormer/dwconv``
device time, in %.  A block's two calls: MDTA's 3C → 3C channels, GDFN's
2h → h with its gate (h = int(C · expansion)).  The calls are counted from
the ranges, a forward's in forward order; a program without the span (one
that runs no depthwise kernel of its own) reads None."""

from typing import Dict, List

from h100bench import flops, flops_restormer
from h100bench.metrics._spans import totals


def call_bytes(batch: int, h: int, w: int, args: Dict = None,
               io_bytes: int = 2) -> List[float]:
    """Bytes of each depthwise call of a forward of ``batch`` H×W images:
    MDTA's then GDFN's, block by block."""
    expansion = {**flops_restormer.DEFAULTS, **(args or {})}["ffn_expansion_factor"]
    out = []
    for c, _, px in flops_restormer.blocks(h, w, args):
        hidden = int(c * expansion)
        out.append((6 * batch * px * c + 9 * 3 * c) * io_bytes)
        out.append((3 * batch * px * hidden + 9 * 2 * hidden) * io_bytes)
    return out


def read(ctx):
    if ctx.get("kind") != "restormer_serve":
        return None
    got = totals(ctx)
    if not got or "restormer/dwconv" not in got:
        return None
    ranges, ms = got["restormer/dwconv"]
    work = call_bytes(ctx["batch"], ctx["height"], ctx["width"], ctx["network"])
    forwards, rest = divmod(ranges, len(work))
    if ms <= 0 or rest:
        return None
    return 100.0 * forwards * sum(work) / flops.HBM_BYTES_PER_S / (ms * 1e-3)
