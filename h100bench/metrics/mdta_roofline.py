"""mdta_roofline: the bound of the MDTA halves the traced windows ran (each
half's operations at 989 TFLOP/s or its bytes at 3.35 TB/s, the larger:
``flops_restormer.mdta_work``) over their ``restormer/mdta`` device time, in
%.  The halves are counted from the ranges, a forward's in forward order."""

from h100bench import flops_restormer
from h100bench.metrics._spans import totals


def read(ctx):
    if ctx.get("kind") != "restormer_serve":
        return None
    got = totals(ctx)
    if not got or "restormer/mdta" not in got:
        return None
    ranges, ms = got["restormer/mdta"]
    work = flops_restormer.mdta_work(ctx["batch"], ctx["height"], ctx["width"], ctx["network"])
    forwards, rest = divmod(ranges, len(work))
    if ms <= 0 or rest:
        return None
    return 100.0 * forwards * flops_restormer.least_seconds(work) / (ms * 1e-3)
