"""Operations of the routed nine-expert pipeline, from shapes alone: the
yardstick of ``routed_mfu``.  2 FLOPs a multiply-add of the convs and
linears, elementwise work left out, as ``flops`` counts the CDAN."""

from __future__ import annotations

from h100bench import flops
from h100bench.flops import _out
from h100bench.reference.resnet import STAGES


def resnet18_flops(h: int, w: int, classes: int = 9, heads: int = 2) -> float:
    """One image through ResNet-18's features and ``heads`` linear heads of
    ``classes`` outputs: 3.63 GFLOP at 224² (torchvision's 1.81 GMAC
    without its fc), 7.11 at 256×384."""
    h, w = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    f = 2.0 * 7 * 7 * 3 * 64 * h * w
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    c_in = 64
    for c, stride in STAGES:
        h, w = _out(h, 3, stride, 1), _out(w, 3, stride, 1)
        f += 2.0 * 9 * c_in * c * h * w + 3 * (2.0 * 9 * c * c * h * w)
        if stride != 1 or c_in != c:
            f += 2.0 * c_in * c * h * w
        c_in = c
    return f + heads * 2.0 * 512 * classes


def routed_batch_flops(batch: int, h: int, w: int, rows_restored: float) -> float:
    """A batch: the classifier over every row, a CDAN forward for each
    row an expert restores."""
    return batch * resnet18_flops(h, w) + rows_restored * flops.cdan_forward_flops(h, w)
