"""Operations and bytes of Restormer's forward, from layer shapes alone: the
yardstick of ``restormer_mfu.serve`` and ``mdta_roofline``.

FLOPs are 2 per multiply-add of the convs (a depthwise conv's c_in per group
is 1) and of MDTA's two products, the c×c Gram q̂ k̂ᵀ and A v (per head, c =
C / heads): what ``torch.utils.flop_counter.FlopCounterMode`` counts over
the plain reference, 309.76 GFLOP an image at 256² and 1,452.02 at 480×640.
LayerNorms, norms, softmax, GELU, shuffles and adds are left out.

An MDTA half (``restormer/mdta``: LN1, MDTA, the residual add) needs, in
bf16, the block's input read twice (every pixel's q and k enter the Gram,
which must be complete before any pixel's A v), its output written once,
and its weights read once.  Peaks are ``flops``'s: 989 TFLOP/s bf16, 3.35
TB/s.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from h100bench import flops

DEFAULTS = {"dim": 48, "num_blocks": (4, 6, 6, 8), "num_refinement_blocks": 4,
            "heads": (1, 2, 4, 8), "ffn_expansion_factor": 2.66, "inp_channels": 3,
            "out_channels": 3}


def _args(args: Dict) -> Dict:
    return {**DEFAULTS, **{k: v for k, v in (args or {}).items() if k in DEFAULTS}}


def blocks(h: int, w: int, args: Dict = None) -> List[Tuple[int, int, int]]:
    """(channels, heads, pixels) of each transformer block of one H×W image,
    in forward order."""
    a = _args(args)
    d, nb, hd = a["dim"], a["num_blocks"], a["heads"]
    p = [h * w, h * w // 4, h * w // 16, h * w // 64]
    enc = [(d * 2 ** i, hd[i], p[i], nb[i]) for i in range(4)]
    dec = [(d * 4, hd[2], p[2], nb[2]), (d * 2, hd[1], p[1], nb[1]), (d * 2, hd[0], p[0], nb[0]),
           (d * 2, hd[0], p[0], a["num_refinement_blocks"])]
    return [(c, n_heads, px) for c, n_heads, px, n in enc + dec for _ in range(n)]


def mdta_flops(c: int, heads: int, pixels: int) -> float:
    """conv1x1 C→3C, the depthwise 3×3, the Gram and A v, conv1x1 C→C."""
    return 2.0 * pixels * (3 * c * c + 9 * 3 * c + 2 * c * (c // heads) + c * c)


def gdfn_flops(c: int, pixels: int, expansion: float) -> float:
    hidden = int(c * expansion)
    return 2.0 * pixels * (c * 2 * hidden + 9 * 2 * hidden + hidden * c)


def forward_flops(h: int, w: int, args: Dict = None) -> float:
    """One H×W image's forward: 309.76 GFLOP at 256², 1,452.02 at 480×640."""
    a = _args(args)
    d, p1 = a["dim"], h * w
    f = 2.0 * p1 * 9 * a["inp_channels"] * d + 2.0 * p1 * 9 * 2 * d * a["out_channels"]
    for i in range(3):  # down: conv3x3 C→C/2 at level i; up: conv3x3 C'→2C' at level i + 1
        c, p = d * 2 ** i, p1 // 4 ** i
        f += 2.0 * p * 9 * c * (c // 2) + 2.0 * (p // 4) * 9 * (2 * c) * (4 * c)
    f += 2.0 * (p1 // 16) * (8 * d) * (4 * d) + 2.0 * (p1 // 4) * (4 * d) * (2 * d)  # reduce_chan
    for c, n_heads, px in blocks(h, w, a):
        f += mdta_flops(c, n_heads, px) + gdfn_flops(c, px, a["ffn_expansion_factor"])
    return f


def mdta_work(batch: int, h: int, w: int, args: Dict = None,
              io_bytes: int = 2) -> List[Tuple[float, float]]:
    """(FLOPs, bytes) of each MDTA half of a forward of ``batch`` images."""
    out = []
    for c, n_heads, px in blocks(h, w, args):
        p = batch * px
        weights = (3 * c * c + 9 * 3 * c + c * c + c) * io_bytes + n_heads * 4
        out.append((batch * mdta_flops(c, n_heads, px), 3.0 * p * c * io_bytes + weights))
    return out


def least_seconds(work: Sequence[Tuple[float, float]]) -> float:
    """The sum of each part's bound: its operations at the bf16 peak or its
    bytes at HBM's rate, the larger."""
    return sum(flops.bound(f, b)[0] for f, b in work)
