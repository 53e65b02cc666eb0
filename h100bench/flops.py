"""Operations and bytes of the work, from shapes alone: the yardstick of the
``*_mfu`` and ``*_roofline`` metrics.  It counts what the algorithm needs,
whatever implements it, so a later change to a kernel cannot move it.

FLOPs are 2 per multiply-add of the convs, deconvs and linears (elementwise
work is left out).  Bytes count each input read once and each output written
once.  Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit,
dense: 989 TFLOP/s bf16, 3.35 TB/s HBM3.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

PEAK_FLOPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
GROWTH, LAYERS = 16, 4


def bound(flops: float, nbytes: float, peak: str = "bf16") -> Tuple[float, str]:
    """(least seconds, what binds it): the larger of FLOPs over the peak for
    the operands' type and bytes over HBM's rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[peak], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _conv(c_in: int, c_out: int, k: int, pixels: int) -> float:
    return 2.0 * k * k * c_in * c_out * pixels


def dense_block_flops(c: int, pixels: int) -> float:
    growth = sum(_conv(c + GROWTH * i, GROWTH, 3, pixels) for i in range(LAYERS))
    return growth + _conv(c + GROWTH * LAYERS, c, 1, pixels)


def _cbam_flops(c: int, pixels: int) -> float:
    mlp = 2 * 2.0 * (c * (c // 16) * 2)  # avg and max vectors, two linears each
    return mlp + _conv(2, 1, 7, pixels)


def cdan_forward_flops(h: int, w: int) -> float:
    """One image's CDAN forward (growth 16, 4 layers, CBAM) at H×W: 16.570
    GFLOP at 256², 24.9 at 256×384, 77.7 at 480×640."""
    p1, p2, p4, p8 = h * w, h * w // 4, h * w // 16, h * w // 64
    f = _conv(3, 64, 3, p1) + _conv(64, 128, 3, p2) + _conv(128, 256, 3, p4) + _conv(256, 512, 3, p8)
    f += dense_block_flops(64, p2) + dense_block_flops(128, p4) + dense_block_flops(256, p8)
    f += _cbam_flops(512, p8)
    f += _conv(512, 256, 3, p8) + _cbam_flops(256, p8)
    f += _conv(256, 128, 3, p8) + _cbam_flops(128, p4)
    f += _conv(128, 64, 3, p4) + _cbam_flops(64, p2)
    f += _conv(64, 3, 3, p2) + dense_block_flops(3, p1)
    return f


VGG19_20_CONVS = ((3, 64, 0), (64, 64, 0), (64, 128, 1), (128, 128, 1), (128, 256, 2),
                  (256, 256, 2), (256, 256, 2), (256, 256, 2), (256, 512, 3))  # (c_in, c_out, pools)


def vgg19_20_flops(h: int, w: int) -> float:
    """One image through VGG19 ``features[:20]``: 47.4 GFLOP at 256×384."""
    return sum(_conv(ci, co, 3, (h >> n) * (w >> n)) for ci, co, n in VGG19_20_CONVS)


def _out(size: int, k: int, s: int, p: int) -> int:
    return (size + 2 * p - k) // s + 1


def alex_flops(h: int, w: int) -> float:
    """One image through LPIPS-alex's five convs (the taps' cost)."""
    h0, w0 = _out(h, 11, 4, 2), _out(w, 11, 4, 2)
    h1, w1 = _out(h0, 3, 2, 0), _out(w0, 3, 2, 0)
    h2, w2 = _out(h1, 3, 2, 0), _out(w1, 3, 2, 0)
    return (_conv(3, 64, 11, h0 * w0) + _conv(64, 192, 5, h1 * w1) + _conv(192, 384, 3, h2 * w2)
            + _conv(384, 256, 3, h2 * w2) + _conv(256, 256, 3, h2 * w2))


LOSS_NET_FLOPS = {"vgg_perceptual": vgg19_20_flops, "lpips": alex_flops}


def train_step_flops(batch: int, h: int, w: int, terms: Iterable[dict]) -> float:
    """One train step: CDAN forward + backward (3× the forward), and each
    frozen loss network's forward on the output and on the target and its
    backward to the output (the input gradient only: 1× its forward)."""
    per_image = 3.0 * cdan_forward_flops(h, w)
    per_image += sum(3.0 * LOSS_NET_FLOPS[t["name"]](h, w) for t in terms
                     if t["name"] in LOSS_NET_FLOPS)
    return batch * per_image


# ------------------------------------------------------ the hand kernels' work

def dense_block_shapes(batch: int, h: int, w: int) -> List[Tuple[int, int, int, int]]:
    """(batch, c_in, h, w) of CDAN's four DenseBlocks on H×W images."""
    return [(batch, 64, h // 2, w // 2), (batch, 128, h // 4, w // 4),
            (batch, 256, h // 8, w // 8), (batch, 3, h, w)]


def dense_block_work(shapes, io_bytes: int = 2) -> Tuple[float, float]:
    """FLOPs and bytes of inference DenseBlocks (growth 16, 4 layers):
    ``shapes`` = [(batch, c_in, h, w)], bf16 weights, x-dtype I/O."""
    flops = nbytes = 0
    for bsz, c, h, w in shapes:
        p = bsz * h * w
        cs = [c + 16 * i for i in range(4)]
        flops += sum(2 * p * 9 * ci * 16 for ci in cs) + 2 * p * (c + 64) * c
        nbytes += 2 * p * c * io_bytes + sum(16 * ci * 9 * 2 + ci * 8 + 64 for ci in cs)
        nbytes += (c + 64) * c * 2 + (c + 64) * 8 + c * 4
    return flops, nbytes


def cm_conv_shapes(batch: int, h: int, w: int) -> List[Tuple[int, int, int, int, int]]:
    """(batch, c_in, c_out, h, w) of the serving forward's seven 3×3 convs
    after conv1 (conv2–conv4, the four folded deconvs)."""
    return [(batch, 64, 128, h // 2, w // 2), (batch, 128, 256, h // 4, w // 4),
            (batch, 256, 512, h // 8, w // 8), (batch, 512, 256, h // 8, w // 8),
            (batch, 256, 128, h // 8, w // 8), (batch, 128, 64, h // 4, w // 4),
            (batch, 64, 3, h // 2, w // 2)]


def conv_work(shapes, pool: bool = False) -> Tuple[float, float]:
    """FLOPs and bytes of bf16 3×3 convs: ``shapes`` = [(batch, c_in, c_out,
    h, w)]; with ``pool`` the output is the 2×2 max-pooled one."""
    flops = nbytes = 0
    for bsz, ci, co, h, w in shapes:
        p = bsz * h * w
        flops += 2 * p * 9 * ci * co
        nbytes += p * ci * 2 + (p // 4 if pool else p) * co * 2 + co * ci * 9 * 2 + co * 4
    return flops, nbytes


def conv_cm_work(batch: int, h: int, w: int) -> Tuple[float, float]:
    """The CM forward's conv kernels: conv1 + BN + ReLU + pool (#9) and the
    seven convs (#8)."""
    f1, b1 = conv_work([(batch, 3, 64, h, w)], pool=True)
    f2, b2 = conv_work(cm_conv_shapes(batch, h, w))
    return f1 + f2, b1 + b2


def growth_train_work(batch: int, h: int, w: int, backward: bool) -> Tuple[float, float]:
    """FLOPs and bytes of the 16 growth layers of a train step on H×W images,
    f32 I/O, bf16 weights: the forward reads x, writes g; the backward reads
    x and the cotangent, writes dx, da, db, dw (twice the forward's FLOPs)."""
    flops = nbytes = 0
    for _, c_in, hh, ww in dense_block_shapes(batch, h, w):
        p = batch * hh * ww
        for i in range(4):
            c = c_in + 16 * i
            flops += 2 * p * 9 * c * 16 * (2 if backward else 1)
            params = 16 * c * 9 * 2 + 2 * c * 4
            nbytes += (p * c * 4 + p * 16 * 4 + p * c * 4 + 2 * c * 4 + 16 * c * 9 * 4 + params
                       if backward else p * c * 4 + p * 16 * 4 + params + 64)
    return flops, nbytes


def roofline_share(work: Tuple[float, float], seconds: float) -> float:
    """The bound of ``work`` over the measured seconds, in %."""
    return 100.0 * bound(*work)[0] / seconds

