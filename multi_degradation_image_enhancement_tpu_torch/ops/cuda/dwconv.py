"""Depthwise 3×3 convolution, plain or with GDFN's gate: CUDA kernel
(``csrc/dwconv.cu``) and its plain PyTorch version.

    depthwise3x3(x, w, b)          y = dw3x3(x)                  x, y [B, C, H, W]
    depthwise3x3_gated(x, w, b)    a, g = chunk2(dw3x3(x))
                                   y = gelu(a) · g               x [B, 2C, H, W], y [B, C, H, W]

where ``dw3x3`` is ``F.conv2d(x, w, b, padding=1, groups=x.shape[1])``:
weights ``w`` [C_in, 1, 3, 3], one 3×3 a channel, an optional bias [C_in],
zero padding.  They are Restormer's depthwise convs (``models/restormer.py``):
MDTA's over q, k, v takes the plain epilogue, GDFN's the gated one, with the
exact (erf) GELU.  Sums and the gate in f32, rounded once into x's dtype.  No
TPU kernel corresponds: the JAX package has no Restormer.

The entry points take the plain version only for a tensor on the CPU.  For
a CUDA tensor they launch the kernel or raise; they never fall back to aten.
The kernel's band height follows the shape (:func:`dwconv_plan`); its
16-byte path needs ``W % 8 == 0`` and 16-byte aligned x and y, a scalar path
takes every other size (:func:`vector_path`).  Outputs come from
``torch.empty`` and nothing synchronises.  The module's ``launches`` counts
the launches of both entry points, ``gated_launches`` those of the gated one.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from multi_degradation_image_enhancement_tpu_torch.ops.cuda import _build
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import require_no_grad

DTYPES = (torch.float32, torch.bfloat16)
GROUP = 8  # consecutive columns a thread of the 16-byte path owns
HALO_SHARE = 0.06  # of a plane's rows that bands may read twice
WAVES = 4  # threads to aim for: this many times the card's resident thread slots
THREAD_SLOTS = 2048  # resident threads an SM

launches = 0
gated_launches = 0


class DwconvPlan(NamedTuple):
    """The kernel's shape-dependent parameters: a thread walks ``rows`` rows
    of its plane, which is cut into ``bands`` such bands."""

    rows: int
    bands: int


@functools.lru_cache(maxsize=256)
def dwconv_plan(b: int, c: int, h: int, w: int, sms: int = 132) -> DwconvPlan:
    """Bands of a B·C-plane output (C: the output's channels) on a card of
    ``sms`` SMs (132 on an H100).  A band reads the rows beside it again,
    2·(bands − 1) rows a plane, so the bands are at most those that keep
    that within ``HALO_SHARE`` of the plane's rows; within that, the fewest
    that give ``WAVES`` × the card's resident thread slots, one thread a
    band's 8 columns.  At the served B=4 shapes: 15 bands of 32 rows at
    480×640 and 127–144 channels, 12–14 bands there at 255–288 channels (the
    thread target decides), and the halo's cap below: 8 of 30 rows at 240, 4
    of 30 at 120, 2 of 30 at 60, where a block of 256 threads packs 12–13
    planes and the card gets only ~2.5 blocks an SM."""
    most = 1 + int(HALO_SHARE / 2 * h)
    per_band = b * c * -(-w // GROUP)
    want = -(-WAVES * sms * THREAD_SLOTS // per_band)
    rows = -(-h // max(1, min(most, want)))
    return DwconvPlan(rows, -(-h // rows))


def depthwise3x3_plain(x: torch.Tensor, w: torch.Tensor,
                       b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: ``F.conv2d`` in f32, one rounding to x's dtype."""
    return _conv_f32(x, w, b).to(x.dtype)


def depthwise3x3_gated_plain(x: torch.Tensor, w: torch.Tensor,
                             b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: ``F.conv2d`` in f32, then ``gelu(a) · g`` in f32 over
    its two halves, one rounding to x's dtype."""
    a, g = _conv_f32(x, w, b).chunk(2, dim=1)
    return (F.gelu(a) * g).to(x.dtype)


def _conv_f32(x, w, b):
    return F.conv2d(x.float(), w.float(), None if b is None else b.float(), padding=1,
                    groups=x.shape[1])


def vector_path(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Whether the kernel takes its 16-byte path: W a multiple of 8 and x, y
    16-byte aligned; otherwise its scalar path."""
    return x.shape[-1] % GROUP == 0 and x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0


def _check(what: str, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           gated: bool) -> None:
    if x.dtype not in DTYPES:
        raise ValueError(f"{what}: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{what}: x {tuple(x.shape)} is not NCHW [B, C, H, W]")
    if min(x.shape) <= 0:
        raise ValueError(f"{what}: x {tuple(x.shape)} is empty")
    c = x.shape[1]
    if gated and c % 2:
        raise ValueError(f"{what}: x has {c} channels, not the two halves a and g")
    for name, t, shape in (("w", w, (c, 1, 3, 3)), ("b", b, (c,))):
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} is not {shape}")
        if t.dtype != x.dtype:
            raise ValueError(f"{what}: {name} is {t.dtype}, x is {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, x on {x.device}")


def _dwconv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
            gated: bool) -> torch.Tensor:
    global launches, gated_launches
    what = "depthwise3x3_gated" if gated else "depthwise3x3"
    require_no_grad(what, [x])
    _check(what, x, w, b, gated)
    if x.device.type == "cpu":
        return (depthwise3x3_gated_plain if gated else depthwise3x3_plain)(x, w, b)
    _build.require(x, "x", x.dtype)
    _build.require(w, "w", x.dtype)
    if b is not None:
        _build.require(b, "b", x.dtype)
    n, c, h, wd = x.shape
    c_out = c // 2 if gated else c
    y = torch.empty((n, c_out, h, wd), dtype=x.dtype, device=x.device)
    plan = dwconv_plan(n, c_out, h, wd, _build.sm_count(x.device.index or 0))
    with _build.on_device(x):
        err = _build.load().mdie_dwconv3x3(
            x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
            int(x.dtype == torch.bfloat16), int(gated), int(vector_path(x, y)), n, c_out, h,
            wd, plan.rows, _build.stream_of(x),
        )
    _build.check(err, what)
    launches += 1
    gated_launches += gated
    return y


def depthwise3x3(x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The depthwise 3×3 conv of NCHW ``x`` (zero padding 1), in x's dtype.
    CPU: the plain version; CUDA: one launch (contiguous x, w and b in x's
    dtype)."""
    return _dwconv(x, w, b, False)


def depthwise3x3_gated(x: torch.Tensor, w: torch.Tensor,
                       b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``gelu(a) · g`` of the depthwise 3×3 conv's halves ``a, g`` of NCHW
    ``x`` [B, 2C, H, W], [B, C, H, W] in x's dtype.  CPU: the plain version;
    CUDA: one launch."""
    return _dwconv(x, w, b, True)
