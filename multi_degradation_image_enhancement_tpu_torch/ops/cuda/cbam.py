"""Fused CBAM (inference) with the decoder's product after it: CUDA kernel
(``csrc/cbam.cu``) and its plain PyTorch version.

    y = CBAM(x) · d        (CBAM(x) when d is None)

for NCHW ``x`` and ``d`` ``[B, C, H, W]``: the channel gate, a sigmoid over
the shared MLP (C → C/16 → C) applied to the H×W mean and to the H×W max and
summed; then the spatial gate, a sigmoid over the 7×7 conv (its BatchNorm
folded, ``models.cdan_fast.pack_cbam_cm``) of the ``[max_c, mean_c]`` map of
the gated x, zero-padded.  In f32 with f32 weights, rounded once into x's
dtype.  No TPU kernel corresponds: the JAX package's channel-major forward
leaves CBAM (``models/cdan_fast.py:127-159``) and the decoder's products by
d3 / d2 / d1 (``:353-367``) to XLA, which fuses them; this kernel is that
fusion on the card.

The wrapper (:func:`cbam_cm`) takes the plain version only for a tensor on
the CPU.  For a CUDA tensor it launches the kernel (four launches: pools,
gate, compress map, product) or raises; it never falls back to aten.  Its
tiles and the pool pass's H×W split follow the shape (:func:`cbam_plan`),
its 16-byte path needs ``W % 8 == 0`` and 16-byte aligned tensors, and a
scalar path takes every other size (:func:`vector_path`).  Outputs and
scratch come from ``torch.empty`` and nothing synchronises, so a CUDA graph
can capture the call.  ``cbam_cm.launches`` counts the calls that launched.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from multi_degradation_image_enhancement_tpu_torch.ops.cuda import _build
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import require_no_grad
from multi_degradation_image_enhancement_tpu_torch.utils.tracing import span

DTYPES = (torch.float32, torch.bfloat16)
GROUP = 8  # consecutive pixels a thread loads at once
TILE_PX = 256  # pixels of an apply tile


class CbamPlan(NamedTuple):
    """The kernel's shape-dependent parameters: ``splits`` chunks of H×W a
    plane in the pool pass, ``pg`` pixel groups of 8 a compress tile, ``tw``
    columns of an apply tile (``256 / tw`` rows), ``cs`` channel ranges an
    apply tile."""

    splits: int
    pg: int
    tw: int
    cs: int


@functools.lru_cache(maxsize=256)
def cbam_plan(b: int, c: int, h: int, w: int, sms: int = 132) -> CbamPlan:
    """One algorithm, its parameters from the shape and the card's ``sms``
    (132 on an H100), each the least cut that keeps the card busy, since
    every cut adds fixed work (NVIDIA H100 80GB HBM3 sweeps at the served
    shapes): the pool pass splits H×W until it has 12 warps an SM (more
    partials only slow the gate's combine) while a chunk keeps one
    256-pixel sweep of a warp; the compress tile is the largest of 256,
    128, 64 pixels that gives two blocks an SM; an apply tile splits its
    channels until there is a block an SM (each split recomputes the tile's
    spatial gate) while a thread keeps two channels."""
    hw = h * w
    splits = 1
    while b * c * splits < 12 * sms and -(-hw // (2 * splits)) >= 32 * GROUP:
        splits *= 2
    pg = next((p for p in (32, 16) if -(-hw // (p * GROUP)) * b >= 2 * sms), 8)
    tw = next(t for t in (64, 32, 16, 8) if (-(-w // GROUP) * GROUP) % t == 0)
    tiles = -(-w // tw) * -(-h // (TILE_PX // tw)) * b
    cs = 1
    while tiles * cs < sms and -(-c // (2 * cs)) >= 16:
        cs *= 2
    return CbamPlan(splits, pg, tw, cs)


def scratch_floats(b: int, c: int, h: int, w: int, splits: int) -> int:
    """f32 scratch of one call: partial sums and maxima (B·C·splits each),
    the gate (B·C) and the ``[max, mean]`` map (B·2·H·W)."""
    return 2 * b * c * splits + b * c + 2 * b * h * w


def cbam_cm_plain(x: torch.Tensor, pack: Dict[str, torch.Tensor],
                  d: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: the eager chain in f32 with f32 weights, times d, one
    rounding to x's dtype."""
    xf = x.float()
    w = {k: v.float() for k, v in pack.items()}

    def mlp(v):
        return F.linear(torch.relu(F.linear(v, w["w1"], w["b1"])), w["w2"], w["b2"])

    xg = xf * torch.sigmoid(mlp(xf.mean(dim=(2, 3))) + mlp(xf.amax(dim=(2, 3))))[:, :, None, None]
    comp = torch.cat([xg.amax(dim=1, keepdim=True), xg.mean(dim=1, keepdim=True)], dim=1)
    y = xg * torch.sigmoid(F.conv2d(comp, w["k7"], w["bsp"], padding=3))
    if d is not None:
        y = y * d.float()
    return y.to(x.dtype)


def vector_path(x: torch.Tensor, y: torch.Tensor, d: Optional[torch.Tensor] = None) -> bool:
    """Whether the kernel takes its 16-byte path: W a multiple of 8 and x, y
    (and d) 16-byte aligned; otherwise its scalar path."""
    ts = (x, y) if d is None else (x, y, d)
    return x.shape[-1] % GROUP == 0 and all(t.data_ptr() % 16 == 0 for t in ts)


def _check(x: torch.Tensor, pack: Dict[str, torch.Tensor], d: Optional[torch.Tensor]) -> None:
    if x.dtype not in DTYPES:
        raise ValueError(f"cbam_cm: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"cbam_cm: x {tuple(x.shape)} is not NCHW [B, C, H, W]")
    b, c, h, w = x.shape
    if min(b, c, h, w) <= 0:
        raise ValueError(f"cbam_cm: x {tuple(x.shape)} is empty")
    _build.require_batch(b, "cbam_cm")
    cr = pack["w1"].shape[0]
    want = {"w1": (cr, c), "b1": (cr,), "w2": (c, cr), "b2": (c,), "k7": (1, 2, 7, 7),
            "bsp": (1,)}
    for key, shape in want.items():
        t = pack[key]
        if tuple(t.shape) != shape:
            raise ValueError(f"cbam_cm: {key} {tuple(t.shape)} is not {shape}")
        if t.device != x.device:
            raise ValueError(f"cbam_cm: {key} on {t.device}, x on {x.device}")
    if d is not None:
        if d.dtype != x.dtype:
            raise ValueError(f"cbam_cm: d is {d.dtype}, x is {x.dtype}")
        if d.shape != x.shape:
            raise ValueError(f"cbam_cm: d {tuple(d.shape)} is not x's {tuple(x.shape)}")
        if d.device != x.device:
            raise ValueError(f"cbam_cm: d on {d.device}, x on {x.device}")


def cbam_cm(x: torch.Tensor, pack: Dict[str, torch.Tensor],
            d: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``CBAM(x) · d`` (or ``CBAM(x)``) in x's dtype from the folded pack of
    ``models.cdan_fast.pack_cbam_cm``.  CPU: the plain version; CUDA: four
    launches (contiguous x and d, f32 contiguous weights)."""
    with span("kernel/cbam"):
        require_no_grad("cbam_cm", [x] if d is None else [x, d])
        _check(x, pack, d)
        if x.device.type == "cpu":
            return cbam_cm_plain(x, pack, d)
        _build.require(x, "x", x.dtype)
        if d is not None:
            _build.require(d, "d", x.dtype)
        for key in ("w1", "b1", "w2", "b2", "k7", "bsp"):
            _build.require(pack[key], key, torch.float32)
        b, c, h, w = x.shape
        cr = pack["w1"].shape[0]
        plan = cbam_plan(b, c, h, w, _build.sm_count(x.device.index or 0))
        y = torch.empty_like(x)
        scratch = torch.empty(scratch_floats(b, c, h, w, plan.splits), dtype=torch.float32,
                              device=x.device)
        with _build.on_device(x):
            err = _build.load().mdie_cbam_cm(
                x.data_ptr(), None if d is None else d.data_ptr(), y.data_ptr(),
                *(pack[k].data_ptr() for k in ("w1", "b1", "w2", "b2", "k7", "bsp")),
                scratch.data_ptr(), int(x.dtype == torch.bfloat16), int(vector_path(x, y, d)),
                b, c, cr, h, w, *plan, _build.stream_of(x),
            )
        _build.check(err, "cbam_cm")
        cbam_cm.launches += 1
        return y


cbam_cm.launches = 0
