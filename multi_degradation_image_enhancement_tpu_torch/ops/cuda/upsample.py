"""Fused bilinear ×2 upsample + add: CUDA kernel (``csrc/upsample.cu``) and
its plain PyTorch version.

    y = bilinear_x2(x) + r

for NCHW ``x`` ``[B, C, H, W]`` and ``r`` ``[B, C, 2H, 2W]``: the half-pixel
×2 bilinear upsample (``F.interpolate(scale_factor=2, mode="bilinear",
align_corners=False)``, as ``jax.image.resize`` computes it) plus the skip or
residual the decoder adds after it, in f32, rounded once into x's dtype.  No
TPU kernel corresponds: the JAX package leaves the resize and the add to XLA,
which fuses them, and this kernel is that fusion on the card.

The wrapper (:func:`bilinear_x2_add`) takes the plain version only for a
tensor on the CPU.  For a CUDA tensor it launches the kernel or raises; it
never falls back to aten.  The kernel's vector path (8 output columns a
thread) needs ``W % 4 == 0`` and 16-byte aligned tensors, its scalar path
takes every other size (:func:`vector_path`).  ``bilinear_x2_add.launches``
counts the launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from multi_degradation_image_enhancement_tpu_torch.ops.cuda import _build
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import require_no_grad
from multi_degradation_image_enhancement_tpu_torch.utils.tracing import span

DTYPES = (torch.float32, torch.bfloat16)


def bilinear_x2_add_plain(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Plain version: ``F.interpolate`` in f32, plus r, one rounding to x's dtype."""
    up = F.interpolate(x.float(), scale_factor=2, mode="bilinear", align_corners=False)
    return (up + r.float()).to(x.dtype)


def vector_path(x: torch.Tensor, r: torch.Tensor, y: torch.Tensor) -> bool:
    """Whether the kernel takes its vector path: W a multiple of 4 (so each
    output row is whole 16-byte groups of 8 columns) and every tensor 16-byte
    aligned; otherwise its scalar path."""
    return x.shape[-1] % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, r, y))


def _check(x: torch.Tensor, r: torch.Tensor) -> None:
    if x.dtype not in DTYPES:
        raise ValueError(f"bilinear_x2_add: x must be float32 or bfloat16, got {x.dtype}")
    if r.dtype != x.dtype:
        raise ValueError(f"bilinear_x2_add: r is {r.dtype}, x is {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"bilinear_x2_add: x {tuple(x.shape)} is not NCHW [B, C, H, W]")
    b, c, h, w = x.shape
    if tuple(r.shape) != (b, c, 2 * h, 2 * w):
        raise ValueError(f"bilinear_x2_add: r {tuple(r.shape)} is not [{b}, {c}, {2 * h}, {2 * w}]")
    if r.device != x.device:
        raise ValueError(f"bilinear_x2_add: r on {r.device}, x on {x.device}")


def bilinear_x2_add(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``bilinear_x2(x) + r`` in one pass, in x's dtype.  CPU: the plain
    version; CUDA: one kernel launch (contiguous x and r)."""
    with span("kernel/bilinear_x2_add"):
        require_no_grad("bilinear_x2_add", [x, r])
        _check(x, r)
        if x.device.type == "cpu":
            return bilinear_x2_add_plain(x, r)
        _build.require(x, "x", x.dtype)
        _build.require(r, "r", x.dtype)
        b, c, h, w = x.shape
        y = torch.empty_like(r)
        with _build.on_device(x):
            err = _build.load().mdie_bilinear_x2_add(
                x.data_ptr(), r.data_ptr(), y.data_ptr(), int(x.dtype == torch.bfloat16),
                int(vector_path(x, r, y)), b * c, h, w, _build.stream_of(x),
            )
        _build.check(err, "bilinear_x2_add")
        bilinear_x2_add.launches += 1
        return y


bilinear_x2_add.launches = 0
