"""The in-kernel transpose probes: CUDA kernels (``csrc/probe_transpose.cu``)
and their plain PyTorch versions, all bf16.

Counterparts of the three kernels of ``benchmarks/exp_io_transpose.py``
(TPU kernels #12–#14):

* :func:`m_dot_xt` (``kernel_rhsT``): ``o[b] = M · x[b]ᵀ``, ``x`` ``[B, P,
  64]``, ``M`` ``[64, 64]`` → ``[B, 64, P]``;
* :func:`xt_dot_m` (``kernel_lhsT``): ``o[b] = x[b]ᵀ · M``, ``x`` ``[B, 64,
  P]`` → ``[B, P, 64]``;
* :func:`transpose` (``kernel_jnpT``): ``o[b] = x[b]ᵀ``, ``[B, P, C]`` →
  ``[B, C, P]``.

The products accumulate in f32 and round once to bf16, for any ``M``; with
``M = I``, what the probe feeds, they are transposes, exactly.  Each wrapper
takes its plain version only for tensors on the CPU; for any other tensor it
launches its kernel or raises, and its ``launches`` counts one per launch.
What the products' kernels (persistent, TMA in and out, ``wgmma``) take is
:func:`product_launch_error`'s: any batch and any P that is a multiple of 8;
the transpose takes P and C even.
"""

from __future__ import annotations

from typing import Optional

import torch

from multi_degradation_image_enhancement_tpu_torch.ops.cuda import _build
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.probe_matmul import full_f32_matmul

K = 64  # the products' contraction (the probe's C) and M's other side


def _check_products(x: torch.Tensor, m: torch.Tensor, k_axis: int, name: str) -> None:
    if x.dtype != torch.bfloat16 or m.dtype != torch.bfloat16:
        raise ValueError(f"{name}: x and M must be bfloat16, got {x.dtype}, {m.dtype}")
    if x.dim() != 3 or x.shape[k_axis] != K or tuple(m.shape) != (K, K):
        raise ValueError(f"{name}: x {tuple(x.shape)} and M {tuple(m.shape)} do not fit "
                         f"(axis {k_axis} of x and both sides of M must be {K})")


def product_launch_error(batch: int, p: int) -> Optional[str]:
    """Why the product kernels (#12, #13) cannot take ``batch`` images of
    ``p`` pixels (C = 64), or None.  The rows of x or o that run along P are
    TMA strides, so P is a multiple of 8 (16 bytes); a ragged last tile reads
    zeros and clips its store.  The persistent grid walks the (image, tile)
    space, so the batch has no cap of its own."""
    if batch <= 0 or p <= 0:
        return f"empty shape batch={batch} P={p}"
    if p % 8:
        return f"P={p} must be a multiple of 8 (16-byte TMA row strides)"
    return None


def _launch_product(fn_name: str, x: torch.Tensor, m: torch.Tensor, p: int, out_shape, name: str):
    why = product_launch_error(x.shape[0], p)
    if why:
        raise ValueError(f"{name}: {why}")
    for label, t in (("x", x), ("M", m)):
        _build.require(t, label, torch.bfloat16)
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be 16-byte aligned")
    out = torch.empty(out_shape, dtype=torch.bfloat16, device=x.device)
    with _build.on_device(x):
        err = getattr(_build.load(), fn_name)(
            x.data_ptr(), m.data_ptr(), x.shape[0], p, out.data_ptr(), _build.stream_of(x))
    _build.check(err, name)
    return out


def m_dot_xt_plain(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Plain version: f32 ``torch.matmul`` (TF32 off), one rounding to bf16."""
    _check_products(x, m, 2, "m_dot_xt")
    with full_f32_matmul():
        return torch.matmul(m.float(), x.float().transpose(1, 2)).to(torch.bfloat16)


def m_dot_xt(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``o[b] = M · x[b]ᵀ``, ``[B, P, 64]`` → ``[B, 64, P]`` bf16.  CPU: the
    plain version; CUDA: one kernel launch."""
    _check_products(x, m, 2, "m_dot_xt")
    if x.device.type == "cpu":
        return m_dot_xt_plain(x, m)
    bsz, p, _ = x.shape
    out = _launch_product("mdie_probe_rhsT", x, m, p, (bsz, K, p), "m_dot_xt")
    m_dot_xt.launches += 1
    return out


def xt_dot_m_plain(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Plain version: f32 ``torch.matmul`` (TF32 off), one rounding to bf16."""
    _check_products(x, m, 1, "xt_dot_m")
    with full_f32_matmul():
        return torch.matmul(x.float().transpose(1, 2), m.float()).to(torch.bfloat16)


def xt_dot_m(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``o[b] = x[b]ᵀ · M``, ``[B, 64, P]`` → ``[B, P, 64]`` bf16.  CPU: the
    plain version; CUDA: one kernel launch."""
    _check_products(x, m, 1, "xt_dot_m")
    if x.device.type == "cpu":
        return xt_dot_m_plain(x, m)
    bsz, _, p = x.shape
    out = _launch_product("mdie_probe_lhsT", x, m, p, (bsz, p, K), "xt_dot_m")
    xt_dot_m.launches += 1
    return out


def transpose_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version: ``x.transpose(1, 2).contiguous()``."""
    return x.transpose(1, 2).contiguous()


def transpose(x: torch.Tensor) -> torch.Tensor:
    """``o[b] = x[b]ᵀ``, ``[B, P, C]`` → ``[B, C, P]`` bf16.  CPU: the plain
    version; CUDA: one kernel launch."""
    if x.dtype != torch.bfloat16 or x.dim() != 3:
        raise ValueError(f"transpose: x must be a bfloat16 [B, P, C], got {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return transpose_plain(x)
    bsz, p, c = x.shape
    if p % 2 or c % 2:
        raise ValueError(f"transpose: P={p} and C={c} must be even")
    _build.require(x, "x", torch.bfloat16)
    if x.data_ptr() % 4:
        raise ValueError("transpose: x must be 4-byte aligned (bf16 pairs)")
    _build.require_batch(bsz, "transpose")
    out = torch.empty((bsz, c, p), dtype=torch.bfloat16, device=x.device)
    with _build.on_device(x):
        err = _build.load().mdie_probe_transpose(x.data_ptr(), bsz, p, c, out.data_ptr(),
                                                 _build.stream_of(x))
    _build.check(err, "transpose")
    transpose.launches += 1
    return out


m_dot_xt.launches = 0
xt_dot_m.launches = 0
transpose.launches = 0
