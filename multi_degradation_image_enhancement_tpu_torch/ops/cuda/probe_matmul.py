"""The batched GEMM of the int8 / bf16 throughput probe: the CUDA kernel
(``csrc/probe_matmul.cu``) and its plain PyTorch version.

Counterpart of ``benchmarks/exp_int8_reprobe.py`` ``_mm_kernel`` (TPU kernel
#11): ``o[i] = a[i] @ b[i]`` with ``a`` ``[batch, M, K]`` and ``b`` ``[batch,
K, N]``, in one of the probe's two type sets:

* bf16 operands, f32 accumulation, bf16 out (one rounding);
* int8 operands, i32 accumulation, i32 out (exact).

:func:`probe_matmul` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises; ``probe_matmul.launches``
counts one per call.  What the kernel takes is :func:`launch_error`'s:
bf16 (wgmma fed by TMA) any M and K and N multiples of 8, the TMA maps'
16-byte row strides; int8 M and N multiples of 128, K of 32, at most 65535
batch entries.  The int8 call is two launches: a pass that turns b into a
K-major int8 scratch (:func:`kmajor_b` is its plain counterpart), since
8-bit ``wgmma`` reads both operands K-major only, then a persistent TMA-fed
``wgmma`` GEMM over 128×128 tiles, K steps of 128, 32 a product.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from multi_degradation_image_enhancement_tpu_torch.ops.cuda import _build

OUT_DTYPE = {torch.bfloat16: torch.bfloat16, torch.int8: torch.int32}
INT8_TILE = 128  # the int8 GEMM's output tile (M and N) and K step (128 bytes, one TMA box row)
INT8_MMA_K = 32  # K of one 8-bit wgmma
_INT8_K = 32  # K granule of the transpose pass's tiles


@contextlib.contextmanager
def full_f32_matmul():
    """Matmuls in full f32 (TF32 off) for the block, the caller's setting after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype not in OUT_DTYPE or b.dtype != a.dtype:
        raise ValueError(f"probe_matmul: a and b must both be bfloat16 or int8, got {a.dtype}, {b.dtype}")
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] or a.shape[2] != b.shape[1]:
        raise ValueError(f"probe_matmul: shapes {tuple(a.shape)} @ {tuple(b.shape)} are not "
                         "[batch, M, K] @ [batch, K, N]")


def probe_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: ``torch.bmm`` on f32 copies with TF32 off, cast to the
    output type.  For int8 it is exact while every partial sum stays below
    2**24, i.e. K <= 1024 (the probe's K=512 sums at most 2**23)."""
    _check(a, b)
    with full_f32_matmul():
        return torch.bmm(a.float(), b.float()).to(OUT_DTYPE[a.dtype])


def kmajor_b(b: torch.Tensor) -> torch.Tensor:
    """Plain counterpart of the int8 kernel's first pass: ``b`` ``[batch, K,
    N]`` as ``[batch, N, K]``, contiguous (K-major, as 8-bit ``wgmma`` reads
    its B operand)."""
    return b.transpose(1, 2).contiguous()


def launch_error(dtype: torch.dtype, batch: int, m: int, k: int, n: int) -> Optional[str]:
    """Why the kernel cannot take ``[batch, m, k] @ [batch, k, n]`` of
    ``dtype``, or None.  bf16: rows of a, b and o are TMA strides, so K and N
    are multiples of 8 (16 bytes); int8: the tile grid's multiples."""
    if min(batch, m, k, n) <= 0:
        return f"empty shape batch={batch} M={m} K={k} N={n}"
    if dtype == torch.bfloat16:
        if k % 8 or n % 8:
            return f"bf16 K={k} and N={n} must be multiples of 8 (16-byte TMA row strides)"
        return None
    if m % INT8_TILE or n % INT8_TILE or k % _INT8_K:
        return (f"int8 M={m} and N={n} must be multiples of {INT8_TILE}, K={k} of {_INT8_K}")
    if batch > _build.MAX_GRID_YZ:
        return f"int8 batch {batch} outside 1..{_build.MAX_GRID_YZ}"
    return None


def probe_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``o[i] = a[i] @ b[i]``: bf16 → bf16 (f32 accumulation) or int8 → int32.
    CPU: the plain version; CUDA: the kernel (bf16 one launch, int8 two: the
    K-major pass of b, then the GEMM)."""
    _check(a, b)
    if a.device.type == "cpu":
        return probe_matmul_plain(a, b)
    bsz, m, k = a.shape
    n = b.shape[2]
    why = launch_error(a.dtype, bsz, m, k, n)
    if why:
        raise ValueError(f"probe_matmul: {why}")
    for name, t in (("a", a), ("b", b)):
        _build.require(t, name, a.dtype)
        if t.data_ptr() % 16:
            raise ValueError(f"probe_matmul: {name} must be 16-byte aligned")
    out = torch.empty((bsz, m, n), dtype=OUT_DTYPE[a.dtype], device=a.device)
    int8 = a.dtype == torch.int8
    bt = torch.empty((bsz, n, k) if int8 else (0,), dtype=torch.int8, device=a.device)
    with _build.on_device(a):
        err = _build.load().mdie_probe_matmul(
            a.data_ptr(), b.data_ptr(), int(int8), bsz, m, k, n, out.data_ptr(), bt.data_ptr(),
            _build.stream_of(a),
        )
    _build.check(err, "probe_matmul")
    probe_matmul.launches += 1
    return out


probe_matmul.launches = 0
