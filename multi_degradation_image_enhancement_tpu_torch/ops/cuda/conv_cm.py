"""CDAN's single 3×3 convolutions: CUDA kernels (``csrc/conv_cm.cu``), the
BN-folding pack, and the plain PyTorch versions.

Counterpart of ``multi_degradation_image_enhancement_tpu/ops/pallas/
conv_cm.py`` (``conv3x3_cm``, ``pack_conv``) and ``ops/pallas/conv_pool_cm.py``
(``conv3x3_pool_cm``, ``pack_conv_pool``).  Both take and return plain NCHW
(the port's channel-major layout), with no channel padding:

* :func:`conv3x3`: ``[B, c_in, H, W]`` → ``[B, c_out, H, W]``, 3×3 SAME conv
  + folded-BN bias, ReLU optional;
* :func:`conv3x3_pool`: ``[B, c_in, H, W]`` → ``[B, c_out, H/2, W/2]``, the
  same conv + bias + ReLU, then the 2×2 max-pool, in one pass (H, W even).

Rounding points, those of the TPU kernels: the input and the weights are
bf16 operands, products accumulate in f32, the f32 bias, ReLU and max run in
f32, and the result is rounded once to x's dtype (f32 or bf16).

Each wrapper takes the plain version only for a tensor on the CPU.  For a
CUDA tensor it launches its kernel or raises; ``conv3x3.launches`` and
``conv3x3_pool.launches`` count one per call that launches (a
:func:`conv3x3` call launches its NHWC pass and its GEMM).  Inference only: both raise
when grad is enabled and x or the pack requires grad.

:func:`conv3x3`'s kernel is an implicit GEMM on the tensor cores (K = 9 taps
× c_in): a first pass rounds x to bf16 into an NHWC scratch (channels padded
to 8), whose pixel rows TMA reads K-major at each tap's shift, and the
weights come K-major from ``ConvPack.w_packed``.  It takes every NCHW shape
:func:`launch_error` does not name.

:func:`conv3x3_pool`'s kernel is an im2col implicit GEMM on the tensor cores
over four polyphase fields (one per 2×2 window position), D[channel][pooled
pixel] = W · X with K = 9·c_in in the order ``k = 9c + 3ky + kx``
(:func:`pack_pool`, ``ConvPack.w_pool``), padded by :func:`pool_k_pad`; the
pool is an elementwise max of the four fields' f32 sums, then bias and ReLU
once.  A persistent walk over tiles of 128 pooled pixels (TR rows of TC,
:func:`pool_tiles`) covers the pooled map; it takes every shape
:func:`pool_launch_error` does not name.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from multi_degradation_image_enhancement_tpu_torch.ops.cuda import _build
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import (
    fold_bn,
    require_no_grad,
)
from multi_degradation_image_enhancement_tpu_torch.utils.tracing import span


K_CHUNK = 64  # input channels of one K step of #8 (c_in is padded to it)
POOL_K_CHUNK = 64  # im2col columns of one K chunk of #9
POOL_TILE = 128  # pooled pixels of one tile of #9: two consumer warpgroups of 64
C_OUT_ALIGN = 8  # wgmma's N granule (c_out is padded to it: de4's 3 -> 8)


@dataclass
class ConvPack:
    """A 3×3 conv with its BatchNorm folded in, as the kernels read it:
    ``w_bf16`` ``[c_out, c_in, 3, 3]`` (OIHW, bf16; #9 and the plain
    versions), ``w_packed`` ``[c_out_pad, 9, c_in_pad]`` (bf16, K-major: tap
    ``3·ky + kx``, then input channel; zeros in the padding; #8),
    ``w_pool`` ``[c_out_pad, k_pad]`` (bf16, K-major im2col rows, ``k = 9c
    + 3ky + kx``, zeros in the padding; #9) and ``bias`` f32 ``[c_out]``."""

    w_bf16: torch.Tensor
    bias: torch.Tensor
    w_packed: torch.Tensor
    w_pool: torch.Tensor

    @property
    def c_in(self) -> int:
        return self.w_bf16.shape[1]

    @property
    def c_out(self) -> int:
        return self.w_bf16.shape[0]


@torch.no_grad()
def pack_conv(weight: torch.Tensor, bias: torch.Tensor, bn=None, device=None) -> ConvPack:
    """Fold an inference BatchNorm (``bn``, optional: pass folded weights
    without it) into an OIHW 3×3 conv and cast to what the kernels read."""
    w, b = weight.detach().float(), bias.detach().float()
    if bn is not None:
        a, shift = fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
        w, b = w * a[:, None, None, None].float(), b * a.float() + shift.float()
    w_bf16 = w.to(device=device, dtype=torch.bfloat16).contiguous()
    return ConvPack(w_bf16=w_bf16, bias=b.to(device=device, dtype=torch.float32).contiguous(),
                    w_packed=pack_kmajor(w_bf16), w_pool=pack_pool(w_bf16))


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pack_kmajor(w_bf16: torch.Tensor) -> torch.Tensor:
    """OIHW ``[c_out, c_in, 3, 3]`` → ``[c_out_pad, 9, c_in_pad]``: row ``o``
    holds output channel ``o``'s 9 taps (``3·ky + kx``) of ``c_in_pad``
    input channels, c_out padded to :data:`C_OUT_ALIGN`, c_in to
    :data:`K_CHUNK`, zeros in the padding."""
    c_out, c_in = w_bf16.shape[:2]
    out = w_bf16.new_zeros((_round_up(c_out, C_OUT_ALIGN), 9, _round_up(c_in, K_CHUNK)))
    out[:c_out, :, :c_in] = w_bf16.permute(0, 2, 3, 1).reshape(c_out, 9, c_in)
    return out


def pool_k_pad(c_in: int) -> int:
    """#9's padded K: 32 (two k16 steps) when ``9·c_in`` fits, else a
    multiple of its 64-column K chunk."""
    return 32 if 9 * c_in <= 32 else _round_up(9 * c_in, POOL_K_CHUNK)


def pack_pool(w_bf16: torch.Tensor) -> torch.Tensor:
    """OIHW ``[c_out, c_in, 3, 3]`` → ``[c_out_pad, k_pad]``: row ``o`` is
    output channel ``o``'s im2col weights, ``k = 9c + 3ky + kx`` (the OIHW
    order flattened), c_out padded to :data:`C_OUT_ALIGN`, K to
    :func:`pool_k_pad`, zeros in the padding."""
    c_out, c_in = w_bf16.shape[:2]
    out = w_bf16.new_zeros((_round_up(c_out, C_OUT_ALIGN), pool_k_pad(c_in)))
    out[:c_out, :9 * c_in] = w_bf16.reshape(c_out, 9 * c_in)
    return out


def pool_tile_cols_log2(wp: int) -> int:
    """log2 of the pooled columns TC of #9's tile (TR = :data:`POOL_TILE` /
    TC rows): the width in 8..POOL_TILE that pads the pooled width ``wp``
    least, the widest on a tie."""
    widest = POOL_TILE.bit_length() - 1
    best, best_cols = widest, _round_up(wp, POOL_TILE)
    for l in range(widest - 1, 2, -1):
        cols = _round_up(wp, 1 << l)
        if cols < best_cols:
            best, best_cols = l, cols
    return best


def pool_tiles(bsz: int, hp: int, wp: int):
    """#9's persistent tile walk: ``(tiles, decode)`` where ``decode(t)`` is
    the (image, first pooled row, first pooled column) of tile ``t``, and
    pooled pixel ``m`` (0..127) of a tile sits at (row + m >> log2 TC, col +
    m & (TC − 1)); a block takes tiles ``i, i + grid, …``."""
    tc_log2 = pool_tile_cols_log2(wp)
    tc, tr = 1 << tc_log2, POOL_TILE >> tc_log2
    wb = -(-wp // tc)
    per_img = -(-hp // tr) * wb

    def decode(t: int):
        b, rem = divmod(t, per_img)
        return b, rem // wb * tr, rem % wb * tc

    return bsz * per_img, decode


def pool_launch_error(x_shape: Sequence[int], c_out: int) -> Optional[str]:
    """Why #9's kernel cannot take an NCHW x of ``x_shape`` with ``c_out``
    outputs, or None: an empty or non-4-D shape, odd H or W, or more tiles
    than its 32-bit walk counts.  Every c_in and c_out otherwise."""
    if len(x_shape) != 4 or min(x_shape) <= 0 or c_out <= 0:
        return f"x {tuple(x_shape)} with c_out {c_out} is not a non-empty NCHW conv"
    bsz, _, h, w = x_shape
    if h % 2 or w % 2:
        return f"H and W must be even, got {h}x{w}"
    if pool_tiles(bsz, h // 2, w // 2)[0] >= 2**31:
        return f"batch {bsz} of {h}x{w} images exceeds the 32-bit tile walk"
    return None


def launch_error(x_shape: Sequence[int], c_out: int) -> Optional[str]:
    """Why #8's kernel cannot take an NCHW x of ``x_shape`` with ``c_out``
    outputs, or None: an empty or non-4-D shape, a batch past the NHWC
    pass's grid (65535), or an image past its 32-bit pixel index."""
    if len(x_shape) != 4 or min(x_shape) <= 0 or c_out <= 0:
        return f"x {tuple(x_shape)} with c_out {c_out} is not a non-empty NCHW conv"
    bsz, _, h, w = x_shape
    if bsz > _build.MAX_GRID_YZ:
        return f"batch {bsz} outside 1..{_build.MAX_GRID_YZ}"
    if h * w >= 2**31:
        return f"a {h}x{w} image exceeds the kernel's 32-bit pixel index"
    return None


# The TPU kernel's pack reorders the taps for its column-polyphase stack
# (``conv_pool_cm.py:74-97``); the CUDA kernel reads the plain OIHW pack.
pack_conv_pool = pack_conv


def _conv_plain_f32(x: torch.Tensor, pack: ConvPack, relu: bool) -> torch.Tensor:
    y = F.conv2d(x.to(torch.bfloat16).float(), pack.w_bf16.float(), pack.bias, padding=1)
    return torch.relu(y) if relu else y


def conv3x3_plain(x: torch.Tensor, pack: ConvPack, relu: bool = True) -> torch.Tensor:
    """Plain version: ``F.conv2d`` in f32 on bf16-rounded operands, bias,
    optional ReLU, one rounding to x's dtype."""
    return _conv_plain_f32(x, pack, relu).to(x.dtype)


def conv3x3_pool_plain(x: torch.Tensor, pack: ConvPack) -> torch.Tensor:
    """Plain version: as :func:`conv3x3_plain` with ReLU, then
    ``F.max_pool2d`` in f32, one rounding to x's dtype."""
    return F.max_pool2d(_conv_plain_f32(x, pack, True), 2).to(x.dtype)


def _check(x: torch.Tensor, pack: ConvPack, name: str) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.shape[1] != pack.c_in:
        raise ValueError(f"{name}: x {tuple(x.shape)} is not [B, {pack.c_in}, H, W]")
    _build.require(x, "x", x.dtype)
    _build.require(pack.w_bf16, "w", torch.bfloat16, (pack.c_out, pack.c_in, 3, 3))
    _build.require(pack.bias, "bias", torch.float32, (pack.c_out,))


def conv3x3(x: torch.Tensor, pack: ConvPack, relu: bool = True) -> torch.Tensor:
    """3×3 SAME conv + bias (+ ReLU), NCHW ``[B, c_in, H, W]`` → ``[B, c_out,
    H, W]`` in x's dtype.  CPU: the plain version; CUDA: one kernel launch."""
    with span("kernel/conv3x3"):
        require_no_grad("conv3x3", [x, pack.w_bf16, pack.bias])
        if x.device.type == "cpu":
            return conv3x3_plain(x, pack, relu)
        _check(x, pack, "conv3x3")
        why = launch_error(x.shape, pack.c_out)
        if why:
            raise ValueError(f"conv3x3: {why}")
        c_out_pad, _, c_in_pad = pack.w_packed.shape
        _build.require(pack.w_packed, "w_packed", torch.bfloat16,
                       (_round_up(pack.c_out, C_OUT_ALIGN), 9, _round_up(pack.c_in, K_CHUNK)))
        bsz, c_in, h, w = x.shape
        xt = torch.empty((bsz, h, w, _round_up(c_in, 8)), dtype=torch.bfloat16, device=x.device)
        out = torch.empty((bsz, pack.c_out, h, w), dtype=x.dtype, device=x.device)
        with _build.on_device(x):
            err = _build.load().mdie_conv3x3(
                x.data_ptr(), int(x.dtype == torch.float32), bsz, c_in, h, w, xt.data_ptr(),
                pack.w_packed.data_ptr(), c_in_pad, c_out_pad, pack.bias.data_ptr(), pack.c_out,
                int(relu), out.data_ptr(), _build.stream_of(x),
            )
        _build.check(err, "conv3x3")
        conv3x3.launches += 1
        return out


def conv3x3_pool(x: torch.Tensor, pack: ConvPack) -> torch.Tensor:
    """3×3 SAME conv + bias + ReLU + 2×2 max-pool, NCHW ``[B, c_in, H, W]``
    (H, W even) → ``[B, c_out, H/2, W/2]`` in x's dtype.  CPU: the plain
    version; CUDA: one kernel launch."""
    with span("kernel/conv3x3_pool"):
        require_no_grad("conv3x3_pool", [x, pack.w_bf16, pack.bias])
        if x.device.type == "cpu":
            return conv3x3_pool_plain(x, pack)
        _check(x, pack, "conv3x3_pool")
        why = pool_launch_error(x.shape, pack.c_out)
        if why:
            raise ValueError(f"conv3x3_pool: {why}")
        if x.data_ptr() % 16:  # the kernel's copies of x need 16-byte aligned rows
            x = x.clone()
        bsz, c_in, h, w = x.shape
        c_out_pad, k_pad = _round_up(pack.c_out, C_OUT_ALIGN), pool_k_pad(c_in)
        _build.require(pack.w_pool, "w_pool", torch.bfloat16, (c_out_pad, k_pad))
        out = torch.empty((bsz, pack.c_out, h // 2, w // 2), dtype=x.dtype, device=x.device)
        with _build.on_device(x):
            err = _build.load().mdie_conv3x3_pool(
                x.data_ptr(), int(x.dtype == torch.bfloat16), bsz, c_in, h, w,
                pack.w_pool.data_ptr(), k_pad, c_out_pad, pack.bias.data_ptr(), pack.c_out,
                out.data_ptr(), pool_tile_cols_log2(w // 2), _build.stream_of(x),
            )
        _build.check(err, "conv3x3_pool")
        conv3x3_pool.launches += 1
        return out


conv3x3.launches = 0
conv3x3_pool.launches = 0
