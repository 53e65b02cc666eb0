"""Inference DenseBlock: CUDA kernels (``csrc/dense_block.cu``), the BN fold,
the parameter pack, and the plain PyTorch version.

Counterpart of ``multi_degradation_image_enhancement_tpu/ops/pallas/
dense_block_cm.py`` (``_kernel2`` via ``_run_cm2``, and the row-tiled
``_kernel`` via ``_run_cm``, whose NHWC entry is :func:`fused_dense_block_cm`)
and of ``ops/pallas/dense_block.py`` (``fold_bn``, and the row-major
``_kernel`` whose entry is :func:`fused_dense_block`).  NCHW in and out:
``[B, c_in, H, W]`` → ``[B, c_in, H, W]`` in x's dtype, with no channel
padding.

:func:`dense_block` takes the plain version only for a tensor on the CPU.  For
a CUDA tensor it launches ``num_layers`` growth kernels and one transition
kernel, or raises; ``dense_block.launches`` counts every launch.  It is
inference only: the kernels have no backward, so it raises when grad is
enabled and x or a pack tensor requires grad, on either device (the
trainable growth layer is ``ops.cuda.growth_train``).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List

import torch
import torch.nn.functional as F

from multi_degradation_image_enhancement_tpu_torch.ops.cuda import _build

BN_EPS = 1e-5


def fold_bn(scale, bias, mean, var, eps: float = BN_EPS):
    """Inference BatchNorm → per-channel affine ``(a, b)`` with ``a·x + b``."""
    a = scale / torch.sqrt(var + eps)
    return a, bias - mean * a


@dataclass
class DenseBlockPack:
    """A DenseBlock's folded parameters (f32) plus the kernels' bf16 weights.

    Layer ``i`` reads ``c_in + growth·i`` channels; ``w[i]`` is
    ``[growth, c_i, 3, 3]``; the transition ``wt`` is ``[c_out, c_total]``.
    """

    c_in: int
    growth: int
    a: List[torch.Tensor]
    b: List[torch.Tensor]
    w: List[torch.Tensor]
    bias: List[torch.Tensor]
    at: torch.Tensor
    bt: torch.Tensor
    wt: torch.Tensor
    biast: torch.Tensor
    w_bf16: List[torch.Tensor] = field(init=False)
    wt_bf16: torch.Tensor = field(init=False)

    def __post_init__(self):
        self.w_bf16 = [w.to(torch.bfloat16).contiguous() for w in self.w]
        self.wt_bf16 = self.wt.to(torch.bfloat16).contiguous()

    @property
    def num_layers(self) -> int:
        return len(self.w)

    @property
    def c_total(self) -> int:
        return self.c_in + self.growth * self.num_layers

    @property
    def c_out(self) -> int:
        return self.wt.shape[0]


@torch.no_grad()
def pack_dense_block(block, device=None) -> DenseBlockPack:
    """Fold a ``models.cdan.DenseBlock``'s BatchNorms (eval statistics) and
    collect its weights for the kernels."""

    def f32(t):
        return t.detach().to(device=device, dtype=torch.float32).contiguous()

    a, b, w, bias = [], [], [], []
    for layer in block.layers:
        bn, conv = layer[0], layer[2]
        ai, bi = fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
        a.append(f32(ai))
        b.append(f32(bi))
        w.append(f32(conv.weight))
        bias.append(f32(conv.bias))
    bn, conv = block.transition_layer[0], block.transition_layer[2]
    at, bt = fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
    return DenseBlockPack(
        c_in=block.in_channels,
        growth=block.growth_rate,
        a=a, b=b, w=w, bias=bias,
        at=f32(at), bt=f32(bt), wt=f32(conv.weight[:, :, 0, 0]), biast=f32(conv.bias),
    )


def require_no_grad(what: str, tensors) -> None:
    """Raise if autograd would record through an inference-only kernel."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} is inference only (its kernels have no backward): run it under "
            "torch.no_grad()/inference_mode(), or train through models.cdan.CDAN"
        )


def _pack_tensors(pack: DenseBlockPack):
    return [*pack.a, *pack.b, *pack.w, *pack.bias, pack.at, pack.bt, pack.wt, pack.biast]


def _activate(feats: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.relu(feats.float() * a[None, :, None, None] + b[None, :, None, None])


def dense_block_plain(x: torch.Tensor, pack: DenseBlockPack) -> torch.Tensor:
    """Plain PyTorch version, with the features held in x's dtype.

    For bf16 x it rounds where the kernel rounds (activated operand, weights,
    each ``g + bias``, the output); for f32 x it is the block in f32.  Convs
    accumulate in f32.  ``F.conv2d``'s zero padding pads the activated value,
    as the kernel's SAME padding does.
    """
    dt = x.dtype
    feats = x
    for a, b, w, bias in zip(pack.a, pack.b, pack.w, pack.bias):
        v = _activate(feats, a, b).to(dt).float()
        g = F.conv2d(v, w.to(dt).float(), bias, padding=1)
        feats = torch.cat([feats, g.to(dt)], dim=1)
    vt = _activate(feats, pack.at, pack.bt).to(dt).float()
    out = F.conv2d(vt, pack.wt.to(dt).float()[:, :, None, None], pack.biast)
    return out.to(dt)


def dense_block(x: torch.Tensor, pack: DenseBlockPack) -> torch.Tensor:
    """Inference DenseBlock, NCHW ``[B, c_in, H, W]`` → ``[B, c_out, H, W]``.

    On a CUDA tensor (f32 or bf16): one growth-layer launch per layer into a
    bf16 concat buffer, then the transition launch.  On the CPU: the plain
    version.  Raises when grad is enabled and x or the pack requires grad.
    """
    require_no_grad("dense_block", [x, *_pack_tensors(pack)])
    if x.device.type == "cpu":
        return dense_block_plain(x, pack)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dense_block: x must be float32 or bfloat16, got {x.dtype}")
    bsz, c_in, h, w = x.shape
    if c_in != pack.c_in:
        raise ValueError(f"dense_block: x has {c_in} channels, the pack expects {pack.c_in}")
    _build.require(x, "x", x.dtype)
    n_out_groups = -(-pack.growth // 16)  # the growth kernel's gridDim.z is batch x groups
    _build.require_batch(bsz * n_out_groups, "dense_block")
    for i in range(pack.num_layers):
        ci = c_in + pack.growth * i
        _build.require(pack.a[i], f"a{i}", torch.float32, (ci,))
        _build.require(pack.b[i], f"b{i}", torch.float32, (ci,))
        _build.require(pack.w_bf16[i], f"w{i}", torch.bfloat16, (pack.growth, ci, 3, 3))
        _build.require(pack.bias[i], f"bias{i}", torch.float32, (pack.growth,))
    c_tot, c_out = pack.c_total, pack.c_out
    _build.require(pack.at, "at", torch.float32, (c_tot,))
    _build.require(pack.bt, "bt", torch.float32, (c_tot,))
    _build.require(pack.wt_bf16, "wt", torch.bfloat16, (c_out, c_tot))
    _build.require(pack.biast, "biast", torch.float32, (c_out,))

    lib = _build.load()
    stream = _build.stream_of(x)
    feats = torch.empty((bsz, c_tot, h, w), dtype=torch.bfloat16, device=x.device)
    feats[:, :c_in].copy_(x)
    for i in range(pack.num_layers):
        err = lib.mdie_growth_layer(
            feats.data_ptr(), bsz, c_tot, h, w, c_in + pack.growth * i,
            pack.a[i].data_ptr(), pack.b[i].data_ptr(), pack.w_bf16[i].data_ptr(),
            pack.bias[i].data_ptr(), pack.growth, stream,
        )
        _build.check(err, f"dense_block growth layer {i}")
        dense_block.launches += 1
    out = torch.empty((bsz, c_out, h, w), dtype=x.dtype, device=x.device)
    err = lib.mdie_transition(
        feats.data_ptr(), bsz, c_tot, h * w, pack.at.data_ptr(), pack.bt.data_ptr(),
        pack.wt_bf16.data_ptr(), pack.biast.data_ptr(), c_out, out.data_ptr(),
        int(x.dtype == torch.bfloat16), stream,
    )
    _build.check(err, "dense_block transition")
    dense_block.launches += 1
    return out


dense_block.launches = 0


def fused_dense_block_cm(x_nhwc: torch.Tensor, block) -> torch.Tensor:
    """Inference DenseBlock from a ``models.cdan.DenseBlock`` module's eval
    statistics, NHWC ``[B, H, W, c_in]`` in and out.

    Counterpart of ``dense_block_cm.py:773`` ``fused_dense_block_cm``, the
    entry of the row-tiled TPU kernel (``_kernel``, ``_run_cm``).  Its row
    tiles with 5-row halos exist only because VMEM is 128 MiB; the growth and
    transition kernels here cover whole images at any size, so this is an
    entry point of :func:`dense_block` (launches counted there), not a second
    kernel.  ``_kernel`` rounds where ``_kernel2`` does, so the plain version
    is the same.
    """
    pack = pack_dense_block(block, x_nhwc.device)
    out = dense_block(x_nhwc.permute(0, 3, 1, 2).contiguous(), pack)
    return out.permute(0, 2, 3, 1)


def fold_dense_block(block, dtype: torch.dtype, device=None) -> DenseBlockPack:
    """:func:`pack_dense_block` with the folded affines (``a``, ``b``, ``at``,
    ``bt``) rounded to ``dtype``, as ``dense_block.py:289`` folds them in
    x's dtype; the conv biases stay f32 there too."""
    pack = pack_dense_block(block, device)

    def rnd(t):
        return t.to(dtype).float()

    return replace(pack, a=[rnd(t) for t in pack.a], b=[rnd(t) for t in pack.b],
                   at=rnd(pack.at), bt=rnd(pack.bt))


def fused_dense_block(x_nhwc: torch.Tensor, block) -> torch.Tensor:
    """Inference DenseBlock from a ``models.cdan.DenseBlock`` module's eval
    statistics, NHWC ``[B, H, W, c_in]`` → ``[B, H, W, c_in]`` in x's dtype
    (f32 or bf16).

    Counterpart of ``dense_block.py:276`` ``fused_dense_block``, the entry of
    the row-major TPU kernel #10 (``_kernel``, ``:56``).  Its math is that of
    ``_kernel2``: the input and every feature rounded to bf16 (even for f32
    x, ``:80``), bf16 weights into f32-accumulating dots (``:97``), each
    ``g + bias`` rounded to bf16 (``:132``), SAME padding of the activated
    value, the folded affine and the output in x's dtype.  The growth and
    transition kernels of :func:`dense_block` do exactly that, so this is an
    entry point (launches counted there, 5 a call), not a second kernel.
    What the TPU design adds answers VMEM and the matrix unit's lane width
    and has no counterpart here: the 4-row halos (``HALO``), the tile chooser
    (``_choose_tile``), the 128-lane channel padding (``_round128``,
    ``_pad_rows``) and the dx-tap packing (``pack_growth_kernel``).

    The plain version, taken on the CPU, is :func:`dense_block_plain` on the
    same fold; it keeps f32 features for f32 x, so it sits a bf16 rounding
    class away from the kernel and from JAX there.
    """
    pack = fold_dense_block(block, x_nhwc.dtype, x_nhwc.device)
    out = dense_block(x_nhwc.permute(0, 3, 1, 2).contiguous(), pack)
    return out.permute(0, 2, 3, 1)
