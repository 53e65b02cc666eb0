"""Trainable DenseBlock growth layer: CUDA forward and backward
(``csrc/growth_train.cu``) as a ``torch.autograd.Function``, and the plain
PyTorch version.

Counterpart of ``multi_degradation_image_enhancement_tpu/ops/pallas/
growth_train.py`` (``growth_layer_cm``, a ``jax.custom_vjp`` over the Pallas
forward and backward kernels).  One layer of a training DenseBlock:

    g = conv3x3_{c→16}(relu(x·a + b)) + bias        (SAME padding)

``a, b`` are the batch-statistics BatchNorm affine, computed outside with
autograd (``models.cdan``), so the layer only ever sees an affine.  NCHW:
``x [B, c, H, W]`` (f32 in training), ``a, b`` f32 ``[c]``, ``w [16, c, 3, 3]``
(torch's OIHW, no packing), ``bias [16]`` → ``g [B, 16, H, W]`` in x's dtype.
The backward returns ``dx, da, db, dw, dbias``.

Rounding points (those of the TPU kernels): the activated value and the
weights are bf16 matmul operands; the incoming gradient is rounded to bf16
before it meets them (the TPU kernel's ``dgs``); products accumulate in f32;
``dbias`` is a plain f32 sum of the unrounded gradient.

The kernels are implicit GEMMs on the tensor cores.  Their weights are packed
once per call, K-major with zeros past c: :func:`pack_fwd_weights` for the
forward (``[ceil(c/32), 9, 4, 16, 8]``: chunk of 32 channels, tap, channel
group, output, channel) and :func:`pack_dv_weights` for the backward's dv
(``[ceil(c/64), 9, 2, 64, 8]``: chunk of 64 channels, tap, output group,
channel, output; the taps flipped).

:func:`growth_layer` takes the plain version only for a tensor on the CPU.
For a CUDA tensor it launches the kernels or raises; ``growth_layer_fwd.
launches`` and ``growth_layer_bwd.launches`` count one per layer call (the
backward's call issues two kernels: dv, dx and the dW, da, db partials in one,
then a fixed-order sum of the partials).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from multi_degradation_image_enhancement_tpu_torch.ops.cuda import _build
from multi_degradation_image_enhancement_tpu_torch.parallel import collectives
from multi_degradation_image_enhancement_tpu_torch.utils.tracing import span

GROWTH = 16


# ----------------------------------------------------------------- plain


class _RoundBF16(torch.autograd.Function):
    """Forward: round to bf16 (kept in the input's dtype).  Backward: identity
    (the TPU kernel's backward passes straight through its bf16 operands)."""

    @staticmethod
    def forward(ctx, t):
        return t.to(torch.bfloat16).to(t.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _RoundGradBF16(torch.autograd.Function):
    """Forward: identity.  Backward: the incoming gradient rounded to bf16."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(torch.bfloat16).to(grad.dtype)


def growth_layer_plain(x, a, b, w, bias):
    """Plain PyTorch version: autograd over ``F.conv2d`` in f32, with operands
    rounded where the kernels round.  Any device; the CUDA path never falls
    back to it."""
    with torch.autocast(device_type=x.device.type, enabled=False):
        z = x.float() * a[None, :, None, None] + b[None, :, None, None]
        v = _RoundBF16.apply(torch.relu(z))
        conv = F.conv2d(v, _RoundBF16.apply(w.float()), padding=1)
        g = _RoundGradBF16.apply(conv) + bias.float()[None, :, None, None]
    return g.to(x.dtype)


# ------------------------------------------------------------------ kernels


def _check(x, a, b, w16, bias=None):
    bsz, c, h, w = x.shape
    _build.require(x, "x", torch.float32)
    _build.require_batch(bsz, "growth_layer")
    _build.require(a, "a", torch.float32, (c,))
    _build.require(b, "b", torch.float32, (c,))
    _build.require(w16, "w", torch.bfloat16, (GROWTH, c, 3, 3))
    if bias is not None:
        _build.require(bias, "bias", torch.float32, (GROWTH,))


FWD_CHUNK, DV_CHUNK = 32, 64  # channels of the kernels' K chunk (forward) and block (backward)


def _pad_channels(w, chunk):
    c = w.shape[1]
    return torch.nn.functional.pad(w, (0, 0, 0, 0, 0, -c % chunk))


def pack_fwd_weights(w):
    """OIHW ``w [16, c, 3, 3]`` → the forward kernel's ``[ceil(c/32), 9, 4,
    16, 8]``: element ``[k, 3ky+kx, g, o, i] = w[o, 32k + 8g + i, ky, kx]``,
    zeros past c."""
    wp = _pad_channels(w, FWD_CHUNK)
    n = wp.shape[1] // FWD_CHUNK
    return wp.reshape(GROWTH, n, FWD_CHUNK // 8, 8, 9).permute(1, 4, 2, 0, 3).contiguous()


def pack_dv_weights(w):
    """OIHW ``w [16, c, 3, 3]`` → the backward kernel's dv operand
    ``[ceil(c/64), 9, 2, 64, 8]``: element ``[k, 3ky+kx, g, j, i] =
    w[8g + i, 64k + j, 2-ky, 2-kx]`` (the transposed conv's flipped taps),
    zeros past c."""
    wp = _pad_channels(w.flip(2, 3), DV_CHUNK)
    n = wp.shape[1] // DV_CHUNK
    return wp.reshape(2, 8, n, DV_CHUNK, 9).permute(2, 4, 0, 3, 1).contiguous()


def growth_layer_fwd(x, a, b, w16, bias):
    """Forward kernel: ``g [B, 16, H, W]`` f32 from f32 ``x`` and bf16 OIHW ``w16``."""
    with span("kernel/growth_fwd"):
        _check(x, a, b, w16, bias)
        bsz, c, h, w = x.shape
        wk = pack_fwd_weights(w16)
        g = torch.empty((bsz, GROWTH, h, w), dtype=torch.float32, device=x.device)
        with _build.on_device(x):
            err = _build.load().mdie_growth_fwd(
                x.data_ptr(), bsz, c, h, w, a.data_ptr(), b.data_ptr(), wk.data_ptr(),
                bias.data_ptr(), g.data_ptr(), _build.stream_of(x),
            )
        _build.check(err, "growth_layer forward")
        growth_layer_fwd.launches += 1
        return g


growth_layer_fwd.launches = 0


def growth_layer_bwd(x, dg, a, b, w16):
    """Backward kernels: ``(dx, dw, da, db)``, all f32; ``dw`` is OIHW."""
    with span("kernel/growth_bwd"):
        _check(x, a, b, w16)
        bsz, c, h, w = x.shape
        _build.require(dg, "dg", torch.float32, (bsz, GROWTH, h, w))
        lib = _build.load()
        wdv = pack_dv_weights(w16)
        dx = torch.empty_like(x)
        dw = torch.empty((GROWTH, c, 3, 3), dtype=torch.float32, device=x.device)
        da = torch.empty((c,), dtype=torch.float32, device=x.device)
        db = torch.empty_like(da)
        scratch = torch.empty(
            (lib.mdie_growth_bwd_scratch(bsz, c, h, w),), dtype=torch.float32, device=x.device
        )
        with _build.on_device(x):
            err = lib.mdie_growth_bwd(
                x.data_ptr(), dg.data_ptr(), bsz, c, h, w, a.data_ptr(), b.data_ptr(),
                wdv.data_ptr(), dx.data_ptr(), dw.data_ptr(), da.data_ptr(), db.data_ptr(),
                scratch.data_ptr(), _build.stream_of(x),
            )
        _build.check(err, "growth_layer backward")
        growth_layer_bwd.launches += 1
        return dx, dw, da, db


growth_layer_bwd.launches = 0


class _GrowthLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, b, w, bias):
        x, a, b, bias = (t.contiguous() for t in (x, a, b, bias))
        w16 = w.detach().to(torch.bfloat16).contiguous()
        ctx.save_for_backward(x, a, b, w16)
        ctx.w_dtype = w.dtype
        return growth_layer_fwd(x, a, b, w16, bias)

    @staticmethod
    def backward(ctx, dg):
        x, a, b, w16 = ctx.saved_tensors
        dg = dg.contiguous()
        dx, dw, da, db = growth_layer_bwd(x, dg, a, b, w16)
        dbias = dg.sum(dim=(0, 2, 3))
        return dx, da, db, dw.to(ctx.w_dtype), dbias


def growth_layer(x, a, b, w, bias):
    """Trainable growth layer ``conv3x3_{c→16}(relu(x·a+b)) + bias``.

    On a CUDA tensor: the forward and backward kernels (f32 ``x``, ``a``,
    ``b``, ``bias``; ``w`` any float dtype, rounded to bf16).  On the CPU: the
    plain version."""
    if x.device.type == "cpu":
        return growth_layer_plain(x, a, b, w, bias)
    return _GrowthLayer.apply(x, a, b, w, bias)


def growth_layer_sharded(fn, x, a, b, w, bias):
    """The growth layer ``fn`` (:func:`growth_layer`, or a test's stand-in)
    on this rank's H shard of ``x`` under the active mesh's ``spatial`` axis.

    The layer pads the *activated* value ``relu(x·a + b)`` with zeros, so it
    takes one halo row of *raw* x from each neighbouring shard and none past
    the global image edges (a zero row of raw x would activate to
    ``relu(b)``, not 0): the kernels pad there as for a whole image.  The
    output rows of the halo are cropped.  The backward's dx over the halo
    rows goes back to their owners (``collectives.halo_h``); its da and db
    over them are partial sums that the gradient all-reduce completes with
    the owners' shares.  Without a spatial axis: ``fn(x, a, b, w, bias)``."""
    if collectives.spatial_shards() == 1:
        return fn(x, a, b, w, bias)
    h = x.shape[2]
    top, _ = collectives.halo_rows_added(1, h, "none")
    return fn(collectives.halo_h(x, 1, "none"), a, b, w, bias)[:, :, top:top + h]
