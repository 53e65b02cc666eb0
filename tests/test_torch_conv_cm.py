"""PyTorch port: the conv kernels' plain versions (ops/cuda/conv_cm.py) vs the
JAX package's TPU kernels run in interpret mode, at the shapes of
tests/test_pallas_kernels.py: #8 ``conv3x3_cm`` and #9 ``conv3x3_pool_cm``
(the latter on its column-deinterleaved, 8-channel-padded operand).

On the CPU the wrappers run their plain versions; the CUDA kernels are held
to those plain versions on the card by ``chip_smoke.py``.  What the CPU can
reach of #8's tensor-core kernel is tested here: its K-major weight pack,
its implicit-GEMM index algebra (a tap-by-tap model over the pack) and the
launch predicate that names the shapes it does not take.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from multi_degradation_image_enhancement_tpu.models.cdan_fast import _fold_conv_bn
from multi_degradation_image_enhancement_tpu.ops.pallas.conv_cm import conv3x3_cm
from multi_degradation_image_enhancement_tpu.ops.pallas.conv_cm import pack_conv as jax_pack_conv
from multi_degradation_image_enhancement_tpu.ops.pallas.conv_pool_cm import (
    conv3x3_pool_cm,
    deinterleave_cols,
)
from multi_degradation_image_enhancement_tpu.ops.pallas.conv_pool_cm import (
    pack_conv_pool as jax_pack_conv_pool,
)
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.conv_cm import (
    C_OUT_ALIGN,
    K_CHUNK,
    conv3x3,
    conv3x3_plain,
    conv3x3_pool,
    launch_error,
    pack_conv,
    pack_conv_pool,
)
from multi_degradation_image_enhancement_tpu_torch.utils.jax_port import conv_to_hwio

# The same bf16 operands on both sides; only the f32 summation order differs.
SAME_OPERANDS_TOL = 1e-4


def _inputs(seed, batch, h, w, c_in, c_out):
    """x NHWC, the HWIO kernel and the bias, scaled as the JAX tests scale them."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(batch, h, w, c_in) * 0.5).astype(np.float32)
    k = (rng.randn(3, 3, c_in, c_out) * 0.1).astype(np.float32)
    b = (rng.randn(c_out) * 0.1).astype(np.float32)
    return x, k, b


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


def _lax_conv(x, k, b, relu):
    y = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")
    ) + jnp.asarray(b)
    return jnp.maximum(y, 0.0) if relu else y


@pytest.mark.parametrize("c_in,c_out,h,w,relu", [
    (64, 128, 16, 24, True),
    (128, 64, 16, 24, True),
    (16, 3, 32, 16, False),
])
def test_conv3x3_plain_matches_pallas_interpret(c_in, c_out, h, w, relu):
    x, k, b = _inputs(4, 2, h, w, c_in, c_out)
    xcm = jnp.asarray(x).transpose(0, 3, 1, 2).reshape(2, c_in, h * w)
    out = conv3x3_cm(xcm, jax_pack_conv(jnp.asarray(k), jnp.asarray(b)), hw_shape=(h, w),
                     relu=relu, interpret=True)
    want = np.asarray(out[:, :c_out, :]).reshape(2, c_out, h, w)

    got = conv3x3(_nchw(x), pack_conv(_oihw(k), torch.from_numpy(b)), relu=relu)
    assert got.shape == (2, c_out, h, w) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= SAME_OPERANDS_TOL
    # and the JAX test's bar against the f32 conv (test_pallas_kernels.py:259-260)
    ref = np.asarray(_lax_conv(x, k, b, relu)).transpose(0, 3, 1, 2)
    err = np.abs(got.numpy() - ref)
    assert err.max() < 5e-2 and err.mean() < 5e-3


@pytest.mark.parametrize("c_in,c_out,h,w,batch", [
    (3, 64, 16, 32, 2),
    (8, 16, 8, 16, 3),
    (64, 128, 16, 32, 1),
])
def test_conv3x3_pool_plain_matches_pallas_interpret(c_in, c_out, h, w, batch):
    x, k, b = _inputs(5, batch, h, w, c_in, c_out)
    xcm = jnp.asarray(x).transpose(0, 3, 1, 2).reshape(batch, c_in, h * w)
    if c_in % 8:
        xcm = jnp.pad(xcm, ((0, 0), (0, 8 - c_in % 8), (0, 0)))
    out = conv3x3_pool_cm(deinterleave_cols(xcm, (h, w)),
                          jax_pack_conv_pool(jnp.asarray(k), jnp.asarray(b)),
                          hw_shape=(h, w), interpret=True)
    want = np.asarray(out[:, :c_out, :]).reshape(batch, c_out, h // 2, w // 2)

    got = conv3x3_pool(_nchw(x), pack_conv_pool(_oihw(k), torch.from_numpy(b)))
    assert got.shape == (batch, c_out, h // 2, w // 2) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= SAME_OPERANDS_TOL
    ref = np.asarray(fnn.max_pool(_lax_conv(x, k, b, True), (2, 2), strides=(2, 2)))
    err = np.abs(got.numpy() - ref.transpose(0, 3, 1, 2))
    assert err.max() < 5e-2 and err.mean() < 5e-3


def test_bf16_io_rounds_once_at_the_end():
    """bf16 in → bf16 out: the f32 result rounded once, at the end; f32 in
    gives the same bf16 operands and so the same f32 result."""
    x, k, b = _inputs(6, 2, 8, 16, 32, 48)
    pack = pack_conv(_oihw(k), torch.from_numpy(b))
    xt = _nchw(x)
    for fn in (lambda t: conv3x3(t, pack), lambda t: conv3x3_pool(t, pack)):
        f32 = fn(xt.to(torch.bfloat16).float())
        got = fn(xt.to(torch.bfloat16))
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, f32.to(torch.bfloat16))
        assert torch.equal(fn(xt), f32)


def test_pack_folds_bn_as_the_jax_package():
    """``pack_conv(w, b, bn)`` folds the inference BatchNorm as JAX's
    ``_fold_conv_bn`` does, then casts the kernel to bf16."""
    rng = np.random.RandomState(7)
    c_in, c_out = 5, 6
    w = rng.randn(c_out, c_in, 3, 3).astype(np.float32)
    b = rng.randn(c_out).astype(np.float32)
    bn = torch.nn.BatchNorm2d(c_out).eval()
    stats = {name: rng.uniform(0.5, 1.5, c_out).astype(np.float32)
             for name in ("scale", "bias", "mean", "var")}
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(stats["scale"]))
        bn.bias.copy_(torch.from_numpy(stats["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
    pack = pack_conv(torch.from_numpy(w), torch.from_numpy(b), bn)
    jk, jb = _fold_conv_bn({"kernel": jnp.asarray(conv_to_hwio(w)), "bias": jnp.asarray(b)},
                           {"scale": stats["scale"], "bias": stats["bias"]},
                           {"mean": stats["mean"], "var": stats["var"]})
    want_w = np.asarray(jnp.asarray(jk).astype(jnp.bfloat16).astype(jnp.float32))
    assert pack.w_bf16.dtype == torch.bfloat16 and pack.bias.dtype == torch.float32
    np.testing.assert_allclose(conv_to_hwio(pack.w_bf16.float().numpy()), want_w, rtol=1e-2)
    np.testing.assert_allclose(pack.bias.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-6)
    assert pack_conv_pool is pack_conv


def test_plain_path_counts_no_launch_and_refuses_grad():
    x, k, b = _inputs(8, 1, 8, 16, 3, 16)
    pack = pack_conv(_oihw(k), torch.from_numpy(b))
    n0 = (conv3x3.launches, conv3x3_pool.launches)
    with torch.no_grad():
        assert conv3x3(_nchw(x), pack).shape == (1, 16, 8, 16)
        assert conv3x3_pool(_nchw(x), pack).shape == (1, 16, 4, 8)
    assert (conv3x3.launches, conv3x3_pool.launches) == n0
    xg = _nchw(x).requires_grad_(True)
    for fn in (conv3x3, conv3x3_pool):
        with pytest.raises(RuntimeError, match="inference only"):
            fn(xg, pack)
    assert torch.equal(conv3x3_plain(_nchw(x), pack, relu=False),
                       conv3x3(_nchw(x), pack, relu=False))


KMAJOR_SHAPES = [(c_out, c_in) for c_out in (3, 64, 128) for c_in in (64, 72)]


@pytest.mark.parametrize("c_out,c_in", KMAJOR_SHAPES)
def test_kmajor_pack_unpacks_to_the_oihw_weights(c_out, c_in):
    """#8's ``w_packed`` ``[c_out_pad, 9, c_in_pad]``: c_out padded to 8 (the
    ``wgmma`` N granule), c_in to the 64-channel K step, zeros in the
    padding, and the OIHW ``w_bf16`` back exactly."""
    _, k, b = _inputs(9, 1, 1, 1, c_in, c_out)
    pack = pack_conv(_oihw(k), torch.from_numpy(b))
    c_out_pad, c_in_pad = -(-c_out // C_OUT_ALIGN) * C_OUT_ALIGN, -(-c_in // K_CHUNK) * K_CHUNK
    assert pack.w_packed.shape == (c_out_pad, 9, c_in_pad)
    assert pack.w_packed.dtype == torch.bfloat16 and pack.w_packed.is_contiguous()
    unpacked = pack.w_packed[:c_out, :, :c_in].reshape(c_out, 3, 3, c_in).permute(0, 3, 1, 2)
    assert torch.equal(unpacked, pack.w_bf16)
    assert not pack.w_packed[c_out:].any() and not pack.w_packed[:, :, c_in:].any()
    # tap 3·ky + kx, then input channel: entry [o, t, c] is w[o, c, ky, kx]
    assert torch.equal(pack.w_packed[c_out - 1, 5, c_in - 1], pack.w_bf16[c_out - 1, c_in - 1, 1, 2])


def _tap_gemm(x: torch.Tensor, w_packed: torch.Tensor, bias: torch.Tensor, c_out: int) -> torch.Tensor:
    """#8's implicit GEMM written out (M = pixels, N = c_out_pad, K = 9 taps
    × c_in_pad).  The NHWC pass rounds x to bf16 into [B, H, W, c_t], c_t =
    c_in rounded up to 8, zeros past c_in.  K steps walk 64-channel chunks,
    each through the nine taps; step (chunk, tap 3·ky + kx) reads the NHWC
    operand at pixel (h + ky − 1, w + kx − 1) and channels chunk..chunk + 63,
    zero outside the image and past c_t (the TMA map's bounds), against the
    pack's [n, tap, chunk] slice; then the f32 bias and the ReLU."""
    bsz, c_in, h, w = x.shape
    c_out_pad, _, c_in_pad = w_packed.shape
    c_t = -(-c_in // 8) * 8
    xt = torch.zeros((bsz, h, w, c_t), dtype=torch.float32)
    xt[..., :c_in] = x.to(torch.bfloat16).float().permute(0, 2, 3, 1)
    box = torch.zeros((bsz, h + 2, w + 2, c_in_pad), dtype=torch.float32)  # the map's zero fill
    box[:, 1:-1, 1:-1, :c_t] = xt
    acc = torch.zeros((bsz * h * w, c_out_pad), dtype=torch.float32)
    for ks in range(9 * c_in_pad // K_CHUNK):
        c0, tap = ks // 9 * K_CHUNK, ks % 9
        ky, kx = divmod(tap, 3)
        a = box[:, ky:ky + h, kx:kx + w, c0:c0 + K_CHUNK].reshape(-1, K_CHUNK)
        acc += a @ w_packed[:, tap, c0:c0 + K_CHUNK].float().T
    out = torch.relu(acc[:, :c_out] + bias)
    return out.reshape(bsz, h, w, c_out).permute(0, 3, 1, 2)


@pytest.mark.parametrize("hw", [(32, 34), (37, 53)])
@pytest.mark.parametrize("c_out,c_in", KMAJOR_SHAPES)
def test_tap_gemm_over_the_pack_matches_plain(c_out, c_in, hw):
    """The index algebra of #8's kernel, modelled tap by tap over the K-major
    pack, against ``conv3x3_plain`` in f32 (only the order of f32 sums
    differs): ≤ 1e-5."""
    x, k, b = _inputs(10, 2, *hw, c_in, c_out)
    pack = pack_conv(_oihw(k), torch.from_numpy(b))
    got = _tap_gemm(_nchw(x), pack.w_packed, pack.bias, c_out)
    want = conv3x3_plain(_nchw(x), pack)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-5


def test_conv_launch_predicate_rejects_what_the_kernel_does_not_take():
    """#8 reads x through an NHWC pass of its own, so any width and channel
    count reaches the kernel (rows of 34 pixels, 72 channels); it refuses
    only an empty or non-4-D x, a batch past the pass's grid and an image
    past its 32-bit pixel index."""
    assert launch_error((128, 64, 128, 128), 128) is None
    assert launch_error((1, 72, 37, 53), 3) is None
    assert launch_error((1, 64, 32, 34), 64) is None
    assert "non-empty" in launch_error((0, 64, 32, 32), 64)
    assert "non-empty" in launch_error((1, 64, 32, 32), 0)
    assert "non-empty" in launch_error((64, 32, 32), 64)
    assert "batch" in launch_error((65536, 8, 8, 8), 8)
    assert "32-bit" in launch_error((1, 8, 65536, 32768), 8)
