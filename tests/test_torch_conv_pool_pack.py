"""PyTorch port: the layout of #9's tensor-core kernel (``conv3x3_pool``,
csrc/conv_cm.cu), emulated on the CPU.

The CUDA kernel is an im2col implicit GEMM over four polyphase fields, one
per 2×2 window position: D[channel][pooled pixel] = W · X with K = 9·c_in in
the order ``k = 9c + 3ky + kx`` (``ConvPack.w_pool``); the pool is an
elementwise max of the fields' f32 sums, then bias and ReLU once.
``emulate_conv3x3_pool`` repeats that arithmetic in that layout and is held
against the plain version and the JAX kernel in interpret mode; on the card
``chip_smoke.py`` holds the kernel against the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_degradation_image_enhancement_tpu.ops.pallas.conv_pool_cm import (
    conv3x3_pool_cm,
    deinterleave_cols,
)
from multi_degradation_image_enhancement_tpu.ops.pallas.conv_pool_cm import (
    pack_conv_pool as jax_pack_conv_pool,
)
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.conv_cm import (
    C_OUT_ALIGN,
    POOL_K_CHUNK,
    POOL_TILE,
    conv3x3_pool_plain,
    pack_conv,
    pool_k_pad,
    pool_launch_error,
    pool_tile_cols_log2,
    pool_tiles,
)

# The same bf16 operands on both sides; only the f32 summation order differs
# (tests/test_torch_conv_cm.py).
SAME_OPERANDS_TOL = 1e-4


def _inputs(seed, batch, h, w, c_in, c_out):
    """x NCHW, the OIHW kernel and the bias, scaled as the JAX tests scale them."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(batch, c_in, h, w) * 0.5).astype(np.float32)
    k = (rng.randn(c_out, c_in, 3, 3) * 0.1).astype(np.float32)
    b = (rng.randn(c_out) * 0.1).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b)


def emulate_conv3x3_pool(x: torch.Tensor, pack) -> torch.Tensor:
    """#9's arithmetic in its layout.  x is rounded to bf16 into a patch with
    SAME's zero border; field (dy, dx)'s im2col row of pooled pixel (i, j)
    holds, at column ``k = 9c + 3ky + kx``, the patch value of channel c at
    conv pixel (2i + dy + ky − 1, 2j + dx + kx − 1), zeros past 9·c_in; each
    field is multiplied by ``w_pool`` in K chunks of at most 64 columns, in
    f32; the pool is the max of the four fields' sums, then + bias, ReLU
    and one rounding to x's dtype."""
    bsz, c_in, h, w = x.shape
    hp, wp = h // 2, w // 2
    k_pad = pack.w_pool.shape[1]
    padded = torch.nn.functional.pad(x.to(torch.bfloat16).float(), (1, 1, 1, 1))
    wk = pack.w_pool[:pack.c_out].float()
    pooled = None
    for dy in range(2):
        for dx in range(2):
            cols = torch.zeros((bsz, hp, wp, k_pad))
            for c in range(c_in):
                for ky in range(3):
                    for kx in range(3):
                        r0, c0 = dy + ky, dx + kx
                        cols[..., 9 * c + 3 * ky + kx] = padded[:, c, r0:r0 + 2 * hp:2, c0:c0 + 2 * wp:2]
            field = torch.zeros((bsz, hp, wp, pack.c_out))
            for k0 in range(0, k_pad, POOL_K_CHUNK):
                field += cols[..., k0:k0 + POOL_K_CHUNK] @ wk[:, k0:k0 + POOL_K_CHUNK].T
            pooled = field if pooled is None else torch.maximum(pooled, field)
    out = torch.clamp_min(pooled + pack.bias, 0.0)
    return out.permute(0, 3, 1, 2).to(x.dtype)


@pytest.mark.parametrize("c_out", [16, 48, 64, 128])
@pytest.mark.parametrize("c_in", [3, 8, 64])
def test_pool_pack_unpacks_to_the_oihw_weights(c_in, c_out):
    """``w_pool`` ``[c_out_pad, k_pad]``: c_out padded to 8 (the ``wgmma`` N
    granule), K = 9·c_in to 32 (conv1's 27) or to the 64-column K chunk,
    zeros in the padding, column ``9c + 3ky + kx`` holding ``w[o, c, ky,
    kx]``, and the OIHW ``w_bf16`` back exactly."""
    _, k, b = _inputs(1, 1, 2, 2, c_in, c_out)
    pack = pack_conv(k, b)
    k_pad = 32 if c_in == 3 else -(-9 * c_in // POOL_K_CHUNK) * POOL_K_CHUNK
    assert pool_k_pad(c_in) == k_pad
    c_out_pad = -(-c_out // C_OUT_ALIGN) * C_OUT_ALIGN
    assert pack.w_pool.shape == (c_out_pad, k_pad)
    assert pack.w_pool.dtype == torch.bfloat16 and pack.w_pool.is_contiguous()
    assert torch.equal(pack.w_pool[:c_out, :9 * c_in].reshape(c_out, c_in, 3, 3), pack.w_bf16)
    assert not pack.w_pool[c_out:].any() and not pack.w_pool[:, 9 * c_in:].any()
    o, c, ky, kx = c_out - 1, c_in - 1, 2, 1
    assert torch.equal(pack.w_pool[o, 9 * c + 3 * ky + kx], pack.w_bf16[o, c, ky, kx])


EMULATED = [  # (c_in, c_out, h, w, batch): pooled maps ragged against the 128-pixel tiles
    (3, 64, 10, 32, 2),
    (8, 16, 6, 48, 1),
    (64, 128, 16, 32, 1),
    (32, 48, 10, 18, 2),
    (3, 64, 20, 36, 1),
]


@pytest.mark.parametrize("c_in,c_out,h,w,batch", EMULATED)
def test_emulation_matches_plain(c_in, c_out, h, w, batch):
    """The kernel's layout and order of operations against
    ``conv3x3_pool_plain`` in f32: only the order of f32 sums differs,
    within 1e-5 of the largest output."""
    x, k, b = _inputs(2, batch, h, w, c_in, c_out)
    pack = pack_conv(k, b)
    got = emulate_conv3x3_pool(x, pack)
    want = conv3x3_pool_plain(x, pack)
    assert got.shape == want.shape == (batch, c_out, h // 2, w // 2)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("c_in,c_out,h,w,batch", EMULATED[:3])
def test_emulation_matches_pallas_interpret(c_in, c_out, h, w, batch):
    """Against the JAX kernel (``conv3x3_pool_cm`` in interpret mode, on its
    column-deinterleaved, 8-channel-padded operand) on the same bf16
    operands: ``SAME_OPERANDS_TOL``."""
    x, k, b = _inputs(3, batch, h, w, c_in, c_out)
    xcm = jnp.asarray(x.numpy()).reshape(batch, c_in, h * w)
    if c_in % 8:
        xcm = jnp.pad(xcm, ((0, 0), (0, 8 - c_in % 8), (0, 0)))
    hwio = jnp.asarray(k.numpy().transpose(2, 3, 1, 0))
    out = conv3x3_pool_cm(deinterleave_cols(xcm, (h, w)), jax_pack_conv_pool(hwio, jnp.asarray(b.numpy())),
                          hw_shape=(h, w), interpret=True)
    want = np.asarray(out[:, :c_out, :]).reshape(batch, c_out, h // 2, w // 2)
    got = emulate_conv3x3_pool(x, pack_conv(k, b))
    assert np.abs(got.numpy() - want).max() <= SAME_OPERANDS_TOL


def test_max_then_bias_relu_is_exact():
    """The kernel takes the max of the four fields' f32 sums, then adds the
    bias and applies the ReLU once: ``max_i relu(a_i + b) == relu(max_i a_i
    + b)`` bit for bit in f32 (adding one b and the ReLU are monotone), with
    ties, negatives, zeros and sums that round together (-0.0 is normalised
    to +0.0 on both sides by adding 0.0)."""
    rng = np.random.default_rng(4)
    base = np.array([0.0, -0.0, 1.0, -1.0, 3.5, -3.5, 1e8, 1e8 + 8, -1e-30, 2.0**-126], np.float32)
    a = rng.choice(base, (4, 4096)).astype(np.float32)
    a[:, :2048] += rng.normal(0, 2, (4, 2048)).astype(np.float32)
    a[1, ::7] = a[0, ::7]  # exact ties between fields
    b = rng.choice(np.array([0.0, 0.3, -0.3, -1e8, 4.0], np.float32), 4096).astype(np.float32)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    zero = torch.zeros(())
    per_field = torch.stack([torch.maximum(at[i] + bt, zero) for i in range(4)]).amax(0)
    once = torch.maximum(at.amax(0) + bt, zero)
    assert torch.equal((per_field + 0.0).view(torch.int32), (once + 0.0).view(torch.int32))


@pytest.mark.parametrize("hp,wp", [(128, 128), (128, 192), (5, 9), (3, 24), (17, 33), (1, 1)])
def test_tile_walk_covers_every_pooled_pixel_once(hp, wp):
    """The persistent walk (block i takes tiles i, i + grid, …) and the
    tile's pooled-pixel map cover the pooled map of every image exactly once
    after the edge clip, for any grid; the serving shapes (256² and 256×384
    images) give whole tiles whose 64-pixel halves each lie in one pooled row
    (a consumer's swizzled TMA box)."""
    bsz = 2
    tiles, decode = pool_tiles(bsz, hp, wp)
    tc_log2 = pool_tile_cols_log2(wp)
    tc = 1 << tc_log2
    m = np.arange(POOL_TILE)
    for grid in (1, 7, 264):
        seen = np.zeros((bsz, hp, wp), np.int64)
        for block in range(grid):
            for t in range(block, tiles, grid):
                b, r0, c0 = decode(t)
                rows, cols = r0 + (m >> tc_log2), c0 + (m & (tc - 1))
                keep = (rows < hp) & (cols < wp)
                np.add.at(seen, (b, rows[keep], cols[keep]), 1)
        assert (seen == 1).all()
    if (hp, wp) in ((128, 128), (128, 192)):
        assert tiles * POOL_TILE == bsz * hp * wp
        assert tc == {128: 128, 192: 64}[wp]


def test_pool_launch_predicate():
    """#9's kernel takes every c_in, c_out and batch of an even-sized image
    (the CM forward's conv1 at both serving shapes, the CPU test shapes);
    it refuses an empty or non-4-D x, odd H or W, and more tiles than its
    32-bit walk counts."""
    assert pool_launch_error((128, 3, 256, 256), 64) is None
    assert pool_launch_error((16, 3, 256, 384), 64) is None
    assert pool_launch_error((3, 64, 16, 32), 128) is None
    assert pool_launch_error((2, 32, 10, 18), 48) is None
    assert pool_launch_error((70000, 3, 2, 2), 1) is None  # no grid cap on the batch
    assert "non-empty" in pool_launch_error((0, 3, 8, 8), 64)
    assert "non-empty" in pool_launch_error((1, 3, 8, 8), 0)
    assert "non-empty" in pool_launch_error((3, 8, 8), 64)
    assert "even" in pool_launch_error((1, 3, 9, 8), 64)
    assert "even" in pool_launch_error((1, 3, 8, 10 + 1), 64)
    assert "32-bit" in pool_launch_error((2**31 // 64 + 1, 3, 256, 256), 64)
