"""PyTorch port: the JPEG round trip (ops/jpeg.py) vs the JAX package's
``ops/jpeg.py``, step by step and whole, on the same numpy images.

The constants are bit-equal (DCT matrix, quantisation tables for q 1..100).
The 8×8 transforms are elementwise multiply-adds in the port and XLA dots in
JAX, so coefficients may differ in their last bit; whole round trips here
(random and smooth images, sizes that are and are not multiples of 16,
q ∈ {10, 25, 37, 50}) measured bit-identical on the CPU.  The bar is the
degradations' (≤ 1 LSB, ≥ 99.9% identical).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_degradation_image_enhancement_tpu.ops import jpeg as jjpeg
from multi_degradation_image_enhancement_tpu_torch.ops import jpeg

QUALITIES = np.array([10, 25, 37, 50], np.int32)


def _random(b, h, w, seed):
    return np.floor(np.random.RandomState(seed).rand(b, h, w, 3) * 256.0).astype(np.float32)


def _smooth(b, h, w, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    out = np.empty((b, h, w, 3), np.float32)
    for i in range(b):
        f = rng.uniform(0.5, 3.0, (3, 2))
        out[i] = 127.5 + 120 * np.cos(2 * np.pi * (f[:, 0] * yy[..., None] / h
                                                   + f[:, 1] * xx[..., None] / w))
    return np.floor(out)


def test_constants_are_bit_equal():
    assert np.array_equal(jpeg._DCT8.numpy(), np.asarray(jjpeg._DCT8))
    q = np.arange(1, 101, dtype=np.int32)
    for got, want in zip(jpeg.quality_to_qtables(torch.from_numpy(q)),
                         jjpeg.quality_to_qtables(jnp.asarray(q))):
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_block_transforms_match_jax():
    blocks = np.random.RandomState(0).randn(3, 2, 5, 8, 8).astype(np.float32) * 100
    for tfn, jfn in ((jpeg.dct2_blocks, jjpeg.dct2_blocks), (jpeg.idct2_blocks, jjpeg.idct2_blocks)):
        got = tfn(torch.from_numpy(blocks)).numpy()
        want = np.asarray(jfn(jnp.asarray(blocks)))
        assert np.abs(got - want).max() <= 1e-4
    back = jpeg.idct2_blocks(jpeg.dct2_blocks(torch.from_numpy(blocks))).numpy()
    assert np.abs(back - blocks).max() <= 1e-3  # orthonormal


def test_colour_and_chroma_steps_match_jax():
    x = _random(2, 16, 32, 1)
    for got, want in zip(jpeg.rgb_to_ycbcr(torch.from_numpy(x)), jjpeg.rgb_to_ycbcr(jnp.asarray(x))):
        assert np.array_equal(got.numpy(), np.asarray(want))
    plane = x[..., 0]
    assert np.array_equal(jpeg._downsample_2x2(torch.from_numpy(plane)).numpy(),
                          np.asarray(jjpeg._downsample_2x2(jnp.asarray(plane))))
    assert np.array_equal(jpeg._fancy_upsample_2x2(torch.from_numpy(plane)).numpy(),
                          np.asarray(jjpeg._fancy_upsample_2x2(jnp.asarray(plane))))
    y, cb, cr = (torch.from_numpy(x[..., i]) for i in range(3))
    assert np.array_equal(jpeg.ycbcr_to_rgb(y, cb, cr).numpy(),
                          np.asarray(jjpeg.ycbcr_to_rgb(*(jnp.asarray(x[..., i]) for i in range(3)))))


@pytest.mark.parametrize("kind", ["random", "smooth"])
@pytest.mark.parametrize("hw", [(64, 96), (37, 53), (16, 16), (40, 24)],
                         ids=["64x96", "37x53", "16x16", "40x24"])
def test_roundtrip_matches_jax(kind, hw):
    x = (_random if kind == "random" else _smooth)(4, *hw, seed=hw[0])
    got = jpeg.jpeg_roundtrip(torch.from_numpy(x), torch.from_numpy(QUALITIES)).numpy()
    want = np.asarray(jjpeg.jpeg_roundtrip(jnp.asarray(x), jnp.asarray(QUALITIES)))
    assert got.shape == x.shape
    d = np.abs(got - want)
    assert d.max() <= 1.0 and (d == 0).mean() >= 0.999, (d.max(), (d > 0).mean())
    assert np.array_equal(got, np.clip(np.round(got), 0, 255))


def test_quality_orders_the_damage():
    """Lower quality, larger error against the clean image; q broadcasts."""
    x = _smooth(1, 48, 64, 3)
    err = [np.abs(jpeg.jpeg_roundtrip(torch.from_numpy(x), torch.tensor([q])).numpy() - x).mean()
           for q in (10, 30, 50)]
    assert err[0] > err[1] > err[2] > 0
    xs = np.repeat(x, 2, axis=0)
    both = jpeg.jpeg_roundtrip(torch.from_numpy(xs), torch.tensor(20)).numpy()
    assert np.array_equal(both[0], both[1])
