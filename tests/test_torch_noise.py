"""PyTorch port: noise degrade (ops/cuda/noise.py, ops/degradations.py) vs the
JAX package, on the same NumPy inputs.

On the CPU the port runs the kernel's plain version; the CUDA kernel itself is
checked against that plain version on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_degradation_image_enhancement_tpu.ops import degradations as jdeg
from multi_degradation_image_enhancement_tpu.ops.pallas.noise import _bits_to_noise01
from multi_degradation_image_enhancement_tpu_torch.ops import degradations as tdeg
from multi_degradation_image_enhancement_tpu_torch.ops.cuda import noise as tnoise

# f32 transcendentals differ in the last ulp between XLA and PyTorch, which can
# move a value across an integer and floor it to the adjacent u8 level
# (the tolerance of tests/test_noise_kernel.py:53-56).
MISMATCH_SHARE = 1e-3
LEVEL = 1.0 / 255.0 + 1e-6


def _assert_floor_close(got: np.ndarray, want: np.ndarray, level: float = LEVEL):
    diff = np.abs(got - want)
    mismatch = diff > 1e-6
    assert mismatch.mean() < MISMATCH_SHARE
    if mismatch.any():
        assert diff[mismatch].max() <= level


def test_bits_to_noise01_matches_jax():
    rng = np.random.default_rng(0)
    b, h, w = 2, 16, 64
    n_pairs = h * w * 3 // 2
    bits1 = rng.integers(0, 2**32, size=(b, n_pairs), dtype=np.uint32)
    bits2 = rng.integers(0, 2**32, size=(b, n_pairs), dtype=np.uint32)
    x = rng.uniform(0, 255, size=(b, h, w, 3)).astype(np.float32)
    std = np.array([12.5, 44.0], np.float32)
    want = np.stack([
        np.asarray(_bits_to_noise01(
            jnp.asarray(bits1[i].reshape(h // 2, w * 3)), jnp.asarray(bits2[i].reshape(h // 2, w * 3)),
            jnp.asarray(x[i].reshape(h, w * 3)), std[i], 1.0 / 255.0,
        )).reshape(h, w, 3)
        for i in range(b)
    ])
    got = tnoise.bits_to_noise01(
        torch.from_numpy(bits1.view(np.int32)), torch.from_numpy(bits2.view(np.int32)),
        torch.from_numpy(x), torch.from_numpy(std), 1.0 / 255.0,
    ).numpy()
    assert got.shape == x.shape
    _assert_floor_close(got, want)
    assert got.min() >= 0.0 and got.max() <= 1.0


def test_bits_to_uniform_matches_jax():
    from multi_degradation_image_enhancement_tpu.ops.pallas.noise import _bits_to_uniform

    bits = np.random.default_rng(1).integers(0, 2**32, size=(4, 256), dtype=np.uint32)
    bits[0, :4] = [0, 2**32 - 1, 2**31, 511]
    want = np.asarray(_bits_to_uniform(jnp.asarray(bits)))
    got = tnoise.bits_to_uniform(torch.from_numpy(bits.view(np.int32))).numpy()
    np.testing.assert_array_equal(got, want)


def test_plain_noise_moments():
    rng = np.random.default_rng(2)
    b, n_pairs = 1, 64 * 1024
    bits1 = torch.from_numpy(rng.integers(0, 2**32, (b, n_pairs), dtype=np.uint32).view(np.int32))
    bits2 = torch.from_numpy(rng.integers(0, 2**32, (b, n_pairs), dtype=np.uint32).view(np.int32))
    x = torch.full((b, 2 * n_pairs), 128.0)
    out = tnoise.bits_to_noise01(bits1, bits2, x, torch.tensor([10.0]), 1.0)
    n = ((out - 128.0) / 10.0).numpy().ravel()
    assert abs(n.mean()) < 0.07  # floor adds a −U[0,1)/σ bias ≈ −0.05
    assert abs(n.std() - 1.0) < 0.02
    assert abs(np.corrcoef(n[:n_pairs], n[n_pairs:])[0, 1]) < 0.01  # cos/sin halves


@pytest.mark.parametrize(
    "ctr,key,want",
    [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((2**32 - 1,) * 4, (2**32 - 1,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ],
)
def test_plain_philox_known_answers(ctr, key, want):
    """Random123's Philox4x32-10 known-answer vectors (the kernel's generator)."""
    t = lambda v: torch.tensor([v], dtype=torch.int64)  # noqa: E731
    got = tnoise.philox4x32_10(*(t(c) for c in ctr), *(t(k) for k in key))
    assert tuple(int(g) for g in got) == want


def test_philox_stream_is_counter_based():
    """The stream is a pure function of (seed, image, pair): it does not
    depend on the batch or the number of pairs asked for."""
    b1, b2 = tnoise.philox_bits(5, 4, 33)
    s1, s2 = tnoise.philox_bits(5, 2, 20)
    assert torch.equal(b1[:2, :20], s1) and torch.equal(b2[:2, :20], s2)
    o1, _ = tnoise.philox_bits(6, 4, 33)
    assert not torch.equal(b1, o1)
    assert not torch.equal(b1[0], b1[1])


def test_noise_degrade_cpu_is_plain_on_philox_bits():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(0, 255, (2, 8, 16, 3)).astype(np.float32))
    std = torch.tensor([10.0, 50.0])
    before = tnoise.noise_degrade_01.launches
    got = tnoise.noise_degrade_01(x, std, 77, out_dtype=torch.bfloat16)
    bits1, bits2 = tnoise.philox_bits(77, 2, 8 * 16 * 3 // 2)
    want = tnoise.bits_to_noise01(bits1, bits2, x, std, 1.0 / 255.0).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert tnoise.noise_degrade_01.launches == before  # the plain path is no launch


def test_sample_params_range():
    g = torch.Generator().manual_seed(0)
    p = tdeg.sample_params("noise", g, 4096)
    std = p["std"]
    assert std.shape == (4096,) and std.dtype == torch.float32
    assert 10.0 <= float(std.min()) and float(std.max()) <= 50.0
    assert abs(float(std.mean()) - 30.0) < 1.0
    again = tdeg.sample_params("noise", torch.Generator().manual_seed(0), 4096)["std"]
    assert torch.equal(std, again)


def test_apply_with_params_matches_jax():
    rng = np.random.default_rng(4)
    images = rng.uniform(0, 255, (3, 8, 12, 3)).astype(np.float32)
    std = np.array([10.0, 25.5, 50.0], np.float32)
    key = jax.random.key(9)
    want = np.asarray(jdeg.apply_with_params(
        "noise", jnp.asarray(images), {"std": jnp.asarray(std), "noise_key": key}))
    normal = np.asarray(jax.random.normal(key, images.shape, jnp.float32))
    got = tdeg.apply_with_params(
        "noise", torch.from_numpy(images),
        {"std": torch.from_numpy(std), "normal": torch.from_numpy(normal)},
    ).numpy()
    _assert_floor_close(got, want, level=1.0 + 1e-6)  # 0..255 domain


def test_degrade_batch_domain_and_unported_names():
    x = torch.from_numpy(np.random.default_rng(5).uniform(0, 255, (2, 8, 8, 3)).astype(np.float32))
    deg, clean = tdeg.degrade_batch(x, "noise", torch.Generator().manual_seed(1))
    assert deg.shape == clean.shape == x.shape
    assert float(deg.min()) >= 0.0 and float(deg.max()) <= 1.0
    torch.testing.assert_close(clean, x / 255.0)
    levels = deg * 255.0
    assert (levels - torch.round(levels)).abs().max() < 1e-4  # u8 lattice
    for name in tdeg.DEGRADATIONS:  # every family is ported now; each lands on the u8 lattice
        out = tdeg.apply_degradation(name, x, torch.Generator().manual_seed(2))
        assert out.shape == x.shape and torch.equal(out, torch.clamp(torch.round(out), 0, 255))
    with pytest.raises(ValueError, match="Unknown degradation"):
        tdeg.sample_params("snow", torch.Generator(), 2)
