"""PyTorch port: the nine degradations (ops/degradations.py, ops/image.py) vs
the JAX package on the same numpy images and parameters.

Every JAX call is eager (op by op, as the port runs).  Bar for each family:
max |Δ| ≤ 1 LSB and ≥ 99.9% of values identical.  Measured on the CPU:
every family bit-identical (0 differing values) at 6×37×53 and 6×64×96, and
pixelation at 4×256×384 with the factors that divide neither side (5, 7, 9,
11, 13, 15).  jpeg at 4×256×384 on random images is the one family that can
differ: its 8×8 transforms sum in another order than XLA's dot, and a
coefficient one ulp from a rounding boundary flips now and then (measured: 8
of 1,179,648 values by 1 LSB in one draw, one block by ≤ 2 LSB in another);
tests/test_torch_jpeg.py holds it at the small sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_degradation_image_enhancement_tpu.ops import degradations as jdeg
from multi_degradation_image_enhancement_tpu.ops import image as jimage
from multi_degradation_image_enhancement_tpu_torch.data.synthetic import SyntheticPairedDataset
from multi_degradation_image_enhancement_tpu_torch.ops import degradations as deg
from multi_degradation_image_enhancement_tpu_torch.ops import image as image

RANGES = {  # name -> {param: (low, high, kind)}; int highs exclusive, as randint
    "blur": {"k_idx": (0, 4, "int")},
    "noise": {"std": (10.0, 50.0, "float")},
    "low_light": {"factor": (0.05, 0.4, "float")},
    "jpeg": {"quality": (10, 51, "int")},
    "pixelation": {"factor": (4, 17, "int")},
    "motion_blur": {"k": (5, 26, "int")},
    "high_light": {"factor": (1.5, 3.0, "float")},
    "low_contrast": {"alpha": (0.3, 0.7, "float")},
    "color_distortion": {"gains": (0.6, 1.4, "float")},
}


def _images(b, h, w, seed=0):
    return np.floor(np.random.RandomState(seed).rand(b, h, w, 3) * 256.0).astype(np.float32)


def _numpy_params(name, b, seed=1):
    """Parameters drawn with numpy over each family's range."""
    rng = np.random.RandomState(seed)
    out = {}
    for key, (lo, hi, kind) in RANGES[name].items():
        shape = (b, 3) if name == "color_distortion" else (b,)
        out[key] = (rng.randint(lo, hi, shape).astype(np.int32) if kind == "int"
                    else rng.uniform(lo, hi, shape).astype(np.float32))
    return out


def _both(name, x, params):
    """(JAX, port) outputs of ``apply_with_params`` on the same inputs."""
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    if name == "noise":
        key = jax.random.key(7)
        jparams["noise_key"] = key
        tparams["normal"] = torch.from_numpy(
            np.asarray(jax.random.normal(key, x.shape, jnp.float32)))
    want = np.asarray(jdeg.apply_with_params(name, jnp.asarray(x), jparams))
    got = deg.apply_with_params(name, torch.from_numpy(x), tparams)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    return got.numpy(), want


def _assert_lsb(got, want, what):
    d = np.abs(got - want)
    assert d.max() <= 1.0 and (d == 0).mean() >= 0.999, (what, d.max(), (d > 0).mean())


@pytest.mark.parametrize("hw", [(37, 53), (64, 96)], ids=["37x53", "64x96"])
@pytest.mark.parametrize("name", deg.DEGRADATIONS)
def test_apply_with_params_matches_jax(name, hw):
    x = _images(6, *hw)
    got, want = _both(name, x, _numpy_params(name, 6))
    _assert_lsb(got, want, name)
    assert np.array_equal(got, np.clip(np.round(got), 0, 255))  # on the uint8 lattice


def test_pixelation_non_dividing_factors_at_the_train_size():
    """Factors 5..15 odd divide neither 256 nor 384: fractional source taps."""
    x = _images(6, 256, 384, seed=2)
    params = {"factor": np.array([5, 7, 9, 11, 13, 15], np.int32)}
    got, want = _both("pixelation", x, params)
    _assert_lsb(got, want, "pixelation")
    # factor clamp to [2, min(H, W)//2] on a tiny image
    x = _images(2, 12, 20, seed=3)
    got, want = _both("pixelation", x, {"factor": np.array([16, 3], np.int32)})
    _assert_lsb(got, want, "pixelation clamp")


@pytest.mark.parametrize("name", deg.DEGRADATIONS)
def test_sample_params_ranges_and_dtypes(name):
    """Keys, dtypes and shapes as JAX's ``sample_params`` (noise: ``std``
    only; the port draws its normals in ``apply_degradation``); values in
    range, integer ranges covered end to end."""
    b = 2048
    got = deg.sample_params(name, torch.Generator().manual_seed(0), b)
    want = jdeg.sample_params(name, jax.random.key(0), b)
    assert sorted(got) == sorted(k for k in want if k != "noise_key")
    for key, (lo, hi, kind) in RANGES[name].items():
        v, w = got[key].numpy(), np.asarray(want[key])
        assert v.dtype == w.dtype and v.shape == w.shape, key
        if kind == "int":
            assert v.min() == lo and v.max() == hi - 1, key
        else:
            assert v.min() >= lo and v.max() <= hi, key


@pytest.mark.parametrize("name", deg.DEGRADATIONS)
def test_apply_degradation_and_degrade_batch(name):
    x = torch.from_numpy(_images(3, 24, 32, seed=4))
    out = deg.apply_degradation(name, x, torch.Generator().manual_seed(5))
    again = deg.apply_degradation(name, x, torch.Generator().manual_seed(5))
    assert torch.equal(out, again)
    assert torch.equal(out, torch.clamp(torch.round(out), 0, 255))
    d01, c01 = deg.degrade_batch(x, name, torch.Generator().manual_seed(5))
    assert torch.equal(d01, out / 255.0) and torch.equal(c01, x / 255.0)


@pytest.mark.parametrize("pad", [1, 4, 12, 30])
def test_reflect_pad_and_tap_sums_match_jax(pad):
    """BORDER_REFLECT_101 (``jnp.pad`` reflect) on both axes, including pads
    wider than the axis; the tap sums with per-sample weights bit for bit."""
    x = np.random.RandomState(6).rand(2, 9, 14, 3).astype(np.float32) * 255
    want = np.asarray(jimage.reflect_pad_hw(jnp.asarray(x), pad, pad))
    got = image.reflect_pad_hw(torch.from_numpy(x), pad, pad).numpy()
    assert np.array_equal(got, want)
    taps = np.random.RandomState(7).rand(2, 2 * pad + 1).astype(np.float32)
    for jfn, tfn in ((jimage.conv_taps_w, image.conv_taps_w), (jimage.conv_taps_h, image.conv_taps_h),
                     (jimage.separable_blur, image.separable_blur)):
        want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(taps), pad))
        assert np.array_equal(tfn(torch.from_numpy(x), torch.from_numpy(taps), pad).numpy(), want)


@pytest.mark.parametrize("out_hw", [(7, 11), (18, 28), (9, 14)])
def test_resize_nearest_matches_jax(out_hw):
    x = np.random.RandomState(8).rand(2, 9, 14, 3).astype(np.float32)
    want = np.asarray(jimage.resize_nearest_cv(jnp.asarray(x), *out_hw))
    assert np.array_equal(image.resize_nearest_cv(torch.from_numpy(x), *out_hw).numpy(), want)


def test_true_div_is_correctly_rounded():
    """``true_div`` divides (no reciprocal), so it equals numpy's f32 division
    where ``number / tensor`` (reciprocal times the number) does not."""
    q = torch.arange(1, 2001, dtype=torch.float32)
    want = (np.float32(5000.0) / q.numpy()).astype(np.float32)
    assert np.array_equal(image.true_div(5000.0, q).numpy(), want)
    assert np.array_equal(image.true_div(q, 3.0).numpy(), q.numpy() / np.float32(3.0))


def test_gaussian_table_is_bit_equal_to_jax():
    assert np.array_equal(deg.GAUSSIAN_KERNEL_TABLE.numpy(), np.asarray(jdeg.GAUSSIAN_KERNEL_TABLE))


@pytest.mark.parametrize("name", deg.DEGRADATIONS)
def test_synthetic_dataset_accepts_every_degradation(name):
    ds = SyntheticPairedDataset(
        degradation=name, n_images=2, height=16, width=24,
        transform={"backend": "albumentations", "ops": [{"name": "ToTensorV2"}]})
    assert ds.device_degrade == name and ds.clean.shape == (2, 16, 24, 3)


def test_synthetic_dataset_refuses_unknown_names_and_clean_root(tmp_path):
    """An unknown degradation, and a ``clean_root`` holding no image, raise
    the JAX package's errors (``data/synthetic.py:72-90``)."""
    with pytest.raises(ValueError, match="Unknown degradation"):
        SyntheticPairedDataset(degradation="haze", n_images=1)
    (tmp_path / "notes.txt").write_text("not an image")
    with pytest.raises(RuntimeError, match="No images found"):
        SyntheticPairedDataset(degradation="blur", clean_root=str(tmp_path), n_images=1)
