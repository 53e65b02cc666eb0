"""PyTorch port: the albumentations ops added for the other degradations'
configs (data/transforms.py, ops/color.py, ops/clahe.py) vs the JAX package.

Each op runs in JAX on a key; the test draws the same per-sample parameters
from that key the way the JAX op does and hands them to the port's
``apply``, so both sides transform the same numpy images with the same
parameters.  Bar: 1e-4 absolute on the 0..255 scale (measured on the CPU:
brightness/contrast, noise, motion blur and HSV identical, gamma 1.5e-05,
sharpen 4.6e-05, ``replace_lab_l`` 9.2e-05: the last bits of f32 ``pow``,
``cbrt`` and a 9-term kernel sum), CLAHE ≤ 1 LSB (its cdf is a cumulative
sum in another order, so a LUT entry may round the other way; measured: the
LUTs identical, the RGB result 6.1e-05).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_degradation_image_enhancement_tpu.data import transforms as jtf
from multi_degradation_image_enhancement_tpu.ops import clahe as jclahe
from multi_degradation_image_enhancement_tpu.ops import color as jcolor
from multi_degradation_image_enhancement_tpu_torch.data import transforms as tf
from multi_degradation_image_enhancement_tpu_torch.ops import clahe, color

B, H, W = 4, 32, 48


def _images(seed=0):
    return (np.random.RandomState(seed).rand(B, H, W, 3) * 255.0).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jax_params(name, args, key, shape):
    """The port's params for op ``name`` as the JAX op draws them from ``key``."""
    b, p = shape[0], args.get("p", 0.5)

    def bern(k):
        return jax.random.uniform(k, (b,)) < p

    if name == "RandomBrightnessContrast":
        ka, kb, kc = jax.random.split(key, 3)
        applied = bern(ka).astype(jnp.float32)
        c, br = args["contrast_limit"], args["brightness_limit"]
        alpha = 1.0 + jax.random.uniform(kb, (b,), minval=-c, maxval=c)
        beta = jax.random.uniform(kc, (b,), minval=-br, maxval=br)
        return _t(1.0 + (alpha - 1.0) * applied), _t(beta * applied)
    if name == "RandomGamma":
        ka, kg = jax.random.split(key)
        lo, hi = args["gamma_limit"]
        gamma = jax.random.uniform(kg, (b,), minval=lo / 100.0, maxval=hi / 100.0)
        return _t(1.0 + (gamma - 1.0) * bern(ka).astype(jnp.float32))
    if name == "GaussNoise":
        ka, kv, kn = jax.random.split(key, 3)
        var = jax.random.uniform(kv, (b,), minval=args["var_limit"][0], maxval=args["var_limit"][1])
        sigma = jnp.sqrt(var) * bern(ka).astype(jnp.float32)
        return _t(jax.random.normal(kn, shape) * sigma[:, None, None, None])
    if name == "MotionBlur":
        ka, kk = jax.random.split(key)
        k = jax.random.randint(kk, (b,), 3, args["blur_limit"] + 1)
        return _t(jnp.where(bern(ka), k, 1))
    if name == "Sharpen":
        return _t(bern(jax.random.split(key)[0]))
    if name == "HueSaturationValue":
        ka, kh, ks, kv = jax.random.split(key, 4)
        applied = bern(ka).astype(jnp.float32)
        lims = (args["hue_shift_limit"], args["sat_shift_limit"], args["val_shift_limit"])
        return tuple(_t(applied * jax.random.uniform(k, (b,), minval=-lim, maxval=lim))
                     for k, lim in zip((kh, ks, kv), lims))
    if name == "CLAHE":
        return _t(bern(key))
    raise AssertionError(name)


OPS = [
    ("RandomBrightnessContrast", {"brightness_limit": 0.1, "contrast_limit": 0.1, "p": 0.6}),
    ("RandomGamma", {"gamma_limit": [70, 130], "p": 0.6}),
    ("GaussNoise", {"var_limit": [10.0, 50.0], "p": 0.6}),
    ("MotionBlur", {"blur_limit": 7, "p": 0.6}),
    ("Sharpen", {"alpha": [0.2, 0.5], "p": 0.6}),
    ("HueSaturationValue", {"hue_shift_limit": 20, "sat_shift_limit": 30, "val_shift_limit": 20,
                            "p": 0.6}),
    ("CLAHE", {"clip_limit": 4.0, "tile_grid_size": [8, 8], "p": 0.6}),
]


@pytest.mark.parametrize("name,args", OPS, ids=[n for n, _ in OPS])
def test_op_matches_jax_with_its_parameters(name, args):
    x = _images(1)
    key = jax.random.key(11)
    want = np.asarray(jtf._albu_op(name, args)(jnp.asarray(x), key))
    _, apply = tf._albu_op(name, args)
    got = apply(torch.from_numpy(x), _jax_params(name, args, key, x.shape)).numpy()
    d = np.abs(got - want)
    assert d.max() <= (1.0 if name == "CLAHE" else 1e-4), (name, d.max())


@pytest.mark.parametrize("name,args", OPS, ids=[n for n, _ in OPS])
def test_sampled_op_is_shared_by_input_and_target(name, args):
    """One draw per batch, the same on input and target; applied to some
    samples and not others at p=0.6."""
    x = torch.from_numpy(_images(2))
    chain = tf.DeviceTransform([tf._albu_op(name, args)], None)
    inp, tgt = chain.apply_paired(x, x.clone(), torch.Generator().manual_seed(3))
    assert torch.equal(inp, tgt) and inp.shape == x.shape
    assert bool(torch.isfinite(inp).all()) and float(inp.min()) >= 0 and float(inp.max()) <= 255


def test_photometric_ops_change_the_target_too():
    """RandomGamma and RandomBrightnessContrast at p=1 move the target as the
    JAX package's key sharing does (transforms.py:383-388)."""
    x = torch.from_numpy(_images(3))
    for name, args in OPS[:2]:
        chain = tf.DeviceTransform([tf._albu_op(name, {**args, "p": 1.0})], None)
        inp, tgt = chain.apply_paired(x + 1.0, x.clone(), torch.Generator().manual_seed(4))
        assert float((tgt - x).abs().max()) > 0.5, name


@pytest.mark.parametrize("fn", ["rgb_to_hsv_cv", "rgb_to_lab_l", "hsv_round_trip", "replace_lab_l"])
def test_colour_conversions_match_jax(fn):
    x = _images(5)
    if fn == "hsv_round_trip":
        hsv = np.asarray(jcolor.rgb_to_hsv_cv(jnp.asarray(x)))
        want = np.asarray(jcolor.hsv_to_rgb_cv(jnp.asarray(hsv)))
        got = color.hsv_to_rgb_cv(torch.from_numpy(hsv)).numpy()
        assert np.abs(want - x).max() <= 1e-3  # the round trip itself
    elif fn == "replace_lab_l":
        new_l = (np.random.RandomState(6).rand(B, H, W) * 255).astype(np.float32)
        want = np.asarray(jcolor.replace_lab_l(jnp.asarray(x), jnp.asarray(new_l)))
        got = color.replace_lab_l(torch.from_numpy(x), torch.from_numpy(new_l)).numpy()
    else:
        want = np.asarray(getattr(jcolor, fn)(jnp.asarray(x)))
        got = getattr(color, fn)(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-4


@pytest.mark.parametrize("clip_limit", [1.0, 4.0])
def test_clahe_matches_jax(clip_limit):
    """Per-tile LUTs to ≤ 1 LSB (measured identical), the L channel and
    the RGB result to ≤ 1 LSB."""
    lum = np.floor(np.random.RandomState(7).rand(B, H, W) * 256).astype(np.float32)
    lut = clahe._tile_luts(torch.from_numpy(lum).long(), 8, clip_limit).numpy()
    want_lut = np.asarray(jclahe._tile_luts(jnp.asarray(lum, jnp.int32), 8, clip_limit))
    assert np.abs(lut - want_lut).max() <= 1.0
    got = clahe.clahe_l_channel(torch.from_numpy(lum), 8, clip_limit).numpy()
    assert np.abs(got - np.asarray(jclahe.clahe_l_channel(jnp.asarray(lum), 8, clip_limit))).max() <= 1.0
    x = _images(8)
    got = clahe.clahe_rgb(torch.from_numpy(x), 8, clip_limit).numpy()
    assert np.abs(got - np.asarray(jclahe.clahe_rgb(jnp.asarray(x), 8, clip_limit))).max() <= 1.0


def test_unknown_op_and_backend_raise():
    with pytest.raises(ValueError, match="not supported"):
        tf.build_transforms({"backend": "albumentations", "ops": [{"name": "Blur"}]})
    with pytest.raises(ValueError, match="Unknown transform backend"):
        tf.build_transforms({"backend": "kornia", "ops": [{"name": "ToTensor"}]})
