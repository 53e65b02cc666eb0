"""PyTorch port: the severity-parameterised degradations (``ops/severity.py``)
against the JAX package's ``apply_severity``, fed the JAX function's own
realised parameters (and, for noise, its normal draw)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_degradation_image_enhancement_tpu.ops.severity import (
    apply_severity as jax_apply_severity,
    rotated_line_kernel as jax_rotated_line_kernel,
)
from multi_degradation_image_enhancement_tpu_torch.ops.degradations import DEGRADATIONS
from multi_degradation_image_enhancement_tpu_torch.ops.severity import (
    apply_severity,
    apply_severity_with_params,
    rotated_line_kernel,
    severity_params,
)

SHAPE = (4, 32, 48, 3)
# u8 LSBs: pointwise ops exact; the PSF correlation sums 625 f32 products in
# another order (1 LSB at a rounding tie); jpeg flips a DCT block at a
# quantisation boundary (ROADMAP.md queue 3, tests/test_torch_jpeg.py)
TOLERANCE = {"motion_blur": 1.0, "jpeg": 2.0}
DRAWN = {"motion_blur": "angle_deg", "color_distortion": "gains"}  # params drawn at random


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, SHAPE).astype(np.float32)
    sev = np.concatenate([[0.0, 1.0], rng.uniform(0, 1, SHAPE[0] - 2)]).astype(np.float32)
    return img, sev


@pytest.mark.parametrize("name", DEGRADATIONS)
def test_severity_matches_jax(batch, name):
    img, sev = batch
    key = jax.random.key(11)
    want, jparams = jax_apply_severity(name, jnp.asarray(img), jnp.asarray(sev), key)
    params = {k: torch.from_numpy(np.asarray(v)) for k, v in jparams.items()}
    if name == "noise":
        params["normal"] = torch.from_numpy(np.asarray(jax.random.normal(key, SHAPE, jnp.float32)))
    got = apply_severity_with_params(name, torch.from_numpy(img), params)
    err = np.abs(got.numpy() - np.asarray(want)).max()
    assert err <= TOLERANCE.get(name, 0.0), (name, err)
    assert np.array_equal(got.numpy(), np.round(got.numpy()))  # on the u8 lattice

    # the port's own parameters: the JAX ones where they follow from the severity
    mine = severity_params(name, torch.from_numpy(sev), torch.Generator().manual_seed(0), SHAPE)
    for k, v in jparams.items():
        assert mine[k].dtype == torch.from_numpy(np.asarray(v)).dtype, k
        if k != DRAWN.get(name):
            assert np.array_equal(mine[k].numpy(), np.asarray(v)), k
    if name in DRAWN:  # the draw's range: angle in [0, 180), gains in 1 ± 0.4·sev
        drawn = mine[DRAWN[name]].numpy()
        if name == "motion_blur":
            assert (drawn >= 0).all() and (drawn < 180).all()
        else:
            amp = 0.4 * sev[:, None] + 1e-6
            assert (np.abs(drawn - 1.0) <= amp).all()
    out, returned = apply_severity(name, torch.from_numpy(img), torch.from_numpy(sev),
                                   torch.Generator().manual_seed(0))
    assert set(returned) == set(jparams) and out.shape == SHAPE


@pytest.mark.parametrize("k,angle", [(5, 30.0), (11, 77.0), (9, 90.0), (25, 120.0), (7, 0.0)])
def test_rotated_line_kernel_matches_jax(k, angle):
    want = np.asarray(jax_rotated_line_kernel(jnp.array([k]), jnp.array([angle])))
    got = rotated_line_kernel(torch.tensor([k]), torch.tensor([angle])).numpy()
    assert got.shape == (1, 25, 25)
    assert np.abs(got - want).max() <= 1e-6
    assert abs(float(got.sum()) - 1.0) <= 1e-5
