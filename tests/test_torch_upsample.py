"""PyTorch port: the fused bilinear ×2 upsample + add (ops/cuda/upsample.py).

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it against
the plain version there); here: the plain version against an independent
float64 construction of the half-pixel ×2 resize, the edge clamp, the
wrapper's checks and counter,
and both built serving forwards, whose decoders now call it, against the
``CDAN`` module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multi_degradation_image_enhancement_tpu_torch.models import cdan_fast
from multi_degradation_image_enhancement_tpu_torch.models.cdan import init_cdan
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.upsample import (
    bilinear_x2_add,
    vector_path,
)

# The three served shapes (after de2, de3, de4 at 256²) at B=2, then odd
# H and W, C=3 with W not a multiple of 4, and 1×1.
SHAPES = [(2, 128, 32, 32), (2, 64, 64, 64), (2, 3, 128, 128), (1, 5, 7, 9), (2, 3, 6, 10),
          (1, 2, 1, 1)]
DTYPES = [torch.bfloat16, torch.float32]


def _inputs(shape, dtype, seed=0):
    b, c, h, w = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g).to(dtype)
    r = torch.randn((b, c, 2 * h, 2 * w), generator=g).to(dtype)
    return x, r


def _upsample_1d(a: np.ndarray, axis: int) -> np.ndarray:
    """×2 half-pixel linear along ``axis`` in float64: output 2i = 0.25·a[i−1]
    + 0.75·a[i], 2i+1 = 0.75·a[i] + 0.25·a[i+1], indices clamped."""
    n = a.shape[axis]
    i = np.arange(n)
    near = a
    prev = np.take(a, np.maximum(i - 1, 0), axis=axis)
    nxt = np.take(a, np.minimum(i + 1, n - 1), axis=axis)
    even, odd = 0.25 * prev + 0.75 * near, 0.75 * near + 0.25 * nxt
    return np.stack([even, odd], axis=axis + 1).reshape(
        *a.shape[:axis], 2 * n, *a.shape[axis + 1:])


def _reference64(x: torch.Tensor, r: torch.Tensor) -> np.ndarray:
    x64 = x.double().numpy()
    return _upsample_1d(_upsample_1d(x64, 2), 3) + r.double().numpy()


def _bf16_ulp_gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise distance in bf16 steps (sign-magnitude bits made ordered)."""
    def ordered(t):
        v = t.view(torch.int16).to(torch.int32)
        return torch.where(v < 0, -(v & 0x7FFF), v)

    return (ordered(a) - ordered(b)).abs()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_is_the_resize_plus_r_rounded_once(shape, dtype):
    """The CPU path is ``F.interpolate`` + r in f32, one rounding, and that is
    the float64 construction of the resize within one rounding step."""
    x, r = _inputs(shape, dtype)
    got = bilinear_x2_add(x, r)
    assert got.dtype == dtype and got.shape == r.shape
    once = (F.interpolate(x.float(), scale_factor=2, mode="bilinear", align_corners=False)
            + r.float()).to(dtype)
    assert torch.equal(got, once)
    want = _reference64(x, r)
    if dtype == torch.bfloat16:
        gap = _bf16_ulp_gap(got, torch.from_numpy(want).to(dtype))
        assert gap.max() <= 1 and (gap == 0).float().mean() >= 0.999
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)


def test_plain_matches_jax_image_resize():
    """The same resize as ``jax.image.resize(..., "bilinear")`` on NCHW."""
    x, r = _inputs((2, 3, 6, 10), torch.float32, seed=1)
    want = np.asarray(jax.image.resize(jnp.asarray(x.numpy()), r.shape, "bilinear")) + r.numpy()
    np.testing.assert_allclose(bilinear_x2_add(x, r).numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(2, 3, 5, 6), (1, 4, 1, 7), (2, 2, 6, 1)], ids=str)
def test_edges_follow_the_clamp(shape, dtype):
    """With r = 0, the first and last output rows are the 1-D ×2 resize of the
    first and last input rows, the edge columns likewise, and the corners the
    input's corners (exactly in bf16; aten's f32 resize rounds them), also
    where one input row or column is both edges."""
    b, c, h, w = shape
    x, _ = _inputs(shape, dtype, seed=2)
    y = bilinear_x2_add(x, torch.zeros((b, c, 2 * h, 2 * w), dtype=dtype)).double().numpy()
    x64 = x.double().numpy()
    tol = {"rtol": 1e-2, "atol": 1e-2} if dtype == torch.bfloat16 else {"rtol": 1e-6, "atol": 1e-6}
    np.testing.assert_allclose(y[:, :, 0, :], _upsample_1d(x64[:, :, 0, :], 2), **tol)
    np.testing.assert_allclose(y[:, :, -1, :], _upsample_1d(x64[:, :, -1, :], 2), **tol)
    np.testing.assert_allclose(y[:, :, :, 0], _upsample_1d(x64[:, :, :, 0], 2), **tol)
    np.testing.assert_allclose(y[:, :, :, -1], _upsample_1d(x64[:, :, :, -1], 2), **tol)
    exact = {"rtol": 0, "atol": 0} if dtype == torch.bfloat16 else {"rtol": 1e-6, "atol": 0}
    for i, j in ((0, 0), (0, -1), (-1, 0), (-1, -1)):
        np.testing.assert_allclose(y[:, :, i, j], x64[:, :, i, j], **exact)


@pytest.mark.parametrize("case", ["r_height", "r_channels", "r_dtype", "x_int", "x_3d"])
def test_wrapper_rejects(case):
    x, r = _inputs((2, 3, 4, 8), torch.bfloat16)
    bad = {
        "r_height": (x, r[:, :, :-1]),
        "r_channels": (x, r[:, :2]),
        "r_dtype": (x, r.float()),
        "x_int": (x.to(torch.int32), r.to(torch.int32)),
        "x_3d": (x[0], r[0]),
    }[case]
    with pytest.raises(ValueError, match="bilinear_x2_add"):
        bilinear_x2_add(*bad)


def test_wrapper_refuses_grad():
    """No backward: with grad enabled and an input that requires grad it
    raises; under no_grad it runs."""
    x, r = _inputs((1, 2, 4, 8), torch.float32)
    with pytest.raises(RuntimeError, match="inference only"):
        bilinear_x2_add(x.requires_grad_(), r)
    with torch.no_grad():
        assert bilinear_x2_add(x, r).shape == r.shape


def test_cpu_path_counts_no_launch():
    before = bilinear_x2_add.launches
    x, r = _inputs((2, 3, 4, 8), torch.bfloat16)
    bilinear_x2_add(x, r)
    assert bilinear_x2_add.launches == before


def test_vector_path_rule():
    """The vector path needs W % 4 == 0 and 16-byte aligned tensors."""
    x, r = _inputs((1, 2, 4, 8), torch.bfloat16)
    assert vector_path(x, r, torch.empty_like(r))
    x6, r6 = _inputs((1, 2, 4, 6), torch.bfloat16)
    assert not vector_path(x6, r6, torch.empty_like(r6))
    flat = torch.zeros(1 + x.numel(), dtype=torch.bfloat16)
    shifted = flat[1:].view(x.shape)  # 2 bytes past an aligned start
    assert not vector_path(shifted, r, torch.empty_like(r))


@pytest.fixture(scope="module")
def live_model():
    """``init_cdan`` with BatchNorm statistics redrawn so the decoder's ReLUs
    keep the restoration path live (``chip_smoke.live_cdan``'s draw)."""
    gen = torch.Generator().manual_seed(0)
    model = init_cdan(gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.05, 0.05, generator=gen)
                m.running_var.uniform_(0.1, 0.3, generator=gen)
    return model.eval()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("builder", ["build_fast_apply", "build_fast_apply_cm"])
def test_built_forwards_match_module_through_the_fused_call(live_model, builder, dtype,
                                                            monkeypatch):
    """Both built forwards, whose decoders add their skips inside the fused
    call (three calls a forward), still match the f32 ``CDAN`` module to the
    bf16 bar of tests/test_torch_cdan.py (the DenseBlocks hold bf16 weights
    at either dtype)."""
    calls = []

    def counted(x, r):
        calls.append((tuple(x.shape), tuple(r.shape)))
        return bilinear_x2_add(x, r)

    monkeypatch.setattr(cdan_fast, "bilinear_x2_add", counted)
    x = torch.rand((2, 16, 32, 3), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        ref = live_model(x)
    got = getattr(cdan_fast, builder)(live_model, dtype, "cpu")(x)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert ref.std() > 0.05  # the restoration path is live, not a constant map
    assert calls == [((2, 128, 2, 4), (2, 128, 4, 8)), ((2, 64, 4, 8), (2, 64, 8, 16)),
                     ((2, 3, 8, 16), (2, 3, 16, 32))]
    err = (got - ref).abs()
    assert err.max() < 2e-2 and err.mean() < 2e-3, (err.max(), err.mean())
