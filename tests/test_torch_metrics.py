"""PyTorch port: LPIPS-alex (ops/perceptual.py) and the metrics pipeline
(ops/metrics.py) vs the JAX package, on the same numpy images and the same
LPIPS weights: carried across from JAX's variables, or loaded by both
packages from one npz in ``$MDIE_WEIGHTS_DIR`` written from JAX's params."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_degradation_image_enhancement_tpu.ops.metrics import (
    build_metrics_pipeline as jax_build_metrics,
)
from multi_degradation_image_enhancement_tpu.ops.perceptual import LPIPS as JaxLPIPS
from multi_degradation_image_enhancement_tpu_torch.ops import perceptual
from multi_degradation_image_enhancement_tpu_torch.ops.metrics import build_metrics_pipeline
from multi_degradation_image_enhancement_tpu_torch.ops.perceptual import (
    LPIPS,
    init_frozen_params,
    weight_status,
)

METRICS_CFG = {"enabled": True, "items": [
    {"name": "psnr"}, {"name": "ssim"}, {"name": "lpips", "args": {"net": "alex"}}]}
# f32 on both sides; AlexNet's convolutions sum in another order
LPIPS_TOL = 1e-5


@pytest.fixture(scope="module")
def jax_lpips_npz(tmp_path_factory):
    """A JAX LPIPS-alex's params (key 3, ``lin`` drawn U(0, 0.1)), as the
    npz the JAX package's weight loader reads: ``/``-joined Flax paths."""
    module = JaxLPIPS(net_type="alex")
    z = jnp.zeros((1, 64, 64, 3), jnp.float32)
    params = module.init(jax.random.key(3), z, z)["params"]
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert "net/conv_0/kernel" in flat and "lin_4" in flat
    wdir = tmp_path_factory.mktemp("weights")
    np.savez(wdir / "lpips_alex.npz", **flat)
    return module, params, wdir


def _images(seed, b=3, h=64, w=80):
    rng = np.random.RandomState(seed)
    x = rng.rand(b, h, w, 3).astype(np.float32)
    y = np.clip(x + 0.1 * rng.randn(b, h, w, 3), 0.0, 1.0).astype(np.float32)
    return x, y


def test_lpips_alex_with_jax_weights_from_npz(jax_lpips_npz, monkeypatch):
    module, params, wdir = jax_lpips_npz
    monkeypatch.setenv("MDIE_WEIGHTS_DIR", str(wdir))
    port = init_frozen_params(LPIPS("alex"), "lpips_alex.npz")
    assert weight_status()["lpips_alex.npz"] == "pretrained"
    assert not any(p.requires_grad for p in port.parameters())
    np.testing.assert_array_equal(port.lin_2.numpy(), np.asarray(params["lin_2"]))
    x, y = _images(0)
    want = np.asarray(module.apply({"params": params}, jnp.asarray(x), jnp.asarray(y)))
    got = port(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.shape == (3,) and np.all(want > 0)
    np.testing.assert_allclose(got, want, rtol=LPIPS_TOL, atol=1e-7)


def test_lpips_random_frozen_fallback_and_other_nets(monkeypatch, tmp_path):
    """No npz: the seeded random weights (the same draws every time),
    status ``random_frozen``, for each backbone; an unknown one raises
    (tests/test_torch_lpips_backbones.py holds vgg and squeeze against
    JAX)."""
    monkeypatch.setenv("MDIE_WEIGHTS_DIR", str(tmp_path))
    a = init_frozen_params(LPIPS("alex"), "lpips_alex.npz")
    assert weight_status()["lpips_alex.npz"] == "random_frozen"
    b = init_frozen_params(LPIPS("alex"), "lpips_alex.npz")
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), name
    assert 0.0 <= float(a.lin_0.min()) and float(a.lin_0.max()) < 0.1
    x, y = _images(1, b=2)
    d = a(torch.from_numpy(x), torch.from_numpy(y))
    assert d.shape == (2,) and bool(torch.isfinite(d).all()) and float(d.min()) > 0
    assert float(a(torch.from_numpy(x), torch.from_numpy(x)).abs().max()) == 0.0
    for net in ("vgg", "squeeze"):
        m = init_frozen_params(LPIPS(net), f"lpips_{net}.npz")
        assert weight_status()[f"lpips_{net}.npz"] == "random_frozen"
        d = m(torch.from_numpy(x), torch.from_numpy(y))
        assert d.shape == (2,) and bool(torch.isfinite(d).all()) and float(d.min()) > 0
    with pytest.raises(ValueError, match="Unknown LPIPS net_type"):
        LPIPS("resnet")


def test_npz_shape_mismatch_raises(tmp_path, monkeypatch):
    np.savez(tmp_path / "lpips_alex.npz", **{"lin_0": np.zeros((3, 1), np.float32)})
    monkeypatch.setenv("MDIE_WEIGHTS_DIR", str(tmp_path))
    with pytest.raises(ValueError, match="Shape mismatch for lin_0"):
        init_frozen_params(LPIPS("alex"), "lpips_alex.npz")
    perceptual._WEIGHT_STATUS.pop("lpips_alex.npz", None)


@pytest.mark.parametrize("with_mask", [False, True], ids=["all", "masked"])
def test_metrics_pipeline_matches_jax(jax_lpips_npz, monkeypatch, with_mask):
    """PSNR, SSIM and LPIPS through both pipelines, both loading the npz;
    with a mask that drops the padded last sample.  The same keys in the same
    order; values within 1e-4 dB (PSNR) and 1e-5 (SSIM, LPIPS)."""
    _, _, wdir = jax_lpips_npz
    monkeypatch.setenv("MDIE_WEIGHTS_DIR", str(wdir))
    x, y = _images(2)
    mask = np.array([1.0, 1.0, 0.0], np.float32) if with_mask else None
    want = jax_build_metrics(METRICS_CFG)(
        jnp.asarray(x), jnp.asarray(y), mask=None if mask is None else jnp.asarray(mask))
    got = build_metrics_pipeline(METRICS_CFG, "cpu")(
        torch.from_numpy(x), torch.from_numpy(y), mask=None if mask is None else torch.from_numpy(mask))
    assert list(got) == list(want) == ["psnr", "ssim", "lpips"]
    assert abs(float(got["psnr"]) - float(want["psnr"])) <= 1e-4
    for k in ("ssim", "lpips"):
        assert abs(float(got[k]) - float(want[k])) <= 1e-5, k
    if with_mask:  # the masked-out sample counts for nothing
        full = build_metrics_pipeline(METRICS_CFG, "cpu")(torch.from_numpy(x[:2]),
                                                          torch.from_numpy(y[:2]))
        assert abs(float(full["lpips"]) - float(got["lpips"])) <= 1e-6


def test_metrics_pipeline_modes_and_errors():
    """Items are a list: the same name under both modes survives, and the
    mode filter picks per call; paired metrics need targets."""
    cfg = {"items": [{"name": "psnr"}, {"name": "psnr", "mode": "unpaired"}]}
    pipe = build_metrics_pipeline(cfg, "cpu")
    assert len(pipe.metrics) == 2
    x, y = _images(3, b=2, h=16, w=16)
    assert list(pipe(torch.from_numpy(x), torch.from_numpy(y))) == ["psnr"]
    with pytest.raises(ValueError, match="requires targets"):
        pipe(torch.from_numpy(x), None, is_paired=False)
    assert build_metrics_pipeline({"enabled": False, "items": cfg["items"]}, "cpu").metrics == []
    with pytest.raises(ValueError, match="Unknown metric"):
        build_metrics_pipeline({"items": [{"name": "fid"}]}, "cpu")
