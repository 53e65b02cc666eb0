"""PyTorch port: VGG19Features and the ``vgg_perceptual`` / ``lpips`` loss
terms (ops/perceptual.py, ops/losses.py) vs the JAX package, on the same
weights: carried across with ``utils.jax_port.load_feature_net``, or read by
both packages from one npz in ``$MDIE_WEIGHTS_DIR``.  f32 on both sides, at
2×32×48; bar 1e-4 relative to the largest value (features, loss values, the
gradient with respect to the outputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_degradation_image_enhancement_tpu.ops import perceptual as jperc
from multi_degradation_image_enhancement_tpu.ops.losses import build_loss_pipeline as jax_losses
from multi_degradation_image_enhancement_tpu_torch.ops import perceptual
from multi_degradation_image_enhancement_tpu_torch.ops.losses import build_loss_pipeline
from multi_degradation_image_enhancement_tpu_torch.utils.jax_port import load_feature_net
from tests.torch_train_cli import load_shipped

B, H, W = 2, 32, 48


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def jax_params():
    """JAX-initialised VGG19Features (20 layers) and LPIPS-alex parameters."""
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    vgg = jperc.VGG19Features(num_layers=20).init(jax.random.key(3), x)["params"]
    z = jnp.zeros((1, 64, 64, 3), jnp.float32)
    lp = jperc.LPIPS(net_type="alex").init(jax.random.key(4), z, z)["params"]
    return jax.tree.map(np.asarray, vgg), jax.tree.map(np.asarray, lp)


@pytest.fixture()
def weights_dir(jax_params, tmp_path, monkeypatch):
    """Both packages read the same npz files: ``vgg19_features.npz`` with
    ``conv_{i}/kernel`` keys (no ``net/``), ``lpips_alex.npz`` with ``net/…``."""
    vgg, lp = jax_params
    np.savez(tmp_path / "vgg19_features.npz", **_flat(vgg))
    np.savez(tmp_path / "lpips_alex.npz", **_flat(lp))
    monkeypatch.setenv("MDIE_WEIGHTS_DIR", str(tmp_path))
    return tmp_path


def _pair(seed=0):
    rng = np.random.RandomState(seed)
    tgt = rng.rand(B, H, W, 3).astype(np.float32)
    return np.clip(tgt + 0.1 * rng.randn(B, H, W, 3), 0, 1).astype(np.float32), tgt


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / max(np.abs(np.asarray(want)).max(), 1e-12))


def test_vgg19_features_match_jax_on_carried_weights(jax_params):
    vgg, _ = jax_params
    x, _ = _pair(1)
    want = np.asarray(jperc.VGG19Features(num_layers=20).apply({"params": vgg}, jnp.asarray(x)))
    module = load_feature_net(perceptual.VGG19Features(20), vgg)
    with torch.no_grad():
        got = module(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (B, H // 8, W // 8, 512)  # ends on conv_19
    assert _rel(got, want) <= 1e-4


def test_lpips_matches_jax_on_carried_weights(jax_params):
    _, lp = jax_params
    x, y = _pair(2)
    want = np.asarray(jperc.LPIPS(net_type="alex").apply({"params": lp}, jnp.asarray(x), jnp.asarray(y)))
    module = load_feature_net(perceptual.LPIPS("alex"), lp)
    with torch.no_grad():
        got = module(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.shape == (B,) and _rel(got, want) <= 1e-4


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("term", ["vgg_perceptual", "lpips"])
def test_loss_term_value_and_gradient_match_jax(weights_dir, term, masked):
    args = {"layers": 20} if term == "vgg_perceptual" else {"net": "alex"}
    cfg = {"terms": [{"name": term, "weight": 1.0, "args": args}]}
    out, tgt = _pair(3)
    mask = np.array([1.0, 0.0], np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    jpipe = jax_losses(cfg)
    want = float(jpipe(jnp.asarray(out), jnp.asarray(tgt), mask=jm)[term])
    jgrad = jax.grad(lambda o: jpipe(o, jnp.asarray(tgt), mask=jm)["total"])(jnp.asarray(out))
    pipe = build_loss_pipeline(cfg, "cpu")
    o = torch.from_numpy(out.copy()).requires_grad_(True)
    got = pipe(o, torch.from_numpy(tgt), mask=None if mask is None else torch.from_numpy(mask))
    got["total"].backward()
    assert abs(float(got[term]) - want) <= 1e-4 * abs(want)
    assert _rel(o.grad.numpy(), jgrad) <= 1e-4
    if masked:  # the masked sample gets no gradient
        assert float(o.grad[1].abs().max()) == 0.0


def test_jpeg_config_loss_pipeline_matches_jax(weights_dir):
    """l1 + 0.25·vgg_perceptual + 0.5·ssim + 0.5·lpips, every component."""
    cfg = load_shipped("jpeg_synthetic")["loss"]
    out, tgt = _pair(4)
    mask = np.array([1.0, 1.0], np.float32)
    want = jax_losses(cfg)(jnp.asarray(out), jnp.asarray(tgt), mask=jnp.asarray(mask))
    got = build_loss_pipeline(cfg, "cpu")(torch.from_numpy(out), torch.from_numpy(tgt),
                                          mask=torch.from_numpy(mask))
    assert list(got) == ["l1", "vgg_perceptual", "ssim", "lpips", "total"]
    for k in got:
        assert abs(float(got[k]) - float(want[k])) <= 1e-4 * abs(float(want[k])), k


def test_frozen_networks_status_and_gradients(weights_dir, monkeypatch):
    """With the npz: ``pretrained``; without: ``random_frozen``.  Either way
    the networks take no gradient and sit on the pipeline's device."""
    cfg = load_shipped("jpeg_synthetic")["loss"]
    build_loss_pipeline(cfg, "cpu")
    status = perceptual.weight_status()
    assert status["vgg19_features.npz"] == "pretrained" and status["lpips_alex.npz"] == "pretrained"
    monkeypatch.setenv("MDIE_WEIGHTS_DIR", str(weights_dir / "absent"))
    pipe = build_loss_pipeline(cfg, "cpu")
    assert perceptual.weight_status()["vgg19_features.npz"] == "random_frozen"
    out, tgt = _pair(5)
    o = torch.from_numpy(out).requires_grad_(True)
    pipe(o, torch.from_numpy(tgt))["total"].backward()
    assert o.grad is not None and float(o.grad.abs().max()) > 0
    nets = [c.cell_contents for t in pipe.terms for c in (t.fn.__closure__ or ())
            if isinstance(c.cell_contents, torch.nn.Module)]
    assert len(nets) == 2
    for net in nets:
        assert all(not p.requires_grad and p.grad is None and p.device.type == "cpu"
                   for p in net.parameters())


def test_load_feature_net_checks_names_and_shapes(jax_params):
    vgg, _ = jax_params
    with pytest.raises(ValueError, match="parameter names differ"):
        load_feature_net(perceptual.VGG19Features(10), vgg)
    bad = jax.tree.map(lambda a: a, vgg)
    bad["conv_0"]["bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_feature_net(perceptual.VGG19Features(20), bad)
