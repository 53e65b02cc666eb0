"""PyTorch port: the LPIPS ``vgg`` and ``squeeze`` backbones
(``ops/perceptual.py`` ``VGG16Taps``, ``Fire``, ``SqueezeTaps``,
``_max_pool_ceil``) against the JAX package's, on the JAX modules' random
init carried across (``utils.jax_port.load_feature_net``) or read by both
packages from one npz in ``$MDIE_WEIGHTS_DIR``.  f32 on both sides; bar 1e-5
relative (the metrics test's LPIPS bar), at 32×48 and at the odd 33×47
where SqueezeNet's ceil-mode pools pad.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_degradation_image_enhancement_tpu.ops import perceptual as jperc
from multi_degradation_image_enhancement_tpu.ops.losses import build_loss_pipeline as jax_losses
from multi_degradation_image_enhancement_tpu.ops.metrics import (
    build_metrics_pipeline as jax_metrics,
)
from multi_degradation_image_enhancement_tpu_torch.ops import perceptual
from multi_degradation_image_enhancement_tpu_torch.ops.losses import build_loss_pipeline
from multi_degradation_image_enhancement_tpu_torch.ops.metrics import build_metrics_pipeline
from multi_degradation_image_enhancement_tpu_torch.utils.jax_port import load_feature_net

NETS = ("vgg", "squeeze")
SIZES = [(32, 48), (33, 47)]


@pytest.fixture(scope="module")
def jax_lpips():
    """Each backbone's JAX LPIPS module and its random-init params."""
    z = jnp.zeros((1, 32, 32, 3), jnp.float32)
    out = {}
    for k, net in enumerate(NETS):
        module = jperc.LPIPS(net_type=net)
        params = jax.jit(module.init)(jax.random.key(5 + k), z, z)["params"]
        out[net] = module, jax.tree.map(np.asarray, params)
    return out


def _pair(h, w, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(2, h, w, 3).astype(np.float32)
    return x, np.clip(x + 0.1 * rng.randn(2, h, w, 3), 0, 1).astype(np.float32)


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("net", NETS)
def test_lpips_backbone_taps_and_distance_match_jax(jax_lpips, net, hw):
    module, params = jax_lpips[net]
    port = load_feature_net(perceptual.LPIPS(net).eval(), params)
    x, y = _pair(*hw)
    backbone = {"vgg": jperc.VGG16Taps, "squeeze": jperc.SqueezeTaps}[net]()
    want_taps = jax.jit(backbone.apply)({"params": params["net"]}, jnp.asarray(x))
    with torch.no_grad():
        got_taps = port.net(torch.from_numpy(x).permute(0, 3, 1, 2))
        got = port(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert len(got_taps) == len(perceptual.LPIPS_CHANNELS[net]) == len(want_taps)
    for t, (g, w) in enumerate(zip(got_taps, want_taps)):
        w = np.asarray(w)
        assert g.shape == (2, w.shape[3], w.shape[1], w.shape[2]), (t, g.shape, w.shape)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w,
                                   rtol=1e-4, atol=1e-5 * np.abs(w).max())
    want = np.asarray(jax.jit(module.apply)({"params": params}, jnp.asarray(x), jnp.asarray(y)))
    assert np.all(want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("h", [3, 4, 5, 6, 7, 8, 9, 15, 16])
def test_max_pool_ceil_matches_jax_and_torch_ceil_mode(h):
    """JAX's −inf padding then VALID pool, at sides equal to the window and
    at odd and even sizes above it; torch's ``ceil_mode`` agrees there."""
    x = np.random.RandomState(h).randn(2, h, h + 2, 5).astype(np.float32) - 3.0  # all < 0
    want = np.asarray(jperc._max_pool_ceil(jnp.asarray(x), 3, 2))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = perceptual._max_pool_ceil(xt, 3, 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    np.testing.assert_array_equal(got.numpy(), torch.nn.functional.max_pool2d(
        xt, 3, 2, ceil_mode=True).numpy())


@pytest.mark.parametrize("net,key", [("vgg", "net"), ("squeeze", "net_type")])
def test_metric_with_net_reads_the_npz_like_jax(jax_lpips, net, key, tmp_path, monkeypatch):
    """``metrics.items[lpips].args`` ``net`` / ``net_type`` take the backbone,
    both packages reading ``lpips_<net>.npz``: the same metric value."""
    module, params = jax_lpips[net]
    np.savez(tmp_path / f"lpips_{net}.npz", **_flat(params))
    monkeypatch.setenv("MDIE_WEIGHTS_DIR", str(tmp_path))
    x, y = _pair(32, 48, seed=1)
    mcfg = {"enabled": True, "items": [{"name": "lpips", "args": {key: net}}]}
    want = jax_metrics(mcfg)(jnp.asarray(x), targets=jnp.asarray(y))
    got = build_metrics_pipeline(mcfg, "cpu")(torch.from_numpy(x), targets=torch.from_numpy(y))
    assert perceptual.weight_status()[f"lpips_{net}.npz"] == "pretrained"
    np.testing.assert_allclose(float(got["lpips"]), float(want["lpips"]), rtol=1e-5)


def test_loss_term_with_net_type_reads_the_npz_like_jax(jax_lpips, tmp_path, monkeypatch):
    """The ``lpips`` loss term with ``net_type: squeeze``: the same value and
    gradient with respect to the outputs as the JAX term."""
    module, params = jax_lpips["squeeze"]
    np.savez(tmp_path / "lpips_squeeze.npz", **_flat(params))
    monkeypatch.setenv("MDIE_WEIGHTS_DIR", str(tmp_path))
    x, y = _pair(32, 48, seed=2)
    lcfg = {"enabled": True, "terms": [{"name": "lpips", "weight": 0.5,
                                        "args": {"net_type": "squeeze"}}]}
    jpipe = jax_losses(lcfg)
    want_l, want_g = jax.value_and_grad(lambda o: jpipe(o, targets=jnp.asarray(y))["total"])(
        jnp.asarray(x))
    out = torch.from_numpy(x).requires_grad_(True)
    port = build_loss_pipeline(lcfg, "cpu")
    got_l = port(out, targets=torch.from_numpy(y))["total"]
    got_l.backward()
    assert [t.name for t in port.terms] == ["lpips"]
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-5)
    np.testing.assert_allclose(out.grad.numpy(), np.asarray(want_g), rtol=1e-4,
                               atol=1e-4 * float(np.abs(np.asarray(want_g)).max()))


def test_unknown_net_raises_the_jax_value_error():
    item = {"name": "lpips", "weight": 1.0, "args": {"net": "resnet"}}
    for build, cfg in ((build_metrics_pipeline, {"enabled": True, "items": [item]}),
                       (build_loss_pipeline, {"enabled": True, "terms": [item]})):
        with pytest.raises(ValueError, match=r"lpips net_type 'resnet' not supported "
                                             r"\(alex/vgg/squeeze\)\."):
            build(cfg, "cpu")
