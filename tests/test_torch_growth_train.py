"""PyTorch port: the trainable growth layer (``ops/cuda/growth_train.py``) vs
the JAX package's ``growth_layer_cm`` (Pallas, interpret mode).

On the CPU the port's ``growth_layer`` is its plain version, which rounds where
the kernels round (bf16 activated value, weights and incoming gradient; f32
accumulation), so it is held to the JAX kernels at 2e-3 of the scale and to
the f32 autodiff oracle at the JAX package's own 2e-2 bound
(tests/test_growth_train.py:56).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_degradation_image_enhancement_tpu.ops.pallas import growth_train as jgt
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.growth_train import (
    growth_layer,
    growth_layer_bwd,
    growth_layer_fwd,
)
from multi_degradation_image_enhancement_tpu_torch.utils.jax_port import conv_to_hwio

TIGHT = 2e-3  # port vs JAX kernels: same rounding points, other summation order
CLASS = 2e-2  # either vs the f32 oracle: bf16 operands (tests/test_growth_train.py:56)


def _inputs(B, c, h, w, seed):
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.randn(B, c, h, w).astype(np.float32),
        a=rng.uniform(0.5, 1.5, c).astype(np.float32),
        b=(rng.randn(c) * 0.1).astype(np.float32),
        w=(rng.randn(16, c, 3, 3) * 0.1).astype(np.float32),  # OIHW
        bias=(rng.randn(16) * 0.1).astype(np.float32),
        r=rng.randn(B, 16, h, w).astype(np.float32),  # cotangent
    )


def _jax_layer(d, interpret=True):
    """(g, (dx, da, db, dK_hwio, dbias)) of the JAX kernel, on [B, c, HW]."""
    B, c, h, w = d["x"].shape
    cp = jgt._ceil16(c)

    def f(x, a, b, k, bias):
        g = jgt.growth_layer_cm(x, a, b, jgt.pack_growth(k, cp), bias, c, (h, w), interpret)
        return g

    args = (jnp.asarray(d["x"].reshape(B, c, h * w)), jnp.asarray(d["a"]), jnp.asarray(d["b"]),
            jnp.asarray(conv_to_hwio(d["w"])), jnp.asarray(d["bias"]))
    g = f(*args)
    r = jnp.asarray(d["r"].reshape(B, 16, h * w))
    grads = jax.grad(lambda *p: jnp.sum(f(*p) * r), argnums=(0, 1, 2, 3, 4))(*args)
    return np.asarray(g).reshape(B, 16, h, w), [np.asarray(t) for t in grads]


def _oracle(d):
    """f32 autodiff of the same layer with no rounding anywhere."""
    t = {k: torch.from_numpy(v).requires_grad_(k != "r") for k, v in d.items()}
    v = torch.relu(t["x"] * t["a"][None, :, None, None] + t["b"][None, :, None, None])
    g = torch.nn.functional.conv2d(v, t["w"], t["bias"], padding=1)
    (g * t["r"]).sum().backward()
    return g.detach().numpy(), [t[k].grad.numpy() for k in ("x", "a", "b", "w", "bias")]


def _port(d):
    t = {k: torch.from_numpy(v).requires_grad_(k != "r") for k, v in d.items()}
    g = growth_layer(t["x"], t["a"], t["b"], t["w"], t["bias"])
    (g * t["r"]).sum().backward()
    return g.detach().numpy(), [t[k].grad.numpy() for k in ("x", "a", "b", "w", "bias")]


def _close(got, want, tol, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * max(scale, 1.0), f"{what}: {err} vs scale {scale}"


def _compare(d, jg, jgrads):
    B, c, h, w = d["x"].shape
    pg, pgrads = _port(d)
    og, ograds = _oracle(d)
    assert pg.shape == (B, 16, h, w) and pg.dtype == np.float32
    _close(pg, jg, TIGHT, "g vs JAX")
    _close(pg, og, CLASS, "g vs oracle")
    jdx, jda, jdb, jdk, jdbias = jgrads
    want = [jdx.reshape(B, c, h, w), jda, jdb, None, jdbias]
    for name, got, jw, ow in zip(("dx", "da", "db", "dw", "dbias"), pgrads, want, ograds):
        if jw is not None:
            _close(got, jw, TIGHT, f"{name} vs JAX")
        _close(got, ow, CLASS, f"{name} vs oracle")
    # dw maps back to the JAX HWIO kernel gradient through the bridge's layout
    _close(conv_to_hwio(pgrads[3]), jdk, TIGHT, "dw (HWIO) vs JAX dK")


@pytest.mark.parametrize("B,c,h,w", [(2, 19, 8, 16), (4, 3, 8, 8), (1, 64, 16, 16)])
def test_growth_layer_matches_jax(B, c, h, w):
    d = _inputs(B, c, h, w, seed=c)
    _compare(d, *_jax_layer(d))


def test_growth_layer_tiled_matches_jax(monkeypatch):
    """The JAX row-tiled kernels (#5, #7), forced at 4-row tiles, against the
    same port function (the CUDA kernels have no tiled variant)."""
    monkeypatch.setattr(jgt, "_FORCE_TILE_ROWS", 4)
    d = _inputs(2, 35, 16, 8, seed=7)
    _compare(d, *_jax_layer(d))


def test_growth_layer_cpu_counts_no_launch():
    d = _inputs(1, 3, 8, 8, seed=1)
    f0, b0 = growth_layer_fwd.launches, growth_layer_bwd.launches
    _port(d)
    assert (growth_layer_fwd.launches, growth_layer_bwd.launches) == (f0, b0)
