"""PyTorch port: CDAN, the weight bridge and the serving slice vs the JAX package.

One JAX CDAN (16×32, random running stats) is shared by the whole module; its
weights reach the port through ``utils/jax_port.py``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_degradation_image_enhancement_tpu.models.cdan import CDAN as JaxCDAN
from multi_degradation_image_enhancement_tpu.ops.pallas.noise import _bits_to_noise01
from multi_degradation_image_enhancement_tpu.utils.torch_port import port_reference_cdan
from multi_degradation_image_enhancement_tpu_torch import serving
from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN
from multi_degradation_image_enhancement_tpu_torch.models import cdan_fast
from multi_degradation_image_enhancement_tpu_torch.models.cdan_fast import (
    build_fast_apply,
    build_serving_apply,
)
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.noise import bits_to_noise01
from multi_degradation_image_enhancement_tpu_torch.utils.jax_port import flax_to_state_dict

H, W = 16, 32
N_PARAMS = 3_585_663
# the JAX package's served DenseBlocks: f32 activations, whatever the port's tuning file chose
PER_BLOCK_ACT = {"bf16_act": False, "k_stack_max_ci": 56}


@pytest.fixture(scope="module")
def jax_cdan():
    """(module, variables as NumPy, jitted eval apply) of one JAX CDAN."""
    m = JaxCDAN(dtype=jnp.float32)
    x = jnp.zeros((1, H, W, 3), jnp.float32)
    v = jax.jit(lambda k: m.init({"params": k}, x, train=False))(jax.random.key(0))
    rng = np.random.RandomState(0)
    bs = jax.tree.map(lambda t: rng.uniform(0.5, 1.5, t.shape).astype(np.float32), v["batch_stats"])
    variables = {"params": jax.tree.map(np.asarray, v["params"]), "batch_stats": bs}
    apply = jax.jit(lambda vv, z: m.apply(vv, z, train=False))
    return m, variables, lambda z: np.asarray(apply(variables, jnp.asarray(z)))


@pytest.fixture(scope="module")
def port_cdan(jax_cdan):
    model = CDAN()
    model.load_state_dict(flax_to_state_dict(jax_cdan[1]), strict=True)
    return model.eval()


def _tree_leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def test_param_count(jax_cdan, port_cdan):
    assert sum(p.numel() for p in CDAN().parameters()) == N_PARAMS
    assert sum(p.numel() for p in port_cdan.parameters()) == N_PARAMS
    jax_count = sum(np.size(leaf) for _, leaf in _tree_leaves(jax_cdan[1]["params"]))
    assert jax_count == N_PARAMS


def test_bridge_round_trip_is_bit_exact(jax_cdan, port_cdan):
    """Flax tree → port state_dict → JAX ``port_reference_cdan`` → the same
    tree, bit for bit (pins the decoder deconv flip)."""
    _, variables, _ = jax_cdan
    sd = {k: v.numpy() for k, v in port_cdan.state_dict().items()}
    back = port_reference_cdan(sd, variables)
    want, got = _tree_leaves(variables), _tree_leaves(back)
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, a), (_, b) in zip(want, got):
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=jax.tree_util.keystr(path))


def test_module_matches_jax(jax_cdan, port_cdan):
    x = np.random.RandomState(1).rand(2, H, W, 3).astype(np.float32)
    want = jax_cdan[2](x)
    with torch.no_grad():
        got = port_cdan(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= 2e-4  # README.md:34, the reference-transplant bar


def test_serving_slice_matches_jax(jax_cdan, port_cdan):
    """Clean batch → noise degrade on the same bits → restoring forward, on
    both sides; the port's forward is the per-block ``build_fast_apply`` in
    f32 with f32 activations (the JAX package's served one; plain
    DenseBlocks on the CPU), fed the JAX-degraded batch."""
    b = 2
    clean = serving.clean_batch(b, H, W).numpy()
    rng = np.random.default_rng(2)
    n_pairs = H * W * 3 // 2
    bits1 = rng.integers(0, 2**32, (b, n_pairs), dtype=np.uint32)
    bits2 = rng.integers(0, 2**32, (b, n_pairs), dtype=np.uint32)
    std = np.array([15.0, 45.0], np.float32)

    jax_degraded = np.stack([
        np.asarray(_bits_to_noise01(
            jnp.asarray(bits1[i].reshape(H // 2, W * 3)), jnp.asarray(bits2[i].reshape(H // 2, W * 3)),
            jnp.asarray(clean[i].reshape(H, W * 3)), std[i], 1.0 / 255.0,
        )).reshape(H, W, 3)
        for i in range(b)
    ])
    port_degraded = bits_to_noise01(
        torch.from_numpy(bits1.view(np.int32)), torch.from_numpy(bits2.view(np.int32)),
        torch.from_numpy(clean), torch.from_numpy(std), 1.0 / 255.0,
    ).numpy()
    diff = np.abs(port_degraded - jax_degraded)
    assert (diff > 1e-6).mean() < 1e-3 and diff.max() <= 1.0 / 255.0 + 1e-6

    want = jax_cdan[2](jax_degraded)
    forward = build_fast_apply(port_cdan, torch.float32, "cpu", **PER_BLOCK_ACT)
    got = forward(torch.from_numpy(jax_degraded)).numpy()
    err = np.abs(got - want)
    assert got.shape == want.shape
    assert err.max() <= 1e-3 and err.mean() <= 1e-4


def test_bf16_serving_forward_matches_jax(jax_cdan, port_cdan):
    """At bf16 the per-block forward with f32 activations (the JAX package's
    served one) holds the bf16 bar of tests/test_cdan_fast.py:36-37."""
    x = np.random.RandomState(3).rand(2, H, W, 3).astype(np.float32)
    want = jax_cdan[2](x)
    got = build_fast_apply(port_cdan, torch.bfloat16, "cpu", **PER_BLOCK_ACT)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    err = np.abs(got.numpy() - want)
    assert err.max() < 2e-2 and err.mean() < 2e-3


@pytest.fixture(scope="module")
def live_cdan(jax_cdan):
    """The module's JAX CDAN with BN statistics that keep the whole path live
    (running means U(-0.1, 0.1), variances U(0.3, 1.0)): at the U(0.5, 1.5)
    means of ``jax_cdan`` the decoder's ReLUs zero everything but the global
    residual.  (JAX variables, the port's CDAN, JAX module apply.)"""
    m, variables, _ = jax_cdan
    rng = np.random.RandomState(5)

    def draw(path, t):
        if jax.tree_util.keystr(path).endswith("['mean']"):
            return rng.uniform(-0.1, 0.1, t.shape).astype(np.float32)
        return rng.uniform(0.3, 1.0, t.shape).astype(np.float32)

    live = {"params": variables["params"],
            "batch_stats": jax.tree_util.tree_map_with_path(draw, variables["batch_stats"])}
    model = CDAN()
    model.load_state_dict(flax_to_state_dict(live), strict=True)
    apply = jax.jit(lambda vv, z: m.apply(vv, z, train=False))
    return live, model.eval(), lambda z: np.asarray(apply(live, jnp.asarray(z)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cm_forward_matches_jax_and_module(live_cdan, dtype):
    """The all-channel-major forward at 1×16×32, weights carried across and
    BN statistics perturbed, every conv after conv1 through the #8 plain
    version, against JAX ``build_fast_apply_cm`` (interpret mode, its
    default conv table) and against the port's f32 ``CDAN``, with the CM
    forward's bar (tests/test_cdan_fast.py:108-109)."""
    from multi_degradation_image_enhancement_tpu.models.cdan_fast import (
        build_fast_apply_cm as jax_build_cm,
    )

    variables, model, apply_module = live_cdan
    x = np.random.RandomState(4).rand(1, H, W, 3).astype(np.float32)
    want = np.asarray(jax_build_cm(variables, jnp.float32, interpret=True)(jnp.asarray(x)))
    module = apply_module(x)
    assert module.std() > 0.1  # the restoration path is live, not a constant map
    assert np.abs(want - module).max() < 2e-2

    with torch.no_grad():
        ref = model(torch.from_numpy(x)).numpy()
    got = cdan_fast.build_fast_apply_cm(model, dtype, "cpu")(torch.from_numpy(x))
    assert got.shape == (1, H, W, 3) and got.dtype == torch.float32
    for other in (want, ref):
        err = np.abs(got.numpy() - other)
        assert err.max() < 2e-2 and err.mean() < 2e-3, (err.max(), err.mean())


def test_serving_apply_dispatches_by_preference_and_shape(port_cdan, tmp_path, monkeypatch):
    """``build_serving_apply``: the CM forward for every shape it takes and
    the per-block forward for the rest, built once, at the first call that
    needs it and outside ``inference_mode``; the tuning file that
    ``MDIE_SERVING_TUNING`` names reaches both builds (tests/test_cdan_fast.py:112-139)."""
    calls, builds = [], []

    def builder(name):
        def build(*args, **kw):
            builds.append((name, kw, torch.is_inference_mode_enabled()))
            return lambda x: calls.append(name)
        return build

    monkeypatch.setattr(cdan_fast, "build_fast_apply_cm", builder("cm"))
    monkeypatch.setattr(cdan_fast, "build_fast_apply", builder("v1"))
    tuning = tmp_path / "tuning.json"
    tuning.write_text(json.dumps({"db_bf16_act": True, "db_k_stack_max_ci": 40, "db_nhwc_io": True}))
    monkeypatch.setenv(cdan_fast.TUNING_ENV, str(tuning))
    act = {"bf16_act": True, "k_stack_max_ci": 40}

    fn = cdan_fast.build_serving_apply(port_cdan, torch.float32, "cpu")
    assert builds == [("cm", act, False)]  # no per-block forward yet
    fn(torch.zeros(1, 32, 48, 3))  # supported -> cm
    assert len(builds) == 1
    with torch.inference_mode():
        fn(torch.zeros(1, 8, 8, 3))  # w % 16 != 0 -> v1, built now
    assert builds == [("cm", act, False), ("v1", act, False)]
    fn(torch.zeros(1, 12, 32, 3))  # h % 8 != 0 -> v1, not built again
    fn(torch.zeros(1, 256, 384, 3))  # the JAX package's VMEM bound says no; the port takes it
    assert len(builds) == 2
    assert calls == ["cm", "v1", "v1", "cm"]


@pytest.mark.parametrize("tuning_file", ["stale_prefer_cm_false", "no_tuning_file"])
def test_served_forward_is_chosen_by_shape_alone(live_cdan, tmp_path, monkeypatch, tuning_file):
    """Whatever a tuning file says of the forward (an older file's
    ``"prefer_cm": false``, or no file at all), ``build_serving_apply``
    serves the CM forward at a shape it takes (32×48) and the per-block
    forward at one it does not (40×40: W no multiple of 16), bit for bit."""
    model = live_cdan[1]
    path = tmp_path / "serving_tuning.json"
    if tuning_file == "stale_prefer_cm_false":
        path.write_text(json.dumps({"prefer_cm": False, "db_bf16_act": True,
                                    "db_k_stack_max_ci": 56}))
    monkeypatch.setenv(cdan_fast.TUNING_ENV, str(path))
    assert cdan_fast.serving_tuning() == ({"db_bf16_act": True, "db_k_stack_max_ci": 56}
                                          if path.exists() else
                                          {"db_bf16_act": False, "db_k_stack_max_ci": 0})
    served = build_serving_apply(model, torch.float32, "cpu")
    rng = np.random.RandomState(6)
    x_cm = torch.from_numpy(rng.rand(1, 32, 48, 3).astype(np.float32))
    x_pb = torch.from_numpy(rng.rand(1, 40, 40, 3).astype(np.float32))
    cm = cdan_fast.build_fast_apply_cm(model, torch.float32, "cpu")
    per_block = build_fast_apply(model, torch.float32, "cpu")
    assert torch.equal(served(x_cm), cm(x_cm))
    assert not torch.equal(served(x_cm), per_block(x_cm))  # the two forwards round apart
    assert torch.equal(served(x_pb), per_block(x_pb))
