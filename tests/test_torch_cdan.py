"""PyTorch port: CDAN, the weight bridge and the serving slice vs the JAX package.

One JAX CDAN (16×32, random running stats) is shared by the whole module; its
weights reach the port through ``utils/jax_port.py``.
"""

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
from multi_degradation_image_enhancement_tpu_torch.models.cdan_fast import build_serving_apply
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.noise import bits_to_noise01
from multi_degradation_image_enhancement_tpu_torch.utils.jax_port import flax_to_state_dict

H, W = 16, 32
N_PARAMS = 3_585_663


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
    both sides; the port's forward is ``build_serving_apply`` in f32 (plain
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
    forward = build_serving_apply(port_cdan, torch.float32, "cpu")
    got = forward(torch.from_numpy(jax_degraded)).numpy()
    err = np.abs(got - want)
    assert got.shape == want.shape
    assert err.max() <= 1e-3 and err.mean() <= 1e-4


def test_bf16_serving_forward_matches_jax(jax_cdan, port_cdan):
    """At bf16 the serving forward holds the bf16 bar of tests/test_cdan_fast.py:36-37."""
    x = np.random.RandomState(3).rand(2, H, W, 3).astype(np.float32)
    want = jax_cdan[2](x)
    got = build_serving_apply(port_cdan, torch.bfloat16, "cpu")(torch.from_numpy(x))
    assert got.dtype == torch.float32
    err = np.abs(got.numpy() - want)
    assert err.max() < 2e-2 and err.mean() < 2e-3
