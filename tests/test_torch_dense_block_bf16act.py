"""PyTorch port: the bf16-activation DenseBlock (``db_bf16_act``) against the
JAX package's ``_run_cm2(..., bf16_act=True, k_stack_max_ci=k)`` run in
interpret mode, and the serving forward with a ``db_bf16_act: true`` tuning
file against JAX's ``build_fast_apply`` under the same flag.

On the CPU the kernel wrapper takes its plain version, which rounds where the
CUDA kernel rounds (the product, then the sum, in bf16); ``chip_smoke.py``
holds the kernel to it on the card.  Tolerance: the DenseBlock kernels' own,
5e-2 max / 5e-3 mean (tests/test_pallas_kernels.py:135-160).  Both sides
hold features in bf16 and sum in other orders, so nearly every value
differs in its last bits (the counts are asserted below as measured, within
a margin); what the tests pin is that the flag and the K-stack threshold
move the same rounding points in both packages.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_degradation_image_enhancement_tpu.models.cdan import DenseBlock as JaxDenseBlock
from multi_degradation_image_enhancement_tpu.ops.pallas.dense_block_cm import (
    _run_cm2,
    pack_params_cm,
)
from multi_degradation_image_enhancement_tpu_torch.models.cdan import DenseBlock
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import (
    dense_block,
    pack_dense_block,
)
from multi_degradation_image_enhancement_tpu_torch.utils.jax_port import dense_block_state_dict

MAX_ERR, MEAN_ERR = 5e-2, 5e-3


def _live_block(c_in, h, w, seed):
    """A JAX DenseBlock whose BatchNorms are drawn so that every layer's
    ReLU passes part of its inputs and the output stays O(1) (Flax's init
    with positive means would zero the small blocks' output), its
    variables and an input."""
    rng = np.random.RandomState(seed)
    x = rng.rand(2, h, w, c_in).astype(np.float32)
    m = JaxDenseBlock(c_in, growth_rate=16)
    v = jax.jit(lambda k, z: m.init({"params": k}, z, train=False))(jax.random.key(seed), x)
    params = jax.tree.map(np.asarray, v["params"])
    stats = jax.tree.map(np.asarray, v["batch_stats"])
    for name in stats:
        c = stats[name]["mean"].shape[0]
        stats[name] = {"mean": rng.uniform(-0.2, 0.4, c).astype(np.float32),
                       "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
        params[name] = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                        "bias": rng.normal(0, 0.2, c).astype(np.float32)}
    return {"params": params, "batch_stats": stats}, x


def _jax_out(variables, x, c_in, bf16_act, k):
    b, h, w, _ = x.shape
    packed = pack_params_cm(variables["params"], variables["batch_stats"], c_in)
    xcm = jnp.asarray(x).transpose(0, 3, 1, 2).reshape(b, c_in, h * w)
    out = _run_cm2(xcm, packed, c_in=c_in, hw_shape=(h, w), bf16_act=bf16_act,
                   k_stack_max_ci=k, interpret=True)
    return np.asarray(out[:, :c_in]).reshape(b, c_in, h, w)


def _port_out(variables, x, c_in, bf16_act, k):
    block = DenseBlock(c_in, growth_rate=16)
    block.load_state_dict(dense_block_state_dict(variables), strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(torch.bfloat16)
    with torch.no_grad():
        return dense_block(xt, pack_dense_block(block.eval(), None, bf16_act, k)).float().numpy()


# (c_in, h, w): dense1's width, and final_dense's 3 channels, whose first three
# layers the shipped K-stack threshold (56) keeps in f32.
SHAPES = [(64, 32, 48), (3, 16, 24)]


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"c{s[0]}_{s[1]}x{s[2]}")
def outputs(request):
    """Both packages' outputs for bf16_act off and on, k ∈ {0, 56}; the
    f32-activation JAX run once (k moves no rounding point without the
    flag, as the port's plain version shows)."""
    c_in, h, w = request.param
    variables, x = _live_block(c_in, h, w, seed=c_in)
    res = {"c_in": c_in, ("jax", False): _jax_out(variables, x, c_in, False, 0)}
    for k in (0, 56):
        res[("jax", True, k)] = _jax_out(variables, x, c_in, True, k)
        for act in (False, True):
            res[("port", act, k)] = _port_out(variables, x, c_in, act, k)
    assert np.array_equal(res[("port", False, 0)], res[("port", False, 56)])
    return res


@pytest.mark.parametrize("k", [0, 56])
def test_plain_bf16_act_matches_jax_run_cm2(outputs, k):
    got, want = outputs[("port", True, k)], outputs[("jax", True, k)]
    assert want.std() > 1e-2  # a live block, not a constant map
    err = np.abs(got - want)
    assert err.max() <= MAX_ERR and err.mean() <= MEAN_ERR, (err.max(), err.mean())
    # nearly every value differs in its last bits (bf16 features, other sum orders)
    assert (got != want).mean() > 0.5
    # the f32-activation run is no closer to JAX's bf16-activation one
    off = np.abs(outputs[("port", False, k)] - want).mean()
    assert err.mean() <= off, (err.mean(), off)


def test_the_flag_and_the_threshold_move_the_same_rounding_points(outputs):
    """bf16_act changes both packages' outputs; the K-stack threshold 56
    changes them only for c_in 3 (``ceil16(3) + 16·i`` = 16, 32, 48 ≤ 56
    keep f32, the last layer and the transition go bf16), where 64 channels
    exceed it in every layer."""
    for pkg_on, pkg_off in ((("jax", True, 0), ("jax", False)),
                            (("port", True, 0), ("port", False, 0))):
        assert not np.array_equal(outputs[pkg_on], outputs[pkg_off])
    for pkg in ("jax", "port"):
        same = np.array_equal(outputs[(pkg, True, 0)], outputs[(pkg, True, 56)])
        assert same == (outputs["c_in"] == 64), pkg


def test_layer_choice_follows_the_jax_kernel():
    """``layer_bf16_act``: ceil16(c_in) + 16·i against the threshold, the
    transition always, nothing without the flag (not the pack's 8-channel
    alignment: c_in 3 is 16 there, 8 in the CUDA buffer)."""
    block = DenseBlock(3, growth_rate=16).eval()
    pack = pack_dense_block(block, None, True, 56)
    assert [pack.layer_bf16_act(i) for i in range(5)] == [False, False, False, True, True]
    pack = pack_dense_block(block, None, True, 0)
    assert [pack.layer_bf16_act(i) for i in range(5)] == [True] * 5
    pack = pack_dense_block(block, None, False, 0)
    assert [pack.layer_bf16_act(i) for i in range(5)] == [False] * 5
    pack = pack_dense_block(DenseBlock(64, growth_rate=16).eval(), None, True, 56)
    assert all(pack.layer_bf16_act(i) for i in range(5))


def test_serving_forward_with_a_bf16_act_tuning_file_matches_jax(tmp_path, monkeypatch):
    """The CPU serving forward (per-block, plain kernels, f32) built under a
    tuning file with ``db_bf16_act: true`` and ``db_k_stack_max_ci: 56``,
    against JAX's ``build_fast_apply`` with ``_DB_BF16_ACT`` and
    ``_DB_K_STACK_MAX_CI`` patched to the same: the fused forward's
    tolerance (tests/test_cdan_fast.py:36), at 1×16×32.  The flag reaches every
    DenseBlock pack; the f32-activation forward differs from it."""
    from multi_degradation_image_enhancement_tpu.models import cdan_fast as jax_fast
    from multi_degradation_image_enhancement_tpu.models.cdan import CDAN as JaxCDAN
    from multi_degradation_image_enhancement_tpu_torch.models import cdan_fast
    from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN
    from multi_degradation_image_enhancement_tpu_torch.utils.jax_port import flax_to_state_dict

    h, w = 16, 32
    rng = np.random.RandomState(7)
    x = rng.rand(1, h, w, 3).astype(np.float32)
    jm = JaxCDAN()
    v = jax.jit(lambda k, z: jm.init({"params": k}, z, train=False))(jax.random.key(7), x)

    def draw(path, t):  # statistics that keep the whole path live (test_torch_cdan.live_cdan)
        if jax.tree_util.keystr(path).endswith("['mean']"):
            return rng.uniform(-0.1, 0.1, t.shape).astype(np.float32)
        return rng.uniform(0.3, 1.0, t.shape).astype(np.float32)

    variables = {"params": jax.tree.map(np.asarray, v["params"]),
                 "batch_stats": jax.tree_util.tree_map_with_path(draw, v["batch_stats"])}
    monkeypatch.setattr(jax_fast, "_DB_BF16_ACT", True)
    monkeypatch.setattr(jax_fast, "_DB_K_STACK_MAX_CI", 56)
    want = np.asarray(jax_fast.build_fast_apply(variables, jnp.float32, interpret=True)(
        jnp.asarray(x)))

    model = CDAN()
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    model.eval()
    tuning = tmp_path / "tuning.json"
    tuning.write_text(json.dumps({"db_bf16_act": True, "db_k_stack_max_ci": 56}))
    monkeypatch.setenv(cdan_fast.TUNING_ENV, str(tuning))
    assert cdan_fast.serving_tuning() == {"db_bf16_act": True, "db_k_stack_max_ci": 56}
    with monkeypatch.context() as m:  # without the env: the port's own file, its two keys
        m.delenv(cdan_fast.TUNING_ENV)
        shipped = json.loads(cdan_fast._TUNING_PATH.read_text())
        assert cdan_fast.serving_tuning() == {k: shipped[k] for k in (
            "db_bf16_act", "db_k_stack_max_ci")}
    packs = cdan_fast._pack_dense_blocks(model, "cpu")
    assert all(p.bf16_act and p.k_stack_max_ci == 56 for p in packs.values())
    got = cdan_fast.build_serving_apply(model, torch.float32, "cpu")(torch.from_numpy(x)).numpy()
    assert want.std() > 1e-2
    err = np.abs(got - want)
    assert err.max() < 2e-2 and err.mean() < 2e-3, (err.max(), err.mean())
    f32_act = cdan_fast.build_fast_apply(model, torch.float32, "cpu", bf16_act=False)(
        torch.from_numpy(x)).numpy()
    assert not np.array_equal(f32_act, got)


def test_bf16_activation_is_jax_eager_bf16_arithmetic():
    """The plain version's bf16 prologue is JAX's ``max(f·a + b, 0)`` on bf16
    arrays bit for bit (XLA keeps both roundings, jit or not), and not the
    single rounding one fused multiply-add would give."""
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import _activate

    rng = np.random.RandomState(0)
    f = rng.normal(0, 2, (1, 64, 16, 16)).astype(np.float32)
    a, b = rng.normal(0, 2, 64).astype(np.float32), rng.normal(0, 1, 64).astype(np.float32)
    bf = jnp.bfloat16
    fb, ab, bb = (jnp.asarray(t).astype(bf) for t in (f, a, b))
    want = np.asarray(jax.jit(lambda f, a, b: jnp.maximum(
        f * a[None, :, None, None] + b[None, :, None, None], jnp.zeros((), bf)))(fb, ab, bb)
        .astype(jnp.float32))
    got = _activate(torch.from_numpy(f), torch.from_numpy(a), torch.from_numpy(b), True)
    assert got.dtype == torch.bfloat16 and np.array_equal(got.float().numpy(), want)
    fused = (torch.from_numpy(f).to(torch.bfloat16).float() * torch.from_numpy(a).to(torch.bfloat16)
             .float()[None, :, None, None] + torch.from_numpy(b).to(torch.bfloat16).float()
             [None, :, None, None]).to(torch.bfloat16).relu()
    assert (fused.float().numpy() != want).sum() > 100
