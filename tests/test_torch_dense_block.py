"""PyTorch port: DenseBlock (models/cdan.py, ops/cuda/dense_block.py) vs the
JAX package, with the same weights through the bridge (utils/jax_port.py).

On the CPU the kernel wrapper runs its plain version; the CUDA kernels are
held to that plain version on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_degradation_image_enhancement_tpu.models.cdan import DenseBlock as JaxDenseBlock
from multi_degradation_image_enhancement_tpu.ops.pallas.dense_block import fold_bn as jax_fold_bn
from multi_degradation_image_enhancement_tpu_torch.models.cdan import DenseBlock
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import (
    dense_block,
    dense_block_plain,
    fold_bn,
    pack_dense_block,
)
from multi_degradation_image_enhancement_tpu_torch.utils.jax_port import dense_block_state_dict


def _jax_block(c_in, h, w, growth=16, seed=0):
    """A JAX DenseBlock with random running stats, its variables as NumPy, and an input."""
    rng = np.random.RandomState(seed)
    x = rng.rand(2, h, w, c_in).astype(np.float32)
    m = JaxDenseBlock(c_in, growth_rate=growth)
    v = jax.jit(lambda k, z: m.init({"params": k}, z, train=False))(jax.random.key(seed), x)
    bs = jax.tree.map(lambda t: rng.uniform(0.5, 1.5, t.shape).astype(np.float32), v["batch_stats"])
    variables = {"params": jax.tree.map(np.asarray, v["params"]), "batch_stats": bs}
    return m, variables, x


def _jax_apply(m, variables, x) -> np.ndarray:
    return np.asarray(jax.jit(lambda v, z: m.apply(v, z, train=False))(variables, x))


def _port_block(variables, c_in, growth=16) -> DenseBlock:
    block = DenseBlock(c_in, growth_rate=growth)
    block.load_state_dict(dense_block_state_dict(variables), strict=True)
    return block.eval()


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("c_in,h,w", [(3, 16, 24), (64, 8, 16)])
def test_plain_dense_block_matches_jax_module(c_in, h, w):
    m, variables, x = _jax_block(c_in, h, w)
    want = _jax_apply(m, variables, x)
    block = _port_block(variables, c_in)
    with torch.no_grad():
        got_module = block(_nchw(x)).permute(0, 2, 3, 1).numpy()
        got_folded = dense_block(_nchw(x), pack_dense_block(block)).permute(0, 2, 3, 1).numpy()
    assert np.abs(got_module - want).max() <= 1e-4  # f32 vs f32: sum order only
    assert np.abs(got_folded - want).max() <= 1e-4  # + the BN fold


def test_folded_plain_matches_jax_run_cm2_interpret():
    """The port's folded plain version against the TPU kernel's body run in
    interpret mode: bf16-class tolerance (tests/test_pallas_kernels.py:64-65),
    since the kernel holds features in bf16."""
    from multi_degradation_image_enhancement_tpu.ops.pallas.dense_block_cm import (
        _run_cm2,
        pack_params_cm,
    )

    c_in, h, w = 3, 16, 24
    _, variables, x = _jax_block(c_in, h, w, seed=3)
    packed = pack_params_cm(variables["params"], variables["batch_stats"], c_in)
    xcm = jnp.asarray(x).transpose(0, 3, 1, 2).reshape(2, c_in, h * w)
    out_cm = _run_cm2(xcm, packed, c_in=c_in, hw_shape=(h, w), interpret=True)
    want = np.asarray(out_cm[:, :c_in, :]).reshape(2, c_in, h, w)

    pack = pack_dense_block(_port_block(variables, c_in))
    for dt in (torch.float32, torch.bfloat16):
        got = dense_block(_nchw(x).to(dt), pack).float().numpy()
        err = np.abs(got - want)
        assert err.max() <= 5e-2 and err.mean() <= 5e-3, (dt, err.max(), err.mean())


def test_bf16_plain_rounds_where_the_kernel_rounds():
    """With bf16 features the plain version stays within bf16 class of f32."""
    _, variables, x = _jax_block(64, 8, 16, seed=4)
    pack = pack_dense_block(_port_block(variables, 64))
    xt = _nchw(x).to(torch.bfloat16)
    got = dense_block_plain(xt, pack)
    want = dense_block_plain(xt.float(), pack)
    assert got.dtype == torch.bfloat16
    err = (got.float() - want).abs()
    assert 0 < err.max() <= 5e-2 and err.mean() <= 5e-3


def test_fold_bn_math():
    rng = np.random.default_rng(5)
    c = 7
    scale, bias = rng.normal(size=c).astype(np.float32), rng.normal(size=c).astype(np.float32)
    mean, var = rng.normal(size=c).astype(np.float32), rng.uniform(0.5, 1.5, c).astype(np.float32)
    a, b = fold_bn(*(torch.from_numpy(t) for t in (scale, bias, mean, var)))
    ja, jb = jax_fold_bn(*(jnp.asarray(t) for t in (scale, bias, mean, var)))
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-6)
    bn = torch.nn.BatchNorm2d(c).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
        xt = torch.randn(2, c, 3, 3)
        torch.testing.assert_close(bn(xt), xt * a[:, None, None] + b[:, None, None])


def test_growth_rate_other_than_16():
    c_in, growth = 8, 12
    m, variables, x = _jax_block(c_in, 8, 8, growth=growth, seed=6)
    want = _jax_apply(m, variables, x)
    block = _port_block(variables, c_in, growth)
    pack = pack_dense_block(block)
    assert pack.growth == growth and pack.c_total == c_in + 4 * growth
    with torch.no_grad():
        got = dense_block(_nchw(x), pack).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() <= 1e-4


@pytest.mark.parametrize("c_in", [3, 64])
def test_fused_dense_block_cm_matches_jax_row_tiled(monkeypatch, c_in):
    """``fused_dense_block_cm`` (NHWC, from the module's eval statistics)
    against the JAX entry of the row-tiled kernel #3, its tiled mode forced
    by a small VMEM target as tests/test_pallas_kernels.py:213-227 does, run
    in interpret mode.  bf16-class tolerance (test_pallas_kernels.py:64-65):
    the TPU kernel holds features in bf16, the port's f32 plain version does
    not; bf16 input makes the plain version round where the kernel rounds."""
    from multi_degradation_image_enhancement_tpu.ops.pallas import dense_block_cm as jax_cm
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import (
        fused_dense_block_cm,
    )

    h, w = 32, 16
    _, variables, x = _jax_block(c_in, h, w, seed=7)
    monkeypatch.setattr(jax_cm, "_VMEM_TARGET_BYTES", 300 * 1024)
    plan = jax_cm._plan(h, w, jax_cm._ceil16(c_in))
    assert plan["mode"] == "tiled" and plan["rows"] < h  # several tiles with halos
    want = np.asarray(jax_cm.fused_dense_block_cm(
        jnp.asarray(x), variables["params"], variables["batch_stats"], interpret=True))

    block = _port_block(variables, c_in)
    n0 = dense_block.launches
    for dt in (torch.float32, torch.bfloat16):
        got = fused_dense_block_cm(torch.from_numpy(x).to(dt), block)
        assert got.shape == (2, h, w, c_in) and got.dtype == dt
        err = np.abs(got.float().numpy() - want)
        assert err.max() <= 5e-2 and err.mean() <= 5e-3, (dt, err.max(), err.mean())
    assert dense_block.launches == n0  # the CPU takes the plain version


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c_in,h,w", [(64, 32, 48), (3, 16, 24), (128, 16, 24)])
def test_fused_dense_block_matches_jax_row_major_kernel(c_in, h, w, dtype):
    """``fused_dense_block`` (#10's entry: NHWC, from the module's eval
    statistics, the affine folded in x's dtype) against the JAX entry of the
    row-major kernel run in interpret mode, at the shapes of
    tests/test_pallas_kernels.py:15, in both input dtypes.  bf16-class bar
    (test_pallas_kernels.py:30-31): the TPU kernel rounds the input and every
    feature to bf16 even for f32 x; the port's plain version keeps f32
    features for f32 x."""
    from multi_degradation_image_enhancement_tpu.ops.pallas.dense_block import (
        fused_dense_block as jax_fused_dense_block,
    )
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import (
        fused_dense_block,
    )

    _, variables, x = _jax_block(c_in, h, w, seed=8)
    want = jax_fused_dense_block(jnp.asarray(x, getattr(jnp, dtype)), variables["params"],
                                 variables["batch_stats"], interpret=True)
    assert want.dtype == getattr(jnp, dtype)
    block = _port_block(variables, c_in)
    n0 = dense_block.launches
    with torch.no_grad():
        got = fused_dense_block(torch.from_numpy(x).to(getattr(torch, dtype)), block)
    assert got.shape == (2, h, w, c_in) and got.dtype == getattr(torch, dtype)
    assert dense_block.launches == n0  # the CPU takes the plain version
    err = np.abs(got.float().numpy() - np.asarray(want, np.float32))
    assert err.max() <= 5e-2 and err.mean() <= 5e-3, (err.max(), err.mean())
    with pytest.raises(RuntimeError, match="inference only"):
        fused_dense_block(torch.from_numpy(x).requires_grad_(True), block)
