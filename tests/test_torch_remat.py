"""PyTorch port: ``train.remat``, per-block rematerialisation
(``models.norm.Rematerialized`` on every ConvBlock, DenseBlock and CBAM).

A remat step must be the plain step: the same loss and BatchNorm statistics
bit for bit (the recomputation updates no running average), the same
gradients, and each fused growth layer's forward once more in the backward.
Against the JAX package it is held as ``tests/test_torch_train.py`` holds
the plain step, with ``make_train_step(remat=True)`` on the JAX side.
"""

import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multi_degradation_image_enhancement_tpu.engine.model import make_train_step as jax_make_step
from multi_degradation_image_enhancement_tpu.engine.state import TrainState as JaxState
from multi_degradation_image_enhancement_tpu.models.cdan import CDAN as JaxCDAN
from multi_degradation_image_enhancement_tpu.ops.losses import build_loss_pipeline as jax_losses
from multi_degradation_image_enhancement_tpu_torch.engine.model import make_train_step
from multi_degradation_image_enhancement_tpu_torch.engine.state import TrainState
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.growth_train import growth_layer
from multi_degradation_image_enhancement_tpu_torch.ops.losses import build_loss_pipeline
from multi_degradation_image_enhancement_tpu_torch.utils.jax_port import state_dict_to_flax
from tests.test_torch_train import (  # noqa: F401 (setup is a fixture)
    _dust_leaves,
    _interceptor,
    _leaves,
    _loss_cfg,
    _port_masks,
    _port_model,
    _worst,
    _worst_rel,
    setup,
)

torch.set_num_threads(1)  # tiny CPU runs stall under many threads per xdist worker


def _step(variables, inputs, targets, keep, fused, remat, growth_fn=None):
    """One fp32 port step: (loss dict, grads by name, buffers by name)."""
    model = _port_model(variables)
    model.fused_dense = fused
    model.remat = remat
    if growth_fn is not None:
        for block in model.dense_blocks():
            block.growth_fn = growth_fn
    state = TrainState.create(model, 1e-3)
    loss = make_train_step(build_loss_pipeline(_loss_cfg(), "cpu"), "fp32")(
        state, torch.from_numpy(inputs), torch.from_numpy(targets), _port_masks(keep))
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return loss, grads, dict(model.named_buffers())


@pytest.mark.parametrize("fused", [False, True], ids=["canonical", "fused"])
def test_remat_step_matches_the_plain_step(setup, fused):
    """Loss and every buffer (running statistics, batch counts) bit for bit;
    each gradient leaf to 1e-6 of its largest value (measured bit-equal)."""
    variables, inputs, targets, keep = setup
    plain = _step(variables, inputs, targets, keep, fused, remat=False)
    remat = _step(variables, inputs, targets, keep, fused, remat=True)
    for k in plain[0]:
        assert torch.equal(plain[0][k], remat[0][k]), k
    assert plain[2].keys() == remat[2].keys()
    for k in plain[2]:
        assert torch.equal(plain[2][k], remat[2][k]), k
    for k, g in plain[1].items():
        assert float((remat[1][k] - g).abs().max()) <= 1e-6 * max(float(g.abs().max()), 1e-30), k


def test_remat_recomputes_each_growth_layer_once(setup):
    """A counting ``growth_fn``: 16 forward calls in a plain fused step, 32
    under remat (each DenseBlock's four layers again in the backward), and
    16 in a forward without gradients (recalibration) even with remat set."""
    variables, inputs, targets, keep = setup
    calls = []

    def counting(*args):
        calls.append(args[0].shape[1])
        return growth_layer(*args)

    for remat, want in ((False, 16), (True, 32)):
        calls.clear()
        _step(variables, inputs, targets, keep, True, remat, counting)
        assert len(calls) == want, remat
    assert sorted(calls[:16]) == sorted(calls[16:])  # the same 16 layers again
    model = _port_model(variables)
    model.fused_dense = model.remat = True
    for block in model.dense_blocks():
        block.growth_fn = counting
    calls.clear()
    model.eval()
    model.stats_refresh = True
    with torch.no_grad():
        model(torch.from_numpy(inputs))
    assert len(calls) == 16


def test_remat_step_matches_jax_remat(setup):
    """The port's remat step against JAX ``make_train_step(remat=True)``
    (canonical DenseBlocks, fp32), at tests/test_torch_train.py's bounds for
    the plain step: loss 1e-4 relative, batch statistics 1e-3, the parameters
    after Adam 1e-4 wherever |g| >= 1e-7 (at least 90% of them), the
    gradients 1e-3 of each leaf's scale, and the same dust leaves."""
    variables, inputs, targets, keep = setup
    jstep = jax_make_step(JaxCDAN(), jax_losses(_loss_cfg()), remat=True)
    jstate = JaxState.create(params=variables["params"], batch_stats=variables["batch_stats"],
                             tx=optax.adam(1e-3))

    @jax.jit
    def jrun(state, x, t, kk):
        with fnn.intercept_methods(_interceptor(kk)):
            return jstep(state, x, t, jax.random.key(0), None)

    jstate, jloss = jrun(jstate, jnp.asarray(inputs), jnp.asarray(targets),
                         [jnp.asarray(k) for k in keep])
    model = _port_model(variables)
    model.fused_dense = False
    model.remat = True
    state = TrainState.create(model, 1e-3)
    loss = make_train_step(build_loss_pipeline(_loss_cfg(), "cpu"), "fp32")(
        state, torch.from_numpy(inputs), torch.from_numpy(targets), _port_masks(keep))
    for k in ("total", "charbonnier", "ssim"):
        assert abs(float(loss[k]) - float(jloss[k])) <= 1e-4 * abs(float(jloss[k])), k
    tree = state_dict_to_flax(model.state_dict())
    err, leaf = _worst(tree["batch_stats"], jstate.batch_stats)
    assert err <= 1e-3, (err, leaf)
    names = {id(p): n for n, p in model.named_parameters()}
    moments = {names[id(p)]: st["exp_avg"] for p, st in state.optimizer.state.items()}
    port_mu = state_dict_to_flax({**model.state_dict(), **moments})["params"]
    jmu = jstate.opt_state[0].mu
    assert _dust_leaves(jmu) == _dust_leaves(port_mu)
    got, want, grad = _leaves(tree["params"]), _leaves(jstate.params), _leaves(jmu)
    n_all = n_held = 0
    for k in want:
        resolved = np.abs(grad[k]) * 10.0 >= 1e-7
        n_all += resolved.size
        n_held += int(resolved.sum())
        assert float(np.abs(got[k] - want[k])[resolved].max(initial=0.0)) <= 1e-4, k
    assert n_held >= 0.9 * n_all
    assert _worst_rel(port_mu, jmu)[0] <= 1e-3


def test_remat_flag_reaches_every_block():
    """``CDAN.remat`` sets the 12 blocks JAX wraps (4 ConvBlocks, 4
    DenseBlocks, 4 CBAMs) and nothing else; a copy keeps it."""
    from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN, ConvBlock, DenseBlock
    from multi_degradation_image_enhancement_tpu_torch.models.cbam import CBAM
    from multi_degradation_image_enhancement_tpu_torch.models.norm import Rematerialized

    model = CDAN()
    assert not model.remat
    model.remat = True
    blocks = [m for m in model.modules() if isinstance(m, Rematerialized)]
    assert len(blocks) == 12 and all(m.remat for m in blocks)
    assert sorted(type(m).__name__ for m in blocks) == sorted(
        ["ConvBlock"] * 4 + ["DenseBlock"] * 4 + ["CBAM"] * 4)
    assert all(isinstance(m, (ConvBlock, DenseBlock, CBAM)) for m in blocks)
    assert copy.deepcopy(model).remat
