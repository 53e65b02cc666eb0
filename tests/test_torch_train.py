"""PyTorch port: the training slice vs the JAX package.

One JAX CDAN (2×16×24, random running statistics) is shared by the module;
its weights reach the port through ``utils/jax_port.py``.  The JAX side runs
``CDAN(fused_dense=True)`` with the Pallas growth kernels in interpret mode;
the port runs its fused DenseBlocks through the growth layer's plain version
(CPU tensors).  Dropout draws differ between the frameworks, so both sides get
the same keep masks (made with NumPy; injected on the JAX side with
``flax.linen.intercept_methods`` on ``nn.Dropout.__call__``).
"""

import json
import os
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multi_degradation_image_enhancement_tpu.data.synthetic import _procedural_clean as jax_clean
from multi_degradation_image_enhancement_tpu.engine.model import make_train_step as jax_make_step
from multi_degradation_image_enhancement_tpu.engine.state import TrainState as JaxState
from multi_degradation_image_enhancement_tpu.models.cdan import CDAN as JaxCDAN
from multi_degradation_image_enhancement_tpu.ops.image import resize_bilinear_cv as jax_resize
from multi_degradation_image_enhancement_tpu.ops.losses import build_loss_pipeline as jax_losses
from multi_degradation_image_enhancement_tpu_torch.data.synthetic import _procedural_clean
from multi_degradation_image_enhancement_tpu_torch.engine.model import make_train_step
from multi_degradation_image_enhancement_tpu_torch.engine.state import TrainState
from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN
from multi_degradation_image_enhancement_tpu_torch.ops.image import resize_bilinear_cv
from multi_degradation_image_enhancement_tpu_torch.ops.losses import build_loss_pipeline
from multi_degradation_image_enhancement_tpu_torch.utils.jax_port import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from tests.torch_train_cli import CONFIG, ROOT, check_tiny_run, write_tiny_config
B, H, W = 2, 16, 24
# (channels, pooling) of the four dropout sites: after pool 1, 2, 3 and conv4
DROP_SITES = [(64, 2), (128, 4), (256, 8), (512, 8)]


def _loss_cfg():
    return json.loads(CONFIG.read_text())["loss"]


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    x = jnp.zeros((1, H, W, 3), jnp.float32)
    v = jax.jit(lambda k: JaxCDAN().init({"params": k}, x, train=True))(jax.random.key(0))
    bs = jax.tree.map(lambda t: rng.uniform(0.5, 1.5, t.shape).astype(np.float32), v["batch_stats"])
    variables = {"params": jax.tree.map(np.asarray, v["params"]), "batch_stats": bs}
    inputs = rng.rand(B, H, W, 3).astype(np.float32)
    targets = np.clip(inputs + 0.1 * rng.randn(B, H, W, 3), 0.0, 1.0).astype(np.float32)
    keep = [rng.rand(B, H // p, W // p, c) < 0.8 for c, p in DROP_SITES]  # NHWC
    return variables, inputs, targets, keep


def _interceptor(keep):
    """Replace the encoder's four ``nn.Dropout`` calls, in order, by the masks."""
    masks = iter(keep)

    def intercept(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
            x = args[0]
            return jnp.where(next(masks), x / 0.8, jnp.zeros_like(x))
        return next_fun(*args, **kwargs)

    return intercept


def _port_model(variables):
    model = CDAN()
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    model.fused_dense = True
    return model


def _port_masks(keep):
    return [torch.from_numpy(np.ascontiguousarray(k.transpose(0, 3, 1, 2))) for k in keep]


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _worst(port_tree, jax_tree):
    got, want = _leaves(port_tree), _leaves(jax_tree)
    assert got.keys() == want.keys()
    return max((float(np.abs(got[k] - want[k]).max()), k) for k in want)


def test_train_forward_matches_jax(setup):
    """(a) Train-mode forward with the same masks: outputs and the mutated
    batch statistics (biased variance, momenta 0.9 and 0.99)."""
    variables, inputs, _, keep = setup

    @jax.jit
    def fwd(vv, x, kk):
        with fnn.intercept_methods(_interceptor(kk)):
            return JaxCDAN(fused_dense=True).apply(vv, x, train=True, mutable=["batch_stats"])

    want, mutated = fwd(variables, jnp.asarray(inputs), [jnp.asarray(k) for k in keep])
    model = _port_model(variables).train()
    with torch.no_grad():
        got = model(torch.from_numpy(inputs), _port_masks(keep))
    assert got.shape == (B, H, W, 3) and got.dtype == torch.float32
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 2e-2
    port_stats = state_dict_to_flax(model.state_dict())["batch_stats"]
    err, leaf = _worst(port_stats, mutated["batch_stats"])
    assert err <= 1e-3, leaf
    # the statistics moved: a wrong momentum or an unbiased variance shows here
    assert _worst(port_stats, variables["batch_stats"])[0] > 1e-2


@pytest.fixture(scope="module")
def steps(setup):
    """One ``make_train_step`` on each side, with the DenseBlocks canonical
    (``False``) or fused (``True``); computed once per variant."""
    variables, inputs, targets, keep = setup
    cache = {}

    def run(fused):
        if fused in cache:
            return cache[fused]
        jstep = jax_make_step(JaxCDAN(fused_dense=fused), jax_losses(_loss_cfg()))
        jstate = JaxState.create(params=variables["params"],
                                 batch_stats=variables["batch_stats"], tx=optax.adam(1e-3))

        @jax.jit
        def jrun(state, x, t, kk):
            with fnn.intercept_methods(_interceptor(kk)):
                return jstep(state, x, t, jax.random.key(0), None)

        jstate, jloss = jrun(jstate, jnp.asarray(inputs), jnp.asarray(targets),
                             [jnp.asarray(k) for k in keep])
        model = _port_model(variables)
        model.fused_dense = fused
        state = TrainState.create(model, 1e-3)
        loss = make_train_step(build_loss_pipeline(_loss_cfg(), "cpu"), "fp32")(
            state, torch.from_numpy(inputs), torch.from_numpy(targets), _port_masks(keep))
        assert state.step == 1
        # Adam's first moment after one step is 0.1·grad on both sides
        names = {id(p): n for n, p in model.named_parameters()}
        moments = {names[id(p)]: st["exp_avg"] for p, st in state.optimizer.state.items()}
        port_mu = state_dict_to_flax({**model.state_dict(), **moments})["params"]
        cache[fused] = (jstate, jloss, state_dict_to_flax(model.state_dict()), loss, port_mu)
        return cache[fused]

    return run


def _dust_leaves(mu):
    """Leaves whose gradient is zero up to rounding dust (conv biases feeding
    a train-mode BatchNorm: a constant shift cancels in the normalisation),
    found by a gradient scale below 1e-5 (a first moment below 1e-6)."""
    return {k for k, v in _leaves(mu).items() if float(np.abs(v).max()) < 1e-6}


def _worst_rel(got_mu, want_mu):
    """Worst per-leaf ``max|got − want| / max|want|`` of two gradient trees
    (as Adam's first moments, 0.1·g), over the leaves whose gradient scale is
    at least 1e-4, the full-model gradient test's cut
    (tests/test_growth_train.py)."""
    g, w = _leaves(got_mu), _leaves(want_mu)
    return max((float(np.abs(g[k] - w[k]).max()) / float(np.abs(w[k]).max()), k)
               for k in w if float(np.abs(w[k]).max()) >= 1e-5)


@pytest.mark.parametrize("fused", [False, True], ids=["canonical", "fused"])
def test_one_train_step_matches_jax(steps, fused):
    """(b) One whole ``make_train_step`` at fp32: loss (1e-4 relative) and
    batch statistics (1e-3).  Canonical DenseBlocks (all f32): the parameters
    after Adam agree to 1e-4 wherever |g| >= 1e-7, and the gradients to 1e-3
    of each leaf's scale.  Fused DenseBlocks: their bf16 operands turn
    ~1e-7 differences into bf16 rounding flips that BatchNorm over a few
    pixels amplifies, and Adam's first step (≈ lr·sign g) turns every sign
    flip into a 2e-3 parameter difference; so the fused step is held by its
    gradients (Adam's first moments) to the class bound of
    test_fused_dense_block_gradient_class, max(2·floor, 0.05), the floor
    being the JAX fused step's own distance from the JAX canonical step."""
    jstate, jloss, tree, loss, port_mu = steps(fused)
    for k in ("total", "charbonnier", "ssim"):
        assert abs(float(loss[k]) - float(jloss[k])) <= 1e-4 * abs(float(jloss[k])), k
    err, leaf = _worst(tree["batch_stats"], jstate.batch_stats)
    assert err <= 1e-3, (err, leaf)
    jmu = jstate.opt_state[0].mu
    if not fused:
        # Adam's first step is lr·g/(|g| + 1e-8): where |g| is not well above
        # eps (the dust leaves, and elements whose gradient cancels to ~1e-8),
        # f32 rounding of g decides the step.  Those are held by their
        # gradients (first moments); every parameter with |g| >= 1e-7 to 1e-4.
        assert _dust_leaves(jmu) == _dust_leaves(port_mu)
        got, want, grad = _leaves(tree["params"]), _leaves(jstate.params), _leaves(jmu)
        n_all = n_held = 0
        for k in want:
            resolved = np.abs(grad[k]) * 10.0 >= 1e-7  # mu = 0.1·g
            n_all += resolved.size
            n_held += int(resolved.sum())
            err = float(np.abs(got[k] - want[k])[resolved].max(initial=0.0))
            assert err <= 1e-4, (err, k)
        print(f"canonical step: {n_held} of {n_all} parameters held at 1e-4")
        assert n_held >= 0.9 * n_all  # 93.9% at this shape and seed
        assert _worst_rel(port_mu, jmu)[0] <= 1e-3
        return
    floor = _worst_rel(jmu, steps(False)[0].opt_state[0].mu)[0]
    err, leaf = _worst_rel(port_mu, jmu)
    print(f"fused step: worst gradient leaf {err:.3e} ({leaf}), floor {floor:.3e}")
    assert err <= max(2.0 * floor, 0.05), (err, leaf, floor)


def test_loss_pipeline_matches_jax():
    """(c) charbonnier + 0.5·ssim: values and input gradients."""
    rng = np.random.RandomState(3)
    out = rng.rand(2, 24, 32, 3).astype(np.float32)
    tgt = rng.rand(2, 24, 32, 3).astype(np.float32)
    out[0, 0, 0, 0] = out[1, 5, 5, 1] = out.max()  # a tie at the maximum of the data range
    mask = np.array([1.0, 0.0], np.float32)
    jpipe = jax_losses(_loss_cfg())
    pipe = build_loss_pipeline(_loss_cfg(), "cpu")
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        want = jpipe(jnp.asarray(out), jnp.asarray(tgt), mask=jm)
        jgrad = jax.grad(lambda o: jpipe(o, jnp.asarray(tgt), mask=jm)["total"])(jnp.asarray(out))
        o = torch.from_numpy(out.copy()).requires_grad_(True)
        got = pipe(o, torch.from_numpy(tgt), mask=None if m is None else torch.from_numpy(m))
        got["total"].backward()
        assert got.keys() == want.keys()
        for k in want:
            assert abs(float(got[k]) - float(want[k])) <= 1e-5, k
        assert float(np.abs(o.grad.numpy() - np.asarray(jgrad)).max()) <= 1e-5


def test_worst_case_selection_with_ties_matches_jax():
    """(c) ``worst_case``: k = round(f·B); ties at the threshold are all up-weighted."""
    cfg = {"terms": [{"name": "l1", "weight": 1.0}], "worst_case": {"fraction": 0.25, "scale": 3.0}}
    tgt = np.zeros((6, 4, 4, 3), np.float32)
    out = np.zeros_like(tgt)
    for i, v in enumerate([0.1, 0.5, 0.5, 0.2, 0.5, 0.05]):  # three images tie at the top
        out[i] = v
    mask = np.array([1, 1, 1, 1, 1, 0], np.float32)
    want = jax_losses(cfg)(jnp.asarray(out), jnp.asarray(tgt), mask=jnp.asarray(mask), training=True)
    got = build_loss_pipeline(cfg, "cpu")(torch.from_numpy(out), torch.from_numpy(tgt),
                                   mask=torch.from_numpy(mask), training=True)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-6, k
    # k = round(0.25·6) = 2, but the three tied images all weigh 3
    assert abs(float(got["total"]) - (3 * 0.5 * 3 + 0.1 + 0.2) / 11) <= 1e-6


def test_data_matches_jax():
    """(d) Procedural clean images bit for bit; the transforms' bilinear resize."""
    np.testing.assert_array_equal(_procedural_clean(3, 24, 40, seed=5), jax_clean(3, 24, 40, seed=5))
    x = np.random.RandomState(4).uniform(0, 255, (2, 32, 48, 3)).astype(np.float32)
    for oh, ow in ((48, 32), (32, 48), (20, 36)):
        want = np.asarray(jax_resize(jnp.asarray(x), oh, ow))
        got = resize_bilinear_cv(torch.from_numpy(x), oh, ow).numpy()
        assert got.shape == want.shape
        assert float(np.abs(got - want).max()) <= 1e-4


def test_cli_trains_on_cpu(tmp_path):
    """(e) ``python -m …_torch.run -c tiny.json -p train`` on the CPU."""
    cfg = write_tiny_config(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "multi_degradation_image_enhancement_tpu_torch.run",
         "-c", str(cfg), "-p", "train"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Epoch [1/1]" in proc.stdout and "[BN-RECAL]" in proc.stdout
    check_tiny_run(tmp_path)
