"""PyTorch port: the optional training features against the JAX package:
learning-rate schedules, gradient clipping, a train step under both, the two
weight inits, the profiler and the registry's error contract.

Schedules and clipping are held against optax itself; the train step against
the JAX ``make_train_step`` under ``optax.chain(clip_by_global_norm,
adam(schedule))`` with the same weights (``utils/jax_port.py``), batch and
dropout masks (``tests/test_torch_train.py``'s interceptor).
"""

import json
import math

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
from multi_degradation_image_enhancement_tpu.models.torch_init import torch_reinit as jax_reinit
from multi_degradation_image_enhancement_tpu.ops.losses import build_loss_pipeline as jax_losses
from multi_degradation_image_enhancement_tpu_torch import run
from multi_degradation_image_enhancement_tpu_torch.engine.model import Model, make_train_step
from multi_degradation_image_enhancement_tpu_torch.engine.state import (
    TrainState,
    build_schedule,
    clip_by_global_norm_,
)
from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN
from multi_degradation_image_enhancement_tpu_torch.models.torch_init import (
    TRUNCATED_STD,
    flax_default_init_,
    torch_reinit_,
)
from multi_degradation_image_enhancement_tpu_torch.ops.losses import build_loss_pipeline
from multi_degradation_image_enhancement_tpu_torch.utils.config import load_config
from multi_degradation_image_enhancement_tpu_torch.utils.jax_port import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from tests.test_torch_train import DROP_SITES, _interceptor, _leaves, _loss_cfg, _port_masks
from tests.torch_train_cli import write_tiny_config

torch.set_num_threads(1)  # tiny CPU runs stall under many threads per xdist worker

LR = 1e-3


# ------------------------------------------------------------------ schedules

SCHEDULES = [
    ("cosine", "cosine", lambda t: optax.cosine_decay_schedule(LR, t, 0.01)),
    ("cosine_dict", {"name": "cosine", "args": {"alpha": 0.2, "decay_steps": 6}},
     lambda t: optax.cosine_decay_schedule(LR, 6, 0.2)),
    ("linear", "linear", lambda t: optax.linear_schedule(LR, LR * 0.01, t)),
    ("linear_dict", {"name": "linear", "args": {"end_value": 3e-4, "decay_steps": 7}},
     lambda t: optax.linear_schedule(LR, 3e-4, 7)),
]


@pytest.mark.parametrize("cfg,make_optax", [s[1:] for s in SCHEDULES],
                         ids=[s[0] for s in SCHEDULES])
def test_schedule_matches_optax(cfg, make_optax):
    """At every count of a 10-step run (and past its end): optax's formula
    evaluated in f64 (``jax.enable_x64``) to 1e-7 relative, and optax's own
    f32 evaluation to 1e-6 (its f32 rounding; the port computes in Python
    floats, the learning rate's type in ``torch.optim``).  T defaults to the
    run's length, 10."""
    sched = build_schedule(cfg, LR, 10)
    counts = range(13)
    with jax.enable_x64(True):
        want64 = [float(make_optax(10)(np.float64(c))) for c in counts]
    want32 = [float(make_optax(10)(c)) for c in counts]
    for c, w64, w32 in zip(counts, want64, want32):
        assert abs(sched(c) - w64) <= 1e-7 * abs(w64), c
        assert abs(sched(c) - w32) <= 1e-6 * abs(w32), c
    assert sched(0) == LR and sched(12) < LR


def test_engine_schedule_spans_the_run(tmp_path):
    """The engine's default T is n_epoch · len(loader): 3 epochs of 2 steps."""
    cfg = json.loads(write_tiny_config(tmp_path).read_text())
    cfg["train"].update(n_epoch=3, lr_schedule="cosine")
    path = tmp_path / "sched.json"
    path.write_text(json.dumps(cfg))
    logger, engine = run.build_session(load_config(str(path), phase="train"))
    logger.close()
    want = optax.cosine_decay_schedule(cfg["train"]["lr"], 6, 0.01)
    for c in range(8):
        assert math.isclose(engine.state.schedule(c), float(want(c)), rel_tol=1e-6), c
    assert engine.state.grad_clip is None


def test_unknown_schedule_raises_through_the_cli(tmp_path):
    """An unknown ``train.lr_schedule`` raises while the engine is built; the
    registry turns it into the NotImplementedError that
    tests/test_engine.py expects of the JAX CLI."""
    cfg = json.loads(write_tiny_config(tmp_path).read_text())
    cfg["train"]["lr_schedule"] = {"name": "nope"}
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(cfg))
    with pytest.raises(NotImplementedError, match="lr_schedule") as err:
        run.main(load_config(str(path), phase="train"))
    assert isinstance(err.value.__cause__, ValueError)
    assert "Model [Model() from models.model] not recognized" in str(err.value)


def test_construction_errors_are_wrapped_as_in_jax(tmp_path):
    """Any error raised while the registry builds an object reaches the CLI as
    ``NotImplementedError("<type> [<Class>() from <module>] not recognized:
    …")`` chained to it (the JAX registry's contract)."""
    cfg = json.loads(write_tiny_config(tmp_path).read_text())
    cfg["train"]["dataset"]["args"]["degradation"] = "haze"
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(cfg))
    msg = r"Dataset \[SyntheticPairedDataset\(\) from data.synthetic\] not recognized"
    with pytest.raises(NotImplementedError, match=msg) as err:
        run.build_session(load_config(str(path), phase="train"))
    assert isinstance(err.value.__cause__, ValueError)
    assert "Unknown degradation" in str(err.value)


# ------------------------------------------------------------------ clipping


def _grad_tree(seed, sizes_only_small=False):
    """Random gradients with the shapes of CDAN's parameters (or its leaves
    of at most 40,000 elements), with per-leaf scales spread over 1e-3..1."""
    rng = np.random.RandomState(seed)
    shapes = [tuple(p.shape) for p in CDAN().parameters()]
    if sizes_only_small:
        shapes = [s for s in shapes if np.prod(s) <= 40_000]
    return [(rng.randn(*s) * 10 ** rng.uniform(-3, 0)).astype(np.float32) for s in shapes]


def _optax_clip(tree, max_norm):
    tx = optax.clip_by_global_norm(max_norm)
    out, _ = tx.update([jnp.asarray(t) for t in tree], tx.init(None))
    return [np.asarray(t) for t in out]


@pytest.mark.parametrize("small", [False, True], ids=["cdan_leaves", "small_leaves"])
def test_clip_above_the_threshold_matches_optax(small):
    """Above the threshold each gradient becomes g / norm * max_norm.  The
    port's norm is held to the exact (f64) global norm at 1e-7 relative, and
    each clipped value to optax's at 1e-6 relative: the two f32 norms are
    reduced in other orders, so they differ in their last bits (optax's by
    ~2e-7 from the exact norm at CDAN's 1.18 M-element leaf), and two f32
    roundings of the quotient add 1.2e-7."""
    tree = _grad_tree(0, small)
    exact = math.sqrt(sum(float((t.astype(np.float64) ** 2).sum()) for t in tree))
    max_norm = 0.5 * exact
    want = _optax_clip(tree, max_norm)
    got = [torch.from_numpy(t.copy()) for t in tree]
    norm = float(clip_by_global_norm_(got, max_norm))
    assert abs(norm - exact) <= 1e-7 * exact
    for g, w in zip(got, want):
        assert np.all(np.abs(g.numpy() - w) <= 1e-6 * np.abs(w)), g.shape
    clipped = math.sqrt(sum(float((g.double() ** 2).sum()) for g in got))
    assert abs(clipped - max_norm) <= 1e-6 * max_norm


def test_clip_below_the_threshold_is_bit_equal():
    tree = _grad_tree(1)
    exact = math.sqrt(sum(float((t.astype(np.float64) ** 2).sum()) for t in tree))
    want = _optax_clip(tree, 2.0 * exact)
    got = [torch.from_numpy(t.copy()) for t in tree]
    clip_by_global_norm_(got, 2.0 * exact)
    for g, w, t in zip(got, want, tree):
        assert np.array_equal(g.numpy(), t) and np.array_equal(g.numpy(), w)


# ------------------------------------------------------------------ one engine step

B, H, W = 2, 32, 48
CLIP = 0.05
DECAY = 2  # the cosine schedule's T: the second update runs at 0.505·lr


@pytest.fixture(scope="module")
def clipped_steps():
    """Two steps of each side from the same weights, batch and masks under
    clipping and a cosine schedule: (JAX states, port (mu, params, stats) per
    step, the losses)."""
    rng = np.random.RandomState(5)
    x = jnp.zeros((1, H, W, 3), jnp.float32)
    v = jax.jit(lambda k: JaxCDAN().init({"params": k}, x, train=True))(jax.random.key(3))
    bs = jax.tree.map(lambda t: rng.uniform(0.5, 1.5, t.shape).astype(np.float32), v["batch_stats"])
    variables = {"params": jax.tree.map(np.asarray, v["params"]), "batch_stats": bs}
    inputs = rng.rand(B, H, W, 3).astype(np.float32)
    targets = np.clip(inputs + 0.1 * rng.randn(B, H, W, 3), 0.0, 1.0).astype(np.float32)
    keep = [rng.rand(B, H // p, W // p, c) < 0.8 for c, p in DROP_SITES]

    tx = optax.chain(optax.clip_by_global_norm(CLIP),
                     optax.adam(optax.cosine_decay_schedule(LR, DECAY, 0.01)))
    jstate = JaxState.create(params=variables["params"], batch_stats=variables["batch_stats"],
                             tx=tx)
    jstep = jax_make_step(JaxCDAN(), jax_losses(_loss_cfg()))

    @jax.jit
    def jrun(state, xx, tt, kk):
        with fnn.intercept_methods(_interceptor(kk)):
            return jstep(state, xx, tt, jax.random.key(0), None)

    jkeep = [jnp.asarray(k) for k in keep]
    jstates, jlosses = [], []
    for _ in range(2):
        jstate, jloss = jrun(jstate, jnp.asarray(inputs), jnp.asarray(targets), jkeep)
        jstates.append(jstate)
        jlosses.append(float(jloss["total"]))

    model = CDAN()
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    state = TrainState.create(model, LR, build_schedule({"name": "cosine", "args": {
        "decay_steps": DECAY}}, LR, 99), grad_clip=CLIP)
    step = make_train_step(build_loss_pipeline(_loss_cfg(), "cpu"), "fp32")
    names = {id(p): n for n, p in model.named_parameters()}
    ported, losses = [], []
    for _ in range(2):
        loss = step(state, torch.from_numpy(inputs), torch.from_numpy(targets),
                    _port_masks(keep))
        losses.append(float(loss["total"]))
        mu = {names[id(p)]: st["exp_avg"].clone() for p, st in state.optimizer.state.items()}
        tree = state_dict_to_flax({**model.state_dict(), **mu})
        ported.append((tree["params"], state_dict_to_flax(model.state_dict())))
    assert state.step == 2
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(LR * (0.99 * 0.5 + 0.01))
    return variables, jstates, jlosses, ported, losses


def test_step_with_schedule_and_clip_matches_jax(clipped_steps):
    """Two fp32 steps (canonical DenseBlocks) under clip 0.05 and a cosine
    schedule of T = 2.  Both losses to 1e-4 relative.  Step one, from the
    same weights: the clipped gradients (Adam's first moments, 0.1·g) have
    the global norm 0.05 on both sides (the unclipped norm is ~0.52) and
    agree to 1e-3 of each leaf's largest, tests/test_torch_train.py's bound
    for a canonical step (measured worst 9.6e-4, at a CBAM MLP bias), over
    the leaves whose clipped gradient reaches 1e-5 (the others are the
    ~1e-9 dust of conv biases before a BatchNorm); the parameters to 1% of
    lr on the robust elements and everywhere to 2·lr.  The robust-element
    rule of tests/test_torch_classifier_train.py (|g| above 1e-3 of its
    leaf's largest) is narrowed to 1e-2 and |g| > 1e-6: the gradients agree
    to 1e-3 of the leaf's largest here, not 1e-4, and clipping shrinks them
    toward Adam's eps (1e-8), where lr·g/(|g| + eps) is no longer lr·sign g.
    Step two runs at the schedule's count 1 (0.505·lr on both sides) from
    weights that differ by step one's rounding, which Adam's first step
    (≈ lr·sign g) turns into gradient differences of a few percent; it is
    held by its loss and by 2·(lr₀ + lr₁) on every parameter."""
    variables, jstates, jlosses, ported, losses = clipped_steps
    for got, want in zip(losses, jlosses):
        assert abs(got - want) <= 1e-4 * abs(want)
    lrs = [LR, float(optax.cosine_decay_schedule(LR, DECAY, 0.01)(1))]
    assert lrs[1] == pytest.approx(LR * 0.505, rel=1e-6)
    jmu, pmu = _leaves(jstates[0].opt_state[1][0].mu), _leaves(ported[0][0])
    assert jmu.keys() == pmu.keys()
    for mu in (jmu, pmu):
        norm = math.sqrt(sum(float(((10.0 * v.astype(np.float64)) ** 2).sum())
                             for v in mu.values()))
        assert abs(norm - CLIP) <= 1e-4 * CLIP, norm
    held = 0
    for k in jmu:
        scale = float(np.abs(jmu[k]).max())
        if scale >= 1e-6:  # mu = 0.1·g
            assert float(np.abs(pmu[k] - jmu[k]).max()) <= 1e-3 * scale, k
            held += 1
    assert held >= 100  # of 140 leaves
    start = _leaves(variables["params"])
    for i, (jstate, (_, port_tree)) in enumerate(zip(jstates, ported)):
        want_p, got_p = _leaves(jstate.params), _leaves(port_tree["params"])
        for k in want_p:
            delta = np.abs(got_p[k] - want_p[k])
            assert delta.max() <= 2 * sum(lrs[:i + 1]), (i, k)
            g = 10.0 * np.abs(jmu[k])
            if i == 0 and float(g.max()) >= 1e-5:
                robust = (g > 1e-2 * g.max()) & (g > 1e-6)
                assert delta[robust].max(initial=0.0) <= 0.01 * LR, k
                assert np.abs(want_p[k] - start[k]).max() > 0, k
        err = max(float(np.abs(_leaves(port_tree["batch_stats"])[k] - v).max())
                  for k, v in _leaves(jstate.batch_stats).items())
        assert err <= 1e-3, i


# ------------------------------------------------------------------ init


def _jax_shapes():
    x = jnp.zeros((1, 32, 48, 3), jnp.float32)
    return jax.eval_shape(lambda: JaxCDAN().init({"params": jax.random.key(0)}, x, train=True))


def _kernels(tree):
    """(path, kernel, bias or None) of every conv / dense node of a params tree."""
    out = []

    def walk(node, path):
        if not isinstance(node, dict):
            return
        if "kernel" in node:
            out.append((path, np.asarray(node["kernel"]), node.get("bias")))
            return
        for k, v in node.items():
            walk(v, path + (k,))

    walk(tree, ())
    return out


# Kurtosis of the two distributions: uniform, and the normal cut at ±2σ.
KURTOSIS = {"uniform": 1.8, "truncated_normal": 2.3633}


def _std_tol(n, dist):
    """5%, or four standard errors of a sample std of ``n`` values
    (√((κ − 1)/(4n))) where that is wider: the CBAM spatial convs hold 98
    values, whose std scatters by ±4.5% (uniform) on its own."""
    return max(0.05, 4.0 * math.sqrt((KURTOSIS[dist] - 1.0) / (4.0 * n)))


def _fan_in(kernel):
    return int(np.prod(kernel.shape[:-1]))  # HWIO conv or [in, out] dense


def test_flax_default_init_matches_flax():
    """Against Flax's init (shapes from ``jax.eval_shape``, no compute) and
    its analytic σ = √(1/fan_in)/0.8796 of ``lecun_normal``: every kernel's
    shape is the JAX one, its values lie within ±2σ and their std is
    √(1/fan_in) within 5% (``_std_tol``: wider for the smallest kernels);
    biases 0, BatchNorm scale 1, bias 0,
    statistics 0/1.  The decoder's de1–de4 draw with fan_in = 9·c_in, the
    JAX package's flipped conv (``models/cdan.py:312-338``)."""
    model = CDAN()
    flax_default_init_(model, torch.Generator().manual_seed(0))
    tree = state_dict_to_flax(model.state_dict())
    shapes = _jax_shapes()
    assert jax.tree.map(lambda s: tuple(s.shape), shapes["params"]) == jax.tree.map(
        lambda a: tuple(np.shape(a)), tree["params"])
    n = 0
    for path, kernel, bias in _kernels(tree["params"]):
        fan = _fan_in(kernel)
        sigma = math.sqrt(1.0 / fan) / TRUNCATED_STD
        assert np.abs(kernel).max() <= 2.0 * sigma * (1 + 1e-6), path
        tol = _std_tol(kernel.size, "truncated_normal")
        assert abs(kernel.std() / math.sqrt(1.0 / fan) - 1.0) <= tol, (path, kernel.std())
        if bias is not None:
            assert not np.any(bias), path
        if path[-1].startswith("de") and path[-1].endswith("_conv"):
            assert fan == 9 * kernel.shape[2]  # HWIO: kh·kw·c_in
        n += 1
    assert n == 40
    norms = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert len(norms) == 32
    for m in norms:
        assert torch.all(m.weight == 1) and torch.all(m.bias == 0)
        assert torch.all(m.running_mean == 0) and torch.all(m.running_var == 1)


def test_torch_reinit_matches_jax_torch_reinit():
    """``torch_reinit_`` against the JAX ``torch_reinit`` (jitted, on a zero
    tree of the JAX shapes; it reads only shapes and paths): both draw every
    kernel and bias U(±1/√fan) with PyTorch's fan, 9·c_out for the
    ConvTranspose2d decoder layers; each kernel's std within 5%
    (``_std_tol``) of bound/√3 on both sides, and every |w| within its
    bound."""
    model = CDAN()
    torch_reinit_(model, torch.Generator().manual_seed(1))
    port = {p: (k, b) for p, k, b in _kernels(state_dict_to_flax(model.state_dict())["params"])}
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), _jax_shapes()["params"])
    jax_tree = jax.tree.map(np.asarray, jax.jit(jax_reinit)(zeros, jax.random.key(2)))
    checked = 0
    for path, jk, jb in _kernels(jax_tree):
        pk, pb = port[path]
        fan = _fan_in(jk)
        if path[-1] in ("de1_conv", "de2_conv", "de3_conv", "de4_conv"):
            fan = 9 * jk.shape[3]
            assert jk.shape == pk.shape
        bound = 1.0 / math.sqrt(fan)
        tol = _std_tol(jk.size, "uniform")
        for kernel, bias in ((pk, pb), (jk, jb)):
            assert np.abs(kernel).max() <= bound * (1 + 1e-6), path
            assert abs(kernel.std() / (bound / math.sqrt(3.0)) - 1.0) <= tol, (path, kernel.std())
            if bias is not None:
                assert np.abs(np.asarray(bias)).max() <= bound * (1 + 1e-6) and np.any(bias), path
        checked += 1
    assert checked == 40


@pytest.mark.parametrize("torch_init", [False, True], ids=["flax_default", "torch_init"])
def test_engine_picks_the_init_by_torch_init(tmp_path, torch_init, capsys):
    """``train.torch_init`` false or missing: Flax's init (zero biases);
    true: PyTorch's (U(±1/√fan) biases) and the JAX engine's message.  Both
    depend on ``train.seed`` alone."""
    cfg = json.loads(write_tiny_config(tmp_path).read_text())
    if torch_init:
        cfg["train"]["torch_init"] = True
    path = tmp_path / "init.json"
    path.write_text(json.dumps(cfg))
    engines = [run.build_session(load_config(str(path), phase="train"))[1] for _ in range(2)]
    torch.manual_seed(123)  # the global RNG does not reach the weights
    engines.append(Model(CDAN(), load_config(str(path), phase="train"), engines[0].dataloader))
    conv = [e.network.encoder.conv2.conv for e in engines]
    assert all(torch.equal(conv[0].weight, c.weight) for c in conv[1:])
    assert bool(conv[0].bias.abs().max() > 0) == torch_init
    fan = 9 * 64
    if torch_init:
        assert float(conv[0].weight.abs().max()) <= 1 / math.sqrt(fan)
    else:
        assert float(conv[0].weight.abs().max()) > 1 / math.sqrt(fan)  # the normal's tails
    out = capsys.readouterr().out
    assert ("[ENGINE] torch-default re-initialization applied" in out) == torch_init


# ------------------------------------------------------------------ profiler


def test_profiler_traces_the_listed_epoch_on_the_cpu(tmp_path, capsys):
    """``logging.profiler`` {enabled, trace_epochs: [2]}: a CPU CLI run of two
    epochs writes ``profile/epoch_002.json``, a Chrome trace of that epoch's
    operators and the port's spans, and nothing for epoch 1; the epoch's
    device ranges (none on the CPU) are printed beside the trace's path."""
    cfg = json.loads(write_tiny_config(tmp_path).read_text())
    cfg["train"]["n_epoch"] = 2
    cfg["train"]["bn_recalibration"] = False
    cfg["logging"]["profiler"] = {"enabled": True, "trace_epochs": [2]}
    path = tmp_path / "prof.json"
    path.write_text(json.dumps(cfg))
    engine = run.main(load_config(str(path), phase="train"))
    (run_dir,) = (tmp_path / "runs" / "noise_synthetic").iterdir()
    assert sorted(p.name for p in (run_dir / "profile").iterdir()) == ["epoch_002.json"]
    events = json.loads((run_dir / "profile" / "epoch_002.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::convolution" in names and "Optimizer.step#Adam.step" in names
    assert {"train/step", "train/backward", "data/next_batch"} <= names
    assert "epoch_002.json; device ranges: none" in capsys.readouterr().out
    assert engine.state.step == 4
