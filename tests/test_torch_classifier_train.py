"""PyTorch port: classifier training (``classification/train.py``) against the
JAX package's ``build_steps`` and BatchNorm refresh from the same weights
and batches, and the CLI end to end on the CPU."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multi_degradation_image_enhancement_tpu.classification.model import (
    MultiHeadClassifier as JaxClassifier,
)
from multi_degradation_image_enhancement_tpu.classification.train import (
    _losses as jax_losses,
    build_steps,
)
from multi_degradation_image_enhancement_tpu.engine.state import TrainState
from multi_degradation_image_enhancement_tpu_torch import run_pipeline
from multi_degradation_image_enhancement_tpu_torch.classification import train as T
from multi_degradation_image_enhancement_tpu_torch.classification.model import MultiHeadClassifier
from multi_degradation_image_enhancement_tpu_torch.engine.checkpoint import save_weights
from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN
from multi_degradation_image_enhancement_tpu_torch.utils.jax_port import (
    classifier_mapping,
    classifier_state_dict,
    state_dict_to_flax,
)

H, W, N_CLASSES, B, LR = 32, 48, 9, 4, 1e-3


@pytest.fixture(scope="module")
def setup():
    """A JAX classifier's variables (random BatchNorm statistics), its
    jitted train and eval steps, and two batches with a pos_weight."""
    model = JaxClassifier(num_classes=N_CLASSES)
    v = model.init({"params": jax.random.key(0)}, jnp.zeros((1, H, W, 3)), train=False)
    rng = np.random.RandomState(0)
    stats = jax.tree.map(lambda t: rng.uniform(0.5, 1.5, t.shape).astype(np.float32),
                         v["batch_stats"])
    variables = {"params": jax.tree.map(np.asarray, v["params"]), "batch_stats": stats}
    batches = []
    for _ in range(2):
        x = rng.randn(B, H, W, 3).astype(np.float32)
        y = (rng.rand(B, N_CLASSES) > 0.6).astype(np.float32)
        s = (rng.rand(B, N_CLASSES) * y).astype(np.float32)
        batches.append((x, y, s))
    pos_weight = rng.uniform(1.0, 5.0, N_CLASSES).astype(np.float32)
    train_step, eval_step = build_steps(model, jnp.asarray(pos_weight))
    return model, variables, batches, pos_weight, train_step, eval_step


def _port(variables) -> MultiHeadClassifier:
    model = MultiHeadClassifier(N_CLASSES)
    model.load_state_dict(classifier_state_dict(variables), strict=True)
    return model


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / max(np.abs(np.asarray(want)).max(), 1e-12)


def _leaves(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


def test_train_step_matches_jax(setup):
    """One Adam step in train mode: the losses, the gradient of every parameter
    (cls + LAMBDA_SEVERITY·sev through the train-mode BatchNorm, ≤ 1e-4 of its
    leaf's largest), every updated parameter where the gradient's sign is
    robust, and the BatchNorm running statistics (Flax's biased variance,
    momentum 0.9)."""
    model_j, variables, batches, pos_weight, train_step, _ = setup
    x, y, s = batches[0]
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])

    def loss_fn(p):
        (cls_logits, sev_logits), _ = model_j.apply(
            {"params": p, "batch_stats": stats}, jnp.asarray(x), train=True,
            mutable=["batch_stats"])
        loss_cls, loss_sev, _ = jax_losses(cls_logits, sev_logits, jnp.asarray(y), jnp.asarray(s),
                                           jnp.asarray(pos_weight))
        return loss_cls + T.LAMBDA_SEVERITY * loss_sev

    want_g = _leaves(jax.jit(jax.grad(loss_fn))(params))
    state = TrainState.create(params=params, batch_stats=stats, tx=optax.adam(LR))
    new_state, aux = train_step(state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(s))

    model = _port(variables)
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    got = T.train_step(model, opt, *_t(x, y, s), torch.from_numpy(pos_weight))
    for k in ("loss_cls", "loss_sev"):
        assert _rel(got[k].numpy(), aux[k]) <= 1e-5, k
    assert np.abs(got["probs"].numpy() - np.asarray(aux["probs"])).max() <= 1e-5
    assert np.abs(got["sev_pred"].numpy() - np.asarray(aux["sev_pred"])).max() <= 1e-5

    grads = {**model.state_dict(), **{n: p.grad for n, p in model.named_parameters()}}
    got_g = _leaves(state_dict_to_flax(grads, classifier_mapping())["params"])
    assert want_g.keys() == got_g.keys()
    for k in want_g:
        assert _rel(got_g[k], want_g[k]) <= 1e-4, k

    # Adam's first step moves each element by -lr·g/(|g|+eps): where |g| is
    # above 1e-3 of its leaf's largest, the sign cannot flip within the
    # gradient's 1e-4 and the two steps agree to 1% of lr.
    tree = state_dict_to_flax(model.state_dict(), classifier_mapping())
    want_p, got_p = _leaves(new_state.params), _leaves(tree["params"])
    assert want_p.keys() == got_p.keys()
    for k in want_p:
        g = np.abs(np.asarray(want_g[k]))
        robust = g > 1e-3 * g.max()
        delta = np.abs(np.asarray(got_p[k]) - np.asarray(want_p[k]))
        assert delta[robust].max(initial=0.0) <= 0.01 * LR, k
        assert delta.max() <= 2 * LR, k
    want_s, got_s = _leaves(new_state.batch_stats), _leaves(tree["batch_stats"])
    assert want_s.keys() == got_s.keys()
    for k in want_s:
        assert _rel(got_s[k], want_s[k]) <= 1e-4, k


def test_eval_step_matches_jax(setup):
    _, variables, batches, pos_weight, _, eval_step = setup
    x, y, s = batches[1]
    want = eval_step(variables["params"], variables["batch_stats"], *map(jnp.asarray, (x, y, s)))
    got = T.eval_step(_port(variables), *_t(x, y, s), torch.from_numpy(pos_weight))
    for k in ("loss_cls", "loss_sev"):
        assert _rel(got[k].numpy(), want[k]) <= 1e-5, k
    for k in ("probs", "sev_pred"):
        assert np.abs(got[k].numpy() - np.asarray(want[k])).max() <= 1e-5, k


def test_stats_refresh_matches_jax(setup):
    """One BatchNorm recalibration sweep over two batches with frozen weights
    (the JAX CLI's ``_refresh``, ``train.py:452-458``)."""
    model_j, variables, batches, _, _, _ = setup

    @jax.jit
    def refresh(p, bs, x):
        _, upd = model_j.apply({"params": p, "batch_stats": bs}, x, train=True,
                               mutable=["batch_stats"])
        return upd["batch_stats"]

    stats = variables["batch_stats"]
    for x, _, _ in batches:
        stats = refresh(variables["params"], stats, jnp.asarray(x))
    model = _port(variables)
    before = {k: v.clone() for k, v in model.state_dict().items() if "running" not in k}
    T.refresh_stats(model, (torch.from_numpy(x) for x, _, _ in batches))
    tree = state_dict_to_flax(model.state_dict(), classifier_mapping())
    want_s, got_s = _leaves(stats), _leaves(tree["batch_stats"])
    for k in want_s:
        assert _rel(got_s[k], want_s[k]) <= 1e-4, k
    after = model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items() if "num_batches" not in k)
    assert not model.training


@pytest.mark.parametrize("positives", [True, False])
def test_losses_match_jax(positives):
    """pos-weighted BCE + the severity SmoothL1 masked to positive labels; with
    no positive label the severity loss is 0."""
    rng = np.random.RandomState(4)
    cls, sev = rng.randn(2, 6, N_CLASSES).astype(np.float32) * 3
    y = (rng.rand(6, N_CLASSES) > 0.5).astype(np.float32) * positives
    s = rng.rand(6, N_CLASSES).astype(np.float32)
    pw = rng.uniform(0.5, 4.0, N_CLASSES).astype(np.float32)
    want = jax_losses(*map(jnp.asarray, (cls, sev, y, s, pw)))
    got = T.losses(*_t(cls, sev, y, s, pw))
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-6 * max(1.0, np.abs(w).max())
    assert positives or float(got[1]) == 0.0


ARTIFACTS = ("training.log", "history.json", "best_model.pt", "best_model.pt.json",
             "thresholds_val.json", "per_class_f1_val.json", "per_class_f1_test.json",
             "summary.json")


def _cli(run_dir: Path, *extra: str):
    return T.main(["--synthetic", "--device", "cpu", "--no_pretrained", "--run_dir", str(run_dir),
                   *extra])


def test_cli_synthetic_smoke_and_pipeline_load(tmp_path):
    """``--synthetic --device cpu``: one epoch of 8 images at 32×48 through all
    four stages writes every artifact tests/test_classifier_quality.py lists
    (``.pt`` for ``.msgpack``), the JAX meta and summary keys, and a
    checkpoint and thresholds that the serving pipeline loads on the CPU."""
    run_dir = tmp_path / "run"
    summary = _cli(run_dir, "--synthetic_images", "8", "--epochs", "1", "--batch_size", "4",
                   "--input_hw", str(H), str(W), "--th_steps", "3", "--bn_recal_passes", "1")
    for name in ARTIFACTS:
        assert (run_dir / name).exists(), name
    for split in ("val", "test"):
        diag = run_dir / "diagnostics" / split
        assert (diag / "ap_pr_summary.json").is_file()
        assert len(list((diag / "score_hists").iterdir())) == N_CLASSES
        assert (diag / "errors" / "noise" / "manifest.json").is_file()
    meta = json.loads((run_dir / "best_model.pt.json").read_text())
    assert set(meta) >= {"classes", "default_thresh", "pos_weight", "epoch", "val_f1_micro",
                         "normalize", "imagenet_mean", "imagenet_std"}
    assert json.loads(json.dumps(summary)) == json.loads((run_dir / "summary.json").read_text())
    assert summary["backend"] == "cpu" and summary["best_epoch"] == 1
    assert set(summary["test"]) == {"loss", "loss_cls", "loss_sev", "f1_micro", "f1_macro", "sev_mae"}
    log = (run_dir / "training.log").read_text()
    assert "BN RECALIBRATION" in log and "recalibrated=" in log and "[OK]" in log
    thresholds = json.loads((run_dir / "thresholds_val.json").read_text())
    assert set(thresholds["thresholds"]) == set(summary["classes"])
    assert len(json.loads((run_dir / "history.json").read_text())["val_f1micro"]) == 1

    weights = tmp_path / "weights"
    weights.mkdir()
    save_weights(str(weights / "CDAN_noise.pt"), CDAN())
    pipe = run_pipeline.build_full_pipeline(str(run_dir / "best_model.pt"), str(weights),
                                            device="cpu")
    assert pipe.router.expert_names == ["noise"]
    assert [float(t) for t in pipe.thresholds.cpu()] == pytest.approx(
        [thresholds["thresholds"]["noise"]])
    ckpt = torch.load(run_dir / "best_model.pt", map_location="cpu")
    got = pipe.classifier.state_dict()
    assert all(torch.equal(got[k].float(), v.float()) for k, v in ckpt.items())


@pytest.mark.slow  # ResNet-18 trained for a few CPU epochs: minutes
def test_classifier_cli_reaches_f1_floor(tmp_path):
    """The port's twin of tests/test_classifier_quality.py at its scale and
    floors: val F1-micro ≥ 0.35 with tuned thresholds, test ≥ 0.30, severity
    MAE ≤ 0.30."""
    run_dir = tmp_path / "run"
    summary = _cli(run_dir, "--synthetic_images", "48", "--synthetic_variants", "2",
                   "--epochs", "4", "--batch_size", "16", "--input_hw", "64", "96",
                   "--th_steps", "7", "--bn_recal_passes", "2")
    for name in ARTIFACTS:
        assert (run_dir / name).exists(), name
    thresholds = json.loads((run_dir / "thresholds_val.json").read_text())
    assert thresholds["val_f1_micro"] >= 0.35, thresholds["val_f1_micro"]
    assert summary["test"]["f1_micro"] >= 0.30, summary["test"]["f1_micro"]
    assert summary["test"]["sev_mae"] <= 0.30, summary["test"]["sev_mae"]
