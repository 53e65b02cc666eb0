"""The plain reference against the port's own modules on the CPU, at a small
size in float32: CDAN's eval forward, one train step (loss, gradients, Adam,
running statistics) and the recipes' loss terms with the harness's
loss-network weights."""

import json
import statistics
from pathlib import Path

import pytest
import torch

from h100bench import weights
from h100bench.checks import moving_leaves
from h100bench.reference.cdan import RefCDAN, split_state
from h100bench.reference.losses import recipe_loss
from h100bench.reference.train import train_steps
from h100bench.traffic import dropout_masks

RECIPES = Path(__file__).resolve().parents[1] / "configs" / "recipes"


def _state(seed, x):
    state = weights.cdan_state(torch.Generator().manual_seed(seed), "cpu")
    params, buffers = split_state(state)
    RefCDAN(params, buffers).calibrate(x)
    return state


def _terms(recipe):
    with open(RECIPES / recipe, encoding="utf-8") as f:
        return json.load(f)["loss"]


def test_eval_forward_matches_the_port_module():
    from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN

    x = torch.rand(2, 32, 48, 3, generator=torch.Generator().manual_seed(1))
    state = _state(2, x)
    model = CDAN()
    model.load_state_dict(state)
    model.eval()
    with torch.no_grad():
        want = model(x)
        got = RefCDAN(*split_state(state))(x)
    assert (got - want).abs().max() < 1e-5
    assert RefCDAN(*split_state(state)).network_share(x) > 0.3


@pytest.mark.parametrize("recipe", ["noise_synthetic.json", "jpeg_synthetic.json"])
def test_one_train_step_matches_the_port_step(recipe, tmp_path, monkeypatch):
    from multi_degradation_image_enhancement_tpu_torch.engine.model import make_train_step
    from multi_degradation_image_enhancement_tpu_torch.engine.state import TrainState
    from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN
    from multi_degradation_image_enhancement_tpu_torch.ops.losses import build_loss_pipeline

    gen = torch.Generator().manual_seed(3)
    x, y = torch.rand(2, 32, 48, 3, generator=gen), torch.rand(2, 32, 48, 3, generator=gen)
    masks = dropout_masks(gen, 2, 32, 48, "cpu")
    state = _state(4, x)
    perceptual = weights.perceptual_state(gen, "cpu")
    weights.write_perceptual_npz(perceptual, str(tmp_path))
    monkeypatch.setenv("MDIE_WEIGHTS_DIR", str(tmp_path))
    loss_cfg = _terms(recipe)

    model = CDAN()
    model.load_state_dict(state)
    ts = TrainState.create(model, 1e-3)
    loss = make_train_step(build_loss_pipeline(loss_cfg, "cpu"), "fp32")(ts, x, y, masks)
    ref = train_steps(state, [(x, y, masks)], loss_cfg["terms"], perceptual, 1e-3)

    assert abs(float(loss["total"]) - ref["losses"][0]) < 1e-5 * abs(ref["losses"][0])
    median = statistics.median(float(g.norm()) for g in ref["grads"].values())
    moving = set(moving_leaves(ref["grads"]))  # the others move by round-off alone
    for k, p in model.named_parameters():
        g = ts.optimizer.state[p]["exp_avg"] / 0.1
        assert (g - ref["grads"][k]).norm() < 1e-3 * max(float(ref["grads"][k].norm()), median), k
        if k in moving:  # Adam's first step is ±lr where |g| >> ε: a rounding flips a sign
            d_ref = ref["params"][k] - state[k]
            assert (p.detach() - ref["params"][k]).norm() < 0.05 * d_ref.norm(), k
    sd = model.state_dict()
    for k, v in ref["buffers"].items():
        assert (sd[k] - v).abs().max() < 1e-5, k


def test_loss_terms_match_the_port_pipeline(tmp_path, monkeypatch):
    from multi_degradation_image_enhancement_tpu_torch.ops.losses import build_loss_pipeline

    gen = torch.Generator().manual_seed(5)
    perceptual = weights.perceptual_state(gen, "cpu")
    weights.write_perceptual_npz(perceptual, str(tmp_path))
    monkeypatch.setenv("MDIE_WEIGHTS_DIR", str(tmp_path))
    out, tgt = torch.rand(2, 64, 96, 3, generator=gen), torch.rand(2, 64, 96, 3, generator=gen)
    for recipe in ("noise_synthetic.json", "jpeg_synthetic.json"):
        cfg = _terms(recipe)
        want = build_loss_pipeline(cfg, "cpu")(out, targets=tgt, is_paired=True, training=True)
        total, parts = recipe_loss(cfg["terms"], out, tgt, perceptual)
        for name, v in parts.items():
            assert abs(float(v) - float(want[name])) < 1e-5 * max(1.0, abs(float(want[name]))), name
        assert abs(float(total) - float(want["total"])) < 1e-5 * abs(float(want["total"]))


def test_fp8_control_moves_the_output():
    x = torch.rand(2, 32, 48, 3, generator=torch.Generator().manual_seed(6))
    state = _state(7, x)
    with torch.no_grad():
        exact = RefCDAN(*split_state(state))(x)
        fp8 = RefCDAN(*split_state(state), quant="fp8")(x)
    assert (fp8 - exact).abs().mean() > 1e-3
