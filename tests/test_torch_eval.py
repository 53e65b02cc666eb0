"""PyTorch port: the evaluation engine (engine/model.py test phase, run.py
``-p test``) vs the JAX engine.

The eval steps of both engines score the same numpy batch with the same
CDAN weights (carried across with ``utils/jax_port.py``) and the same LPIPS
weights (one npz in ``$MDIE_WEIGHTS_DIR``); the CLI scores the checkpoint of
the tiny ``-p train`` run of ``tests/torch_train_cli.py`` on the CPU.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_degradation_image_enhancement_tpu.engine.model import Model as JaxModel
from multi_degradation_image_enhancement_tpu.models.cdan import CDAN as JaxCDAN
from multi_degradation_image_enhancement_tpu.ops.perceptual import LPIPS as JaxLPIPS
from multi_degradation_image_enhancement_tpu_torch import run
from multi_degradation_image_enhancement_tpu_torch.engine import checkpoint as ckpt
from multi_degradation_image_enhancement_tpu_torch.engine.model import Model
from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN
from multi_degradation_image_enhancement_tpu_torch.utils.config import load_config
from multi_degradation_image_enhancement_tpu_torch.utils.jax_port import flax_to_state_dict
from tests.torch_train_cli import (
    CONFIG,
    ROOT,
    check_tiny_run,
    check_tiny_test_run,
    write_tiny_config,
)

B, H, W = 3, 32, 48  # LPIPS-alex needs about 32 pixels a side


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(JAX CDAN variables with live BN statistics, the LPIPS npz's dir)."""
    x = jnp.zeros((1, H, W, 3), jnp.float32)
    v = jax.jit(lambda k: JaxCDAN().init({"params": k}, x, train=False))(jax.random.key(1))
    rng = np.random.RandomState(1)

    def draw(path, t):  # means near 0 keep the decoder's ReLUs open (test_torch_cdan.py)
        if jax.tree_util.keystr(path).endswith("['mean']"):
            return rng.uniform(-0.1, 0.1, t.shape).astype(np.float32)
        return rng.uniform(0.3, 1.0, t.shape).astype(np.float32)

    variables = {"params": jax.tree.map(np.asarray, v["params"]),
                 "batch_stats": jax.tree_util.tree_map_with_path(draw, v["batch_stats"])}
    z = jnp.zeros((1, 64, 64, 3), jnp.float32)
    lp = JaxLPIPS(net_type="alex").init(jax.random.key(2), z, z)["params"]
    wdir = tmp_path_factory.mktemp("weights")
    np.savez(wdir / "lpips_alex.npz", **{
        "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(lp)[0]})
    return variables, wdir


def _config(fused, tmp_path):
    base = json.loads(CONFIG.read_text())
    test = {"device": "cpu", "model_path": str(tmp_path), "model_name": "cdan.pt",
            "dataloader": {"args": {"batch_size": B}}, "dataset": {"is_paired": True}}
    if fused is not None:
        test["fused_kernels"] = fused
    return {"name": "t", "phase": "test", "model": {}, "test": test,
            "train": {"n_epoch": 1, "lr": 1e-3, "precision": "fp32"},
            "loss": base["loss"], "metrics": base["metrics"], "evaluation": base["evaluation"],
            "post_processing": {"enabled": False}, "save_outputs": {"enabled": False}}


@pytest.mark.parametrize("fused", [False, True], ids=["module", "fused"])
def test_eval_step_matches_jax_engine(weights, tmp_path, monkeypatch, fused):
    """The port's eval step against the JAX engine's, on one padded batch
    (the mask drops the last sample).  Module path, f32 both sides: losses
    and SSIM/LPIPS within 1e-4, PSNR within 1e-3 dB.  Fused path (JAX: its
    serving forward in interpret mode; the port: its plain kernels): the
    outputs differ at bf16 class (DenseBlock features in bf16 on the JAX
    side, max 2e-2 / mean 2e-3 as tests/test_cdan_fast.py), so the scores
    within 2e-3 and 0.05 dB."""
    variables, wdir = weights
    monkeypatch.setenv("MDIE_WEIGHTS_DIR", str(wdir))
    # f32 activations, as the JAX engine's served forward, whatever the port's file says
    tuning = tmp_path / "serving_tuning_f32_act.json"
    tuning.write_text(json.dumps({"db_bf16_act": False}))
    monkeypatch.setenv("MDIE_SERVING_TUNING", str(tuning))
    rng = np.random.RandomState(3)
    targets = rng.rand(B, H, W, 3).astype(np.float32)
    inputs = np.clip(targets + 0.1 * rng.randn(B, H, W, 3), 0, 1).astype(np.float32)
    mask = np.array([1.0, 1.0, 0.0], np.float32)

    jax_engine = JaxModel(network=JaxCDAN(), config=_config(fused, tmp_path), dataloader=None)
    jstep = jax_engine._build_eval_step(variables["params"], variables["batch_stats"])
    want = jstep(variables["params"], variables["batch_stats"], jnp.asarray(inputs),
                 jnp.asarray(targets), jnp.asarray(mask))

    cdan = CDAN()
    cdan.load_state_dict(flax_to_state_dict(variables), strict=True)
    ckpt.save_weights(str(tmp_path / "cdan.pt"), cdan)
    engine = Model(network=CDAN(), config=_config(fused, tmp_path), dataloader=None)
    model = engine._load_for_eval()
    assert (engine._fused_eval_forward(model) is not None) == fused
    got = engine._build_eval_step(model)(torch.from_numpy(inputs), torch.from_numpy(targets),
                                         torch.from_numpy(mask))

    out_err = np.abs(got["raw"].numpy() - np.asarray(want["raw"]))
    bar = (2e-2, 2e-3) if fused else (2e-4, 2e-5)
    assert out_err.max() <= bar[0] and out_err.mean() <= bar[1], (out_err.max(), out_err.mean())
    tol, psnr_tol = (2e-3, 5e-2) if fused else (1e-4, 1e-3)
    diffs = {k: abs(float(got[s][k]) - float(want[s][k]))
             for s in ("pre_loss", "pre_metric") for k in want[s]}
    print(f"outputs max {out_err.max():.3e} mean {out_err.mean():.3e}; score differences {diffs}")
    for stage in ("pre_loss", "pre_metric"):
        assert sorted(got[stage]) == sorted(want[stage])  # jit returns its dicts key-sorted
        for k, v in want[stage].items():
            lim = psnr_tol if k == "psnr" else tol
            assert abs(float(got[stage][k]) - float(v)) <= lim, (stage, k, float(got[stage][k]), float(v))
    assert list(got["pre_metric"]) == ["psnr", "ssim", "lpips"]


def test_fused_flag_routes_eval(tmp_path):
    """``test.fused_kernels``: absent/"auto" → the module on the CPU; true →
    the fused forward (plain kernels on the CPU); false → the module; a
    network with no served forward (neither a CDAN nor a Restormer) with
    true raises (model.py:464-492).  With
    ``post_processing.enabled`` the engine builds and scores the POST stage
    unless ``evaluation.postprocessed`` is false (model.py:269-273)."""
    for flag, fused in ((None, False), ("auto", False), (True, True), (False, False)):
        engine = Model(network=CDAN(), config=_config(flag, tmp_path), dataloader=None)
        assert (engine._fused_eval_forward(CDAN().eval()) is not None) == fused, flag
    engine = Model(network=CDAN(), config=_config(True, tmp_path), dataloader=None)
    with pytest.raises(RuntimeError, match="Identity, which has no served forward"):
        engine._fused_eval_forward(torch.nn.Identity())
    assert not engine.eval_on_post
    cfg = _config(None, tmp_path)
    cfg["post_processing"] = {"enabled": True}
    for post_flag, on in ((None, True), (True, True), (False, False)):
        cfg["evaluation"] = {"raw": True, "postprocessed": post_flag}
        assert Model(network=CDAN(), config=cfg, dataloader=None).eval_on_post == on


def test_max_images_stops_after_the_batch_that_reaches_it(tmp_path):
    """``save_outputs.max_images`` 1 at batch 2: the first batch's two images
    are written and the loop stops there (model.py:847-862).  In-process,
    with the fused forward forced (plain kernels on the CPU)."""
    cfg_path = write_tiny_config(tmp_path)
    cfg = json.loads(cfg_path.read_text())
    cfg["save_outputs"]["max_images"] = 1
    cfg["test"]["fused_kernels"] = True
    cfg_path.write_text(json.dumps(cfg))
    ckpt.save_weights(str(tmp_path / "weights" / cfg["test"]["model_name"]), CDAN())
    run.main(load_config(str(cfg_path), phase="test"))
    assert sorted(p.name for p in (tmp_path / "outputs").iterdir()) == ["raw_1.png", "raw_2.png"]
    (csv_path,) = (tmp_path / "runs").glob("noise_synthetic/*/test.csv")
    header, row = csv_path.read_text().splitlines()
    assert dict(zip(header.split(","), row.split(",")))["batches"] == "1"


def test_cli_scores_the_trained_checkpoint_on_cpu(tmp_path):
    """``python -m …_torch.run -c tiny.json -p train`` then ``-p test``: one
    PNG per test image, the ``pre`` row with psnr/ssim/lpips, the summary."""
    cfg = write_tiny_config(tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    outs = {}
    for phase in ("train", "test"):
        proc = subprocess.run(
            [sys.executable, "-m", "multi_degradation_image_enhancement_tpu_torch.run",
             "-c", str(cfg), "-p", phase],
            capture_output=True, text=True, timeout=300, cwd=ROOT, env=env,
        )
        assert proc.returncode == 0, proc.stderr[-3000:]
        outs[phase] = proc.stdout
        if phase == "train":
            check_tiny_run(tmp_path)
    assert "[PRE]  Losses -> charbonnier: " in outs["test"]
    metrics_line = next(l for l in outs["test"].splitlines() if l.startswith("[PRE]  Metrics"))
    assert [kv.split(":")[0] for kv in metrics_line.split("-> ")[1].split(", ")] == [
        "psnr", "ssim", "lpips"]
    check_tiny_test_run(tmp_path)
