"""PyTorch port: post-processing (ops/post_processing.py) and the eval
engine's POST stage vs the JAX package, on the same numpy batches.

Every op to 1e-6 (measured on the CPU: sharpen 1.8e-07, the others ≤
6.0e-08), on [0, 1] inputs and on 0..255 inputs (the whole-batch ``_auto01``
guard); the POST outputs, losses and metrics of one padded eval batch
against the JAX engine's eval step.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_degradation_image_enhancement_tpu.engine.model import Model as JaxModel
from multi_degradation_image_enhancement_tpu.models.cdan import CDAN as JaxCDAN
from multi_degradation_image_enhancement_tpu.ops import post_processing as jpp
from multi_degradation_image_enhancement_tpu_torch.engine import checkpoint as ckpt
from multi_degradation_image_enhancement_tpu_torch.engine.model import Model
from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN
from multi_degradation_image_enhancement_tpu_torch.ops import post_processing as pp
from multi_degradation_image_enhancement_tpu_torch.utils.jax_port import flax_to_state_dict
from tests.torch_train_cli import load_shipped

OPS = [("enhance_contrast", {"contrast_factor": 1.03}), ("enhance_color", {"saturation_factor": 1.55}),
       ("sharpen", {"strength": 0.35}), ("soft_denoise", {"sigma": 0.15})]


@pytest.mark.parametrize("scale", [1.0, 255.0], ids=["unit", "u8"])
@pytest.mark.parametrize("name,args", OPS, ids=[n for n, _ in OPS])
def test_op_matches_jax(name, args, scale):
    x = (np.random.RandomState(0).rand(3, 12, 20, 3) * scale).astype(np.float32)
    want = np.asarray(getattr(jpp, name)(jnp.asarray(x), **args))
    got = getattr(pp, name)(torch.from_numpy(x), **args).numpy()
    assert np.abs(got - want).max() <= 1e-6


def test_auto01_takes_one_maximum_over_the_whole_batch():
    """One sample above 1 rescales every sample, padded repeats included."""
    x = np.random.RandomState(1).rand(2, 4, 4, 3).astype(np.float32)
    x[1] *= 255.0
    got = pp._auto01(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.asarray(jpp._auto01(jnp.asarray(x))))
    assert got[0].max() < 1.0 / 255.0 + 1e-7


def test_chain_of_a_shipped_config_matches_jax():
    cfg = load_shipped("low_light_synthetic")["post_processing"]
    x = np.random.RandomState(2).rand(2, 16, 24, 3).astype(np.float32)
    want = np.asarray(jpp.apply_postprocessing(jnp.asarray(x), cfg))
    assert np.abs(pp.apply_postprocessing(torch.from_numpy(x), cfg).numpy() - want).max() <= 1e-6
    off = {**cfg, "enabled": False}
    assert pp.apply_postprocessing(torch.from_numpy(x), off) is not None
    assert torch.equal(pp.apply_postprocessing(torch.from_numpy(x), off), torch.from_numpy(x))
    with pytest.raises(ValueError, match="Unknown post-processing op"):
        pp.apply_postprocessing(torch.from_numpy(x), {"enabled": True, "ops": [{"name": "gamma"}]})


def test_eval_step_post_stage_matches_jax_engine(tmp_path):
    """low_light_synthetic's post-processing, losses (mse, ssim) and metrics
    (psnr, ssim) on one padded batch through both engines' eval steps,
    module path in f32: raw and post outputs within 2e-4, POST scores within
    1e-4 (PSNR 1e-3 dB)."""
    b, h, w = 3, 32, 48
    x = jnp.zeros((1, h, w, 3), jnp.float32)
    v = jax.jit(lambda k: JaxCDAN().init({"params": k}, x, train=False))(jax.random.key(4))
    rng = np.random.RandomState(4)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, t: (rng.uniform(-0.1, 0.1, t.shape) if jax.tree_util.keystr(p).endswith("['mean']")
                      else rng.uniform(0.3, 1.0, t.shape)).astype(np.float32), v["batch_stats"])
    variables = {"params": jax.tree.map(np.asarray, v["params"]), "batch_stats": stats}
    shipped = load_shipped("low_light_synthetic")
    cfg = {"name": "t", "phase": "test", "model": {},
           "test": {"device": "cpu", "model_path": str(tmp_path), "model_name": "cdan.pt",
                    "dataloader": {"args": {"batch_size": b}}, "dataset": {"is_paired": True}},
           "train": {"n_epoch": 1, "lr": 1e-3, "precision": "fp32"},
           "loss": {"terms": [t for t in shipped["loss"]["terms"] if t["name"] in ("mse", "ssim")]},
           "metrics": {"items": [{"name": "psnr"}, {"name": "ssim"}]},
           "evaluation": shipped["evaluation"], "post_processing": shipped["post_processing"],
           "save_outputs": {"enabled": False}}
    targets = rng.rand(b, h, w, 3).astype(np.float32)
    inputs = np.clip(targets * 0.3 + 0.05 * rng.randn(b, h, w, 3), 0, 1).astype(np.float32)
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    jstep = JaxModel(network=JaxCDAN(), config=json.loads(json.dumps(cfg)),
                     dataloader=None)._build_eval_step(variables["params"], variables["batch_stats"])
    want = jstep(variables["params"], variables["batch_stats"], jnp.asarray(inputs),
                 jnp.asarray(targets), jnp.asarray(mask))

    cdan = CDAN()
    cdan.load_state_dict(flax_to_state_dict(variables), strict=True)
    ckpt.save_weights(str(tmp_path / "cdan.pt"), cdan)
    engine = Model(network=CDAN(), config=cfg, dataloader=None)
    assert engine.eval_on_post
    got = engine._build_eval_step(engine._load_for_eval())(
        torch.from_numpy(inputs), torch.from_numpy(targets), torch.from_numpy(mask))
    for k in ("raw", "post"):
        assert np.abs(got[k].numpy() - np.asarray(want[k])).max() <= 2e-4, k
    assert np.abs(got["post"].numpy() - got["raw"].numpy()).max() > 1e-3  # the chain did work
    for stage in ("pre_loss", "pre_metric", "post_loss", "post_metric"):
        assert sorted(got[stage]) == sorted(want[stage])
        for k, val in want[stage].items():
            lim = 1e-3 if k == "psnr" else 1e-4
            assert abs(float(got[stage][k]) - float(val)) <= lim, (stage, k)
