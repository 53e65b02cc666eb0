"""PyTorch port: does the blur recipe beat its degraded inputs in the JAX
package where the port does not?  The yardstick and the experiment.

The yardstick, tested here: the identity restorer's test metrics (PSNR,
SSIM) of both packages agree on the same clean images blurred with the same
explicit parameters, so each package's "degraded inputs" score measures the
same thing.

The experiment, run as a script (CPU, minutes):

    PYTHONPATH= JAX_PLATFORMS=cpu python -m tests.test_torch_blur_suspect <out_dir> \\
        [--epochs 12] [--images 64] [--hw 64 96]

trains ``config/blur_synthetic.json`` cut to ``--images`` training images at
``--hw``, batch 8, ``--epochs`` epochs, fp32, unfused DenseBlocks, on the CPU,
once in each package; scores each checkpoint with ``-p test`` (32 test
images) and each package's degraded inputs (the port's ``degraded_scores``;
the JAX test loader's inputs through its metrics pipeline), and prints one
JSON object: per package the restored and the degraded PSNR / SSIM.
"""

import argparse
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from multi_degradation_image_enhancement_tpu.ops import degradations as jdeg
from multi_degradation_image_enhancement_tpu.ops.metrics import (
    build_metrics_pipeline as jax_metrics,
)
from multi_degradation_image_enhancement_tpu_torch.ops import degradations as deg
from multi_degradation_image_enhancement_tpu_torch.ops.metrics import build_metrics_pipeline

METRICS = {"enabled": True, "items": [{"name": "psnr"}, {"name": "ssim"}]}


def test_identity_scores_agree_on_blurred_images():
    """The same clean images, blurred with the same kernel indices by each
    package, scored as the identity restorer by each metrics pipeline: the
    same PSNR and SSIM (f32, other sum orders)."""
    rng = np.random.RandomState(0)
    clean = rng.uniform(0, 255, (4, 32, 48, 3)).astype(np.float32)
    k_idx = np.array([0, 1, 2, 3], np.int32)
    want_deg = np.asarray(jdeg.apply_with_params("blur", jnp.asarray(clean),
                                                 {"k_idx": jnp.asarray(k_idx)}))
    got_deg = deg.apply_with_params("blur", torch.from_numpy(clean),
                                    {"k_idx": torch.from_numpy(k_idx)}).numpy()
    np.testing.assert_allclose(got_deg, want_deg, atol=1e-3)
    want = jax_metrics(METRICS)(jnp.asarray(want_deg / 255.0), targets=jnp.asarray(clean / 255.0))
    got = build_metrics_pipeline(METRICS, "cpu")(torch.from_numpy(got_deg / 255.0).float(),
                                                 targets=torch.from_numpy(clean / 255.0).float())
    for k in ("psnr", "ssim"):
        assert abs(float(got[k]) - float(want[k])) <= 1e-4 * abs(float(want[k])), k


def _config(out: Path, epochs: int, images: int, hw, batch: int = 8, test_images: int = 32):
    """blur_synthetic.json cut for the CPU; every output under ``out/<pkg>``."""
    from tests.torch_train_cli import load_shipped

    cfg = load_shipped("blur_synthetic")
    for phase in ("train", "test"):
        block = cfg[phase]
        block["device"] = "cpu"
        block["dataloader"]["args"].update(batch_size=batch, num_workers=1)
        for op in block["dataset"]["args"]["transform"]["ops"]:
            if op["name"] == "Resize":
                op["args"] = {"height": hw[0], "width": hw[1]}
    cfg["train"].update(n_epoch=epochs, precision="fp32", fused_dense=False)
    cfg["train"]["dataset"]["args"]["n_images"] = images
    cfg["test"]["dataset"]["args"]["n_images"] = test_images
    cfg["save_outputs"]["enabled"] = False
    paths = {}
    for pkg in ("jax", "port"):
        c = json.loads(json.dumps(cfg))
        for phase in ("train", "test"):
            c[phase]["model_path"] = str(out / pkg / "weights")
        c["logging"]["root_dir"] = str(out / pkg / "runs")
        paths[pkg] = out / f"{pkg}.json"
        paths[pkg].write_text(json.dumps(c))
    return paths


def _test_row(out: Path, pkg: str) -> dict:
    (csv,) = (out / pkg / "runs").glob("blur_synthetic/*/test.csv")
    header, *rows = csv.read_text().splitlines()
    row = dict(zip(header.split(","), rows[0].split(",")))
    return {k: float(row[f"metric_{k}"]) for k in ("psnr", "ssim")}


def run_experiment(out: Path, epochs: int, images: int, hw) -> dict:
    import run as jax_run  # the JAX package's CLI runner at the repo root
    from multi_degradation_image_enhancement_tpu.engine.model import _unpack_paired
    from multi_degradation_image_enhancement_tpu.utils.config import load_config as jax_load
    from multi_degradation_image_enhancement_tpu_torch import run as port_run
    from multi_degradation_image_enhancement_tpu_torch.degraded_scores import degraded_scores
    from multi_degradation_image_enhancement_tpu_torch.utils.config import load_config as port_load

    out.mkdir(parents=True, exist_ok=True)
    paths = _config(out, epochs, images, hw)
    res = {"epochs": epochs, "images": images, "hw": list(hw)}
    for phase in ("train", "test"):
        jax_run.main(jax_load(str(paths["jax"]), phase=phase))
        port_run.main(port_load(str(paths["port"]), phase=phase))

    cfg = jax_load(str(paths["jax"]), phase="test")
    cfg["logging"] = {"enabled": False}
    logger, engine = jax_run.build_session(cfg)
    logger.close()
    per = []
    for batch in engine.dataloader:
        inputs, targets, mask = _unpack_paired(batch)
        per.append({k: float(v) for k, v in engine.metrics_pipe(
            inputs, targets=targets, mask=mask).items()})
    jax_degraded = {k: float(np.mean([p[k] for p in per])) for k in ("psnr", "ssim")}
    cfg = port_load(str(paths["port"]), phase="test")
    cfg["logging"] = {"enabled": False}
    port_degraded = {k: float(v) for k, v in degraded_scores(cfg).items() if k in ("psnr", "ssim")}
    res["jax"] = {"restored": _test_row(out, "jax"), "degraded": jax_degraded}
    res["port"] = {"restored": _test_row(out, "port"), "degraded": port_degraded}
    for pkg in ("jax", "port"):
        res[pkg]["beats_inputs"] = res[pkg]["restored"]["psnr"] > res[pkg]["degraded"]["psnr"]
    return res


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("out", type=Path)
    parser.add_argument("--epochs", type=int, default=12)
    parser.add_argument("--images", type=int, default=64)
    parser.add_argument("--hw", type=int, nargs=2, default=(64, 96))
    args = parser.parse_args(sys.argv[1:])
    print(json.dumps(run_experiment(args.out, args.epochs, args.images, tuple(args.hw))))
