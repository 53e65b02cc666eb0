"""Helpers shared by the PyTorch port's CLI tests: a tiny copy of
``noise_synthetic.json`` for the CPU, and the checks of its train and test
runs."""

import json
from pathlib import Path

import numpy as np

from multi_degradation_image_enhancement_tpu_torch.engine.checkpoint import load_weights
from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "multi_degradation_image_enhancement_tpu" / "config" / "noise_synthetic.json"


TEST_IMAGES = 3  # two batches of 2, the second padded


def write_tiny_config(tmp: Path) -> Path:
    """``noise_synthetic.json`` cut to 32×48 images at batch 2 on the CPU,
    fp32: 4 training images for one epoch, and 3 test images; every output
    under ``tmp``."""
    cfg = json.loads(CONFIG.read_text())
    train, test = cfg["train"], cfg["test"]
    train.update(device="cpu", n_epoch=1, precision="fp32", model_path=str(tmp / "weights"))
    test.update(device="cpu", model_path=str(tmp / "weights"))
    train["dataset"]["args"]["n_images"] = 4
    test["dataset"]["args"]["n_images"] = TEST_IMAGES
    for block in (train, test):
        for op in block["dataset"]["args"]["transform"]["ops"]:
            if op["name"] == "Resize":
                op["args"] = {"height": 32, "width": 48}
        block["dataloader"]["args"]["batch_size"] = 2
    cfg["save_outputs"]["output_dir"] = str(tmp / "outputs")
    cfg["logging"]["root_dir"] = str(tmp / "runs")
    path = tmp / "tiny.json"
    path.write_text(json.dumps(cfg))
    return path


def check_tiny_run(tmp: Path) -> None:
    """The run wrote the checkpoint (strict load), its pre-recalibration copy,
    one epoch row in train.csv and the recalibration in summary.json."""
    weights = tmp / "weights" / "CDAN_noise_synthetic.pt"
    assert weights.is_file() and Path(f"{weights}.prerecal").is_file()
    load_weights(str(weights), CDAN())
    (csv_path,) = (tmp / "runs").glob("noise_synthetic/*/train.csv")
    header, row = csv_path.read_text().splitlines()
    cols = dict(zip(header.split(","), row.split(",")))
    assert cols["type"] == "epoch" and cols["epoch"] == "1"
    assert np.isfinite(float(cols["loss_total"]))
    summary = json.loads((csv_path.parent / "summary.json").read_text())
    assert summary["bn_recalibration_passes"] == 3


def check_tiny_test_run(tmp: Path) -> dict:
    """The test run wrote one PNG per scored image and one ``pre`` row with
    finite losses and the psnr/ssim/lpips metrics; returns that row."""
    pngs = sorted(p.name for p in (tmp / "outputs").glob("*.png"))
    assert pngs == [f"raw_{i}.png" for i in range(1, TEST_IMAGES + 1)]
    (csv_path,) = (tmp / "runs").glob("noise_synthetic/*/test.csv")
    header, row = csv_path.read_text().splitlines()
    cols = dict(zip(header.split(","), row.split(",")))
    assert cols["type"] == "test" and cols["stage"] == "pre" and cols["batches"] == "2"
    assert sorted(k for k in cols if k.startswith("metric_")) == [
        "metric_lpips", "metric_psnr", "metric_ssim"]
    for k in ("loss_total", "loss_charbonnier", "loss_ssim", "metric_psnr", "metric_ssim",
              "metric_lpips"):
        assert np.isfinite(float(cols[k])), k
    summary = json.loads((csv_path.parent / "summary.json").read_text())
    assert summary["test_batches"] == 2
    assert summary["pretrained_weights"]["lpips_alex.npz"] in ("pretrained", "random_frozen")
    return cols
