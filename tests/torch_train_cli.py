"""Helpers shared by the PyTorch port's CLI training tests: a tiny copy of
``noise_synthetic.json`` for the CPU, and the checks of its run."""

import json
from pathlib import Path

import numpy as np

from multi_degradation_image_enhancement_tpu_torch.engine.checkpoint import load_weights
from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "multi_degradation_image_enhancement_tpu" / "config" / "noise_synthetic.json"


def write_tiny_config(tmp: Path) -> Path:
    """``noise_synthetic.json`` cut to 4 images at 32×48, batch 2, one epoch,
    fp32 on the CPU, with its outputs under ``tmp``."""
    cfg = json.loads(CONFIG.read_text())
    train = cfg["train"]
    train.update(device="cpu", n_epoch=1, precision="fp32", model_path=str(tmp / "weights"))
    train["dataset"]["args"]["n_images"] = 4
    for op in train["dataset"]["args"]["transform"]["ops"]:
        if op["name"] == "Resize":
            op["args"] = {"height": 32, "width": 48}
    train["dataloader"]["args"]["batch_size"] = 2
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
