"""Helpers shared by the PyTorch port's CLI tests: a tiny copy of a shipped
synthetic config (``noise_synthetic.json`` unless named) for the CPU, and the
checks of its train and test runs."""

import json
from pathlib import Path

import numpy as np

from multi_degradation_image_enhancement_tpu_torch.engine.checkpoint import load_weights
from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN

ROOT = Path(__file__).resolve().parents[1]
CONFIG_DIR = ROOT / "multi_degradation_image_enhancement_tpu" / "config"
CONFIG = CONFIG_DIR / "noise_synthetic.json"


TEST_IMAGES = 3  # two batches of 2, the second padded


def load_shipped(task: str) -> dict:
    """A shipped config as a dict, read with the port's dialect (``//`` comments)."""
    from multi_degradation_image_enhancement_tpu_torch.utils.config import load_config

    return json.loads(json.dumps(load_config(str(CONFIG_DIR / f"{task}.json"))))


def write_tiny_config(tmp: Path, task: str = "noise_synthetic") -> Path:
    """``<task>.json`` cut to 32×48 images at batch 2 on the CPU, fp32: 4
    training images for one epoch, and 3 test images; every output under
    ``tmp``."""
    cfg = load_shipped(task)
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


def _rows(csv_path: Path):
    header, *rows = csv_path.read_text().splitlines()
    return [dict(zip(header.split(","), row.split(","))) for row in rows]


def check_tiny_run(tmp: Path, task: str = "noise_synthetic") -> None:
    """The run wrote the checkpoint (strict load), one epoch row in train.csv
    and, where the config recalibrates, the pre-recalibration copy and the
    recalibration in summary.json."""
    recal = bool(load_shipped(task)["train"].get("bn_recalibration"))
    weights = tmp / "weights" / f"CDAN_{task}.pt"
    assert weights.is_file() and Path(f"{weights}.prerecal").is_file() == recal
    load_weights(str(weights), CDAN())
    (csv_path,) = (tmp / "runs").glob(f"{task}/*/train.csv")
    (cols,) = _rows(csv_path)
    assert cols["type"] == "epoch" and cols["epoch"] == "1"
    assert np.isfinite(float(cols["loss_total"]))
    summary = json.loads((csv_path.parent / "summary.json").read_text())
    assert summary.get("bn_recalibration_passes") == (3 if recal else None)


def check_tiny_test_run(tmp: Path, task: str = "noise_synthetic") -> dict:
    """The test run wrote one PNG per scored image under each configured
    prefix, one ``pre`` row with finite losses and the psnr/ssim/lpips
    metrics, and, with post-processing on, a ``post`` row of the same keys;
    returns the rows by stage."""
    cfg = load_shipped(task)
    save, post_on = cfg["save_outputs"], bool(cfg["post_processing"]["enabled"])
    prefixes = [save["raw_prefix"]] if save.get("save_raw") else []
    if save.get("save_postprocessed", True):
        prefixes.append(save.get("post_prefix", "output_"))
    pngs = sorted(p.name for p in (tmp / "outputs").glob("*.png"))
    assert pngs == sorted(f"{p}{i}.png" for p in prefixes for i in range(1, TEST_IMAGES + 1))
    (csv_path,) = (tmp / "runs").glob(f"{task}/*/test.csv")
    rows = {r["stage"]: r for r in _rows(csv_path)}
    assert sorted(rows) == (["post", "pre"] if post_on else ["pre"])
    loss_keys = ["loss_total"] + [f"loss_{t['name']}" for t in cfg["loss"]["terms"]]
    for cols in rows.values():
        assert cols["type"] == "test" and cols["batches"] == "2"
        assert sorted(k for k in cols if k.startswith("metric_")) == [
            "metric_lpips", "metric_psnr", "metric_ssim"]
        for k in loss_keys + ["metric_psnr", "metric_ssim", "metric_lpips"]:
            assert np.isfinite(float(cols[k])), k
    summary = json.loads((csv_path.parent / "summary.json").read_text())
    assert summary["test_batches"] == 2 and summary["post_processing_enabled"] == post_on
    assert summary["pretrained_weights"]["lpips_alex.npz"] in ("pretrained", "random_frozen")
    return rows


def write_tiny_dir_config(tmp: Path, data_root: Path, task: str = "noise") -> Path:
    """A directory-backed ``<task>.json`` (``data.dataset.PairedDataset``) on
    the CPU, fp32, one epoch at batch 2, Resize 32×48, its roots rewritten to
    ``data_root/<task>/{train,test}/{degraded,clean}`` (the layout of
    ``datasets_generation.generate_paired``); every output under ``tmp``."""
    cfg = load_shipped(task)
    train, test = cfg["train"], cfg["test"]
    train.update(device="cpu", n_epoch=1, precision="fp32", model_path=str(tmp / "weights"))
    test.update(device="cpu", model_path=str(tmp / "weights"))
    for split, block in (("train", train), ("test", test)):
        args = block["dataset"]["args"]
        args["input_root"] = str(data_root / task / split / "degraded")
        args["target_root"] = str(data_root / task / split / "clean")
        for op in args["transform"]["ops"]:
            if op["name"] == "Resize":
                op["args"] = {"height": 32, "width": 48}
        block["dataloader"]["args"]["batch_size"] = 2
    cfg["save_outputs"]["output_dir"] = str(tmp / "outputs")
    cfg["logging"]["root_dir"] = str(tmp / "runs")
    path = tmp / f"tiny_{task}.json"
    path.write_text(json.dumps(cfg))
    return path


def write_clean_pngs(folder: Path, sizes, seed: int = 0) -> list:
    """Procedural clean PNGs (``data.synthetic._procedural_clean``), one per
    (H, W) of ``sizes``, as ``img<i>.png``; returns the names."""
    from PIL import Image

    from multi_degradation_image_enhancement_tpu_torch.data.synthetic import _procedural_clean

    folder.mkdir(parents=True, exist_ok=True)
    names = []
    for i, (h, w) in enumerate(sizes):
        names.append(f"img{i}.png")
        Image.fromarray(_procedural_clean(1, h, w, seed=seed + i)[0]).save(folder / names[-1])
    return names
