"""PyTorch port: every shipped synthetic config builds and runs.

* ``run.build_session`` on all 11 ``config/*_synthetic.json`` (device cpu,
  32×48 images, batch 2) builds the train and the test session without a
  "not ported" error, and the train loader yields one batch of each
  degradation through its transforms;
* the tiny CPU CLI trains and then scores ``jpeg_synthetic`` (l1 + VGG + SSIM
  + LPIPS) and ``low_light_synthetic`` (RandomGamma, RandomBrightnessContrast,
  the POST stage with its ``post`` rows and ``pp_*`` PNGs);
* the device repair: a phase with no ``device`` resolves to the card, so it
  raises without one; the metrics and loss pipelines follow the engine's
  device; directory-backed configs still raise.
"""

import json

import pytest
import torch

from multi_degradation_image_enhancement_tpu_torch import run
from multi_degradation_image_enhancement_tpu_torch.engine.model import Model, resolve_device
from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN
from multi_degradation_image_enhancement_tpu_torch.utils.config import load_config
from tests.torch_train_cli import (
    CONFIG_DIR,
    check_tiny_run,
    check_tiny_test_run,
    write_tiny_config,
)

SYNTHETIC = sorted(p.stem for p in CONFIG_DIR.glob("*_synthetic.json"))


def test_eleven_synthetic_configs_ship():
    assert len(SYNTHETIC) == 11


@pytest.mark.parametrize("task", SYNTHETIC)
def test_build_session_on_every_synthetic_config(task, tmp_path):
    path = write_tiny_config(tmp_path, task)
    for phase in ("train", "test"):
        logger, engine = run.build_session(load_config(str(path), phase=phase))
        logger.close()
        assert engine.device.type == "cpu"
    inputs, targets, mask = next(iter(engine.dataloader))  # the test loader: Resize only
    assert inputs.shape == targets.shape == (2, 32, 48, 3) and mask.tolist() == [1.0, 1.0]
    _, engine = run.build_session(load_config(str(path), phase="train"))
    inputs, targets, _ = next(iter(engine.dataloader))
    assert inputs.shape == (2, 32, 48, 3) and bool(torch.isfinite(inputs).all())
    assert float(inputs.min()) >= 0.0 and float(targets.max()) <= 1.0
    assert not torch.equal(inputs, targets)  # the pair was degraded


@pytest.mark.parametrize("task", ["jpeg_synthetic", "low_light_synthetic"])
def test_tiny_cli_trains_and_scores(task, tmp_path):
    config = write_tiny_config(tmp_path, task)
    run.main(load_config(str(config), phase="train"))
    check_tiny_run(tmp_path, task)
    run.main(load_config(str(config), phase="test"))
    rows = check_tiny_test_run(tmp_path, task)
    if task == "low_light_synthetic":  # enhance_contrast + enhance_color moved the scores
        assert rows["post"]["metric_psnr"] != rows["pre"]["metric_psnr"]
        assert sorted(p.name for p in (tmp_path / "outputs").glob("pp_*.png")) == [
            "pp_1.png", "pp_2.png", "pp_3.png"]


def test_missing_device_means_the_card(tmp_path):
    """No ``train.device`` / ``test.device`` (or null): CUDA, which raises on
    a machine without a card instead of training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    cfg = json.loads(write_tiny_config(tmp_path).read_text())
    for phase in ("train", "test"):
        for value in (None, "absent"):
            c = json.loads(json.dumps(cfg))
            if value is None:
                c[phase]["device"] = None
            else:
                del c[phase]["device"]
            path = tmp_path / f"{phase}_{value}.json"
            path.write_text(json.dumps(c))
            with pytest.raises(RuntimeError, match="no CUDA device"):
                run.build_session(load_config(str(path), phase=phase))
            with pytest.raises(RuntimeError, match="no CUDA device"):
                Model(network=CDAN(), config=load_config(str(path), phase=phase), dataloader=None)


def test_pipelines_follow_the_engine_device(tmp_path):
    """The LPIPS metric and the perceptual loss terms are built on the
    engine's device (``meta`` here shows it is not a CPU default)."""
    from multi_degradation_image_enhancement_tpu_torch.ops.losses import build_loss_pipeline
    from multi_degradation_image_enhancement_tpu_torch.ops.metrics import build_metrics_pipeline

    cfg = load_config(str(write_tiny_config(tmp_path, "jpeg_synthetic")), phase="test")
    engine = Model(network=CDAN(), config=cfg, dataloader=None)
    metric_nets = [d for m in engine.metrics_pipe.metrics for d in (m.fn.__defaults__ or ())
                   if isinstance(d, torch.nn.Module)]
    assert len(metric_nets) == 1
    for dev in ("cpu", "meta"):
        metrics = build_metrics_pipeline(cfg["metrics"], dev)
        losses = build_loss_pipeline(cfg["loss"], dev)
        nets = [d for m in metrics.metrics for d in (m.fn.__defaults__ or ())
                if isinstance(d, torch.nn.Module)]
        nets += [c.cell_contents for t in losses.terms for c in (t.fn.__closure__ or ())
                 if isinstance(c.cell_contents, torch.nn.Module)]
        assert len(nets) == 3  # LPIPS metric, VGG19 and LPIPS loss terms
        assert all(p.device.type == dev for n in nets for p in n.parameters())
    assert all(p.device == engine.device for n in metric_nets for p in n.parameters())


def test_directory_backed_configs_still_raise(tmp_path):
    """A directory config (``data.dataset.PairedDataset``) resolves to the
    port's dataset: with its shipped roots absent it raises for the missing
    directory, as the JAX package does; with the roots present (rewritten
    into ``tmp_path``) the session builds on them."""
    from PIL import Image

    from multi_degradation_image_enhancement_tpu_torch.data.dataset import PairedDataset

    cfg = json.loads(json.dumps(load_config(str(CONFIG_DIR / "blur.json"))))
    cfg["train"]["device"] = "cpu"
    cfg["logging"]["root_dir"] = str(tmp_path / "runs")
    path = tmp_path / "blur.json"
    path.write_text(json.dumps(cfg))
    with pytest.raises(FileNotFoundError, match="blur/train/degraded"):
        run.build_session(load_config(str(path), phase="train"))
    args = cfg["train"]["dataset"]["args"]
    for key, sub in (("input_root", "degraded"), ("target_root", "clean")):
        args[key] = str(tmp_path / "blur" / sub)
        (tmp_path / "blur" / sub).mkdir(parents=True)
        for i in range(3):
            Image.new("RGB", (48, 32), (40 * i, 0, 0)).save(tmp_path / "blur" / sub / f"{i}.png")
    path.write_text(json.dumps(cfg))
    logger, engine = run.build_session(load_config(str(path), phase="train"))
    logger.close()
    assert isinstance(engine.dataloader.dataset, PairedDataset)
    assert len(engine.dataloader.dataset) == 3
