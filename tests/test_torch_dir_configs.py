"""PyTorch port: every directory-backed restorer config other than noise.json
(which ``tests/test_torch_datasets.py`` drives) trains one epoch and scores
on ``generate_paired``'s pairs on the CPU, its roots rewritten into a tmp
tree: each config's losses, transforms and post-processing over
``data.dataset.PairedDataset``."""

import pytest
import torch

from multi_degradation_image_enhancement_tpu_torch import run
from multi_degradation_image_enhancement_tpu_torch.data.dataset import PairedDataset
from multi_degradation_image_enhancement_tpu_torch.datasets_generation import generate_paired
from multi_degradation_image_enhancement_tpu_torch.utils.config import load_config
from tests.torch_train_cli import (
    CONFIG_DIR,
    TEST_IMAGES,
    check_tiny_run,
    check_tiny_test_run,
    write_clean_pngs,
    write_tiny_dir_config,
)

TASKS = sorted(p.stem for p in CONFIG_DIR.glob("*.json")
               if "_synthetic" not in p.stem
               and p.stem not in ("noise", "classifier_thresholds", "serving_tuning"))
TRAIN_IMAGES = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while these tiny runs train: at 32×48 a parallel
    region costs more to fork and join than it computes, and many threads
    stall when the other test workers hold the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """``generate_paired`` for every task at once: 4 training and 3 test
    pairs each, 32×48, from 7 procedural PNGs of two sizes."""
    root = tmp_path_factory.mktemp("dir_configs")
    n = TRAIN_IMAGES + TEST_IMAGES
    write_clean_pngs(root / "clean", [(40, 60), (50, 44)] * 3 + [(40, 60)])
    generate_paired.main(["--clean-dir", str(root / "clean"), "--out", str(root / "data"),
                          "--generate", *TASKS, "--target-hw", "32", "48",
                          "--test-ratio", str(TEST_IMAGES / n), "--device", "cpu"])
    return root / "data"


def test_every_directory_config_is_covered():
    assert len(TASKS) == 10 and "low_light" in TASKS and "pixelation_hard" in TASKS


@pytest.mark.parametrize("task", TASKS)
def test_directory_config_trains_and_scores(tmp_path, data_root, task):
    cfg = write_tiny_dir_config(tmp_path, data_root, task)
    engine = run.main(load_config(str(cfg), phase="train"))
    assert isinstance(engine.dataloader.dataset, PairedDataset)
    assert len(engine.dataloader.dataset) == TRAIN_IMAGES
    check_tiny_run(tmp_path, task)
    run.main(load_config(str(cfg), phase="test"))
    check_tiny_test_run(tmp_path, task)
