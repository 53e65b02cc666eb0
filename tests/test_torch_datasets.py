"""PyTorch port: the directory-backed datasets, their loader and the offline
generators (``data/dataset.py``, ``data/loader.py``, ``datasets_generation``)
against the JAX package, and ``run -p train`` / ``-p test`` on a directory
config on the CPU."""

import filecmp
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from multi_degradation_image_enhancement_tpu.data.dataset import (
    PairedDataset as JaxPairedDataset,
    UnpairedDataset as JaxUnpairedDataset,
    _match_pairs as jax_match_pairs,
)
from multi_degradation_image_enhancement_tpu.data.loader import DeviceDataLoader as JaxLoader
from multi_degradation_image_enhancement_tpu.datasets_generation import common as jax_common
from multi_degradation_image_enhancement_tpu.datasets_generation import (
    generate_classifier as jax_generate_classifier,
    generate_paired as jax_generate_paired,
    select_clean_images as jax_select,
)
from multi_degradation_image_enhancement_tpu_torch import run
from multi_degradation_image_enhancement_tpu_torch.data.dataset import (
    PairedDataset,
    UnpairedDataset,
    _match_pairs,
)
from multi_degradation_image_enhancement_tpu_torch.data.loader import DeviceDataLoader
from multi_degradation_image_enhancement_tpu_torch.datasets_generation import common
from multi_degradation_image_enhancement_tpu_torch.datasets_generation import (
    generate_classifier,
    generate_paired,
    select_clean_images,
)
from multi_degradation_image_enhancement_tpu_torch.utils.config import load_config
from multi_degradation_image_enhancement_tpu_torch.utils.registry import resolve
from tests.torch_train_cli import check_tiny_run, write_clean_pngs, write_tiny_dir_config

IDENTITY = {"backend": "albumentations", "ops": [{"name": "ToTensorV2", "args": {}}]}


def _pair_tree(root: Path):
    """degraded/ and clean/ with names that match by filename, by stem only
    (other extensions) and not at all."""
    rng = np.random.RandomState(0)
    for sub, names in (("degraded", ["a.png", "b.png", "c.jpg", "d.png", "e.png", "x.png"]),
                       ("clean", ["a.png", "b.png", "c.png", "d.png", "e.png", "y.png", ".h.png"])):
        (root / sub).mkdir(parents=True)
        for n in names:
            Image.fromarray(rng.randint(0, 256, (12, 20, 3), dtype=np.uint8)).save(root / sub / n)
    return str(root / "degraded"), str(root / "clean")


@pytest.mark.parametrize("mode", ["filename", "stem", "sorted"])
def test_match_pairs_matches_jax(tmp_path, mode):
    inp, tgt = _pair_tree(tmp_path)
    got = _match_pairs(inp, tgt, mode)
    assert got == jax_match_pairs(inp, tgt, mode) and got


@pytest.mark.parametrize("mode,error", [("fuzzy", ValueError), ("filename", RuntimeError)])
def test_match_pairs_errors_match_jax(tmp_path, mode, error):
    inp, _ = _pair_tree(tmp_path)
    empty = tmp_path / "empty"
    empty.mkdir()
    for fn in (_match_pairs, jax_match_pairs):
        with pytest.raises(error):
            fn(inp, str(empty), mode)


@pytest.mark.parametrize("shuffle", [False, True])
def test_paired_loader_matches_jax(tmp_path, shuffle):
    """7 pairs at batch 3 with an identity transform: the same batches in the
    same order, the last padded by repeating its final sample, the same mask,
    for two epochs."""
    inp, tgt = _pair_tree(tmp_path)
    kw = dict(input_root=inp, target_root=tgt, pairing_mode="stem", transform=IDENTITY)
    ds, jds = PairedDataset(**kw), JaxPairedDataset(**kw)
    assert ds.pairs == jds.pairs and len(ds) == 5
    loader = DeviceDataLoader(ds, batch_size=3, shuffle=shuffle, seed=5, num_workers=2)
    jloader = JaxLoader(jds, batch_size=3, shuffle=shuffle, seed=5)
    assert len(loader) == len(jloader) == 2
    for _ in range(2):
        for (x, y, m), (jx, jy, jm) in zip(loader, jloader, strict=True):
            np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
            np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
            np.testing.assert_array_equal(m.numpy(), np.asarray(jm))


def test_unpaired_loader_matches_jax(tmp_path):
    inp, _ = _pair_tree(tmp_path)
    ds, jds = UnpairedDataset(inp, IDENTITY), JaxUnpairedDataset(inp, IDENTITY)
    batches = list(DeviceDataLoader(ds, batch_size=4))
    jbatches = list(JaxLoader(jds, batch_size=4))
    assert len(batches) == len(jbatches) == 2
    for (x, y, m), (jx, jm) in zip(batches, jbatches):
        assert y is None
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))


@pytest.mark.parametrize("src_hw,target_hw", [
    ((301, 517), (256, 384)),  # downscale, fractional area
    ((512, 768), (256, 384)),  # downscale by 2: OpenCV's box path
    ((37, 61), (256, 384)),  # upscale, odd sizes
    ((401, 203), (256, 384)),  # tall: pillarboxed
    ((97, 131), (32, 48)),  # downscale by a non-integer to a small canvas
])
def test_letterbox_matches_jax(src_hw, target_hw):
    """The cv2-free INTER_AREA letterbox against the JAX package's (cv2): ≤ 1 LSB."""
    img = np.random.RandomState(sum(src_hw)).randint(0, 256, (*src_hw, 3)).astype(np.uint8)
    want = jax_common.letterbox_rgb(img, target_hw)
    got = common.letterbox_rgb(img, target_hw)
    assert got.shape == want.shape == (*target_hw, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_load_letterboxed_matches_jax(tmp_path):
    names = write_clean_pngs(tmp_path, [(45, 77), (30, 20)])
    for n in names:
        want = jax_common.load_letterboxed_rgb(str(tmp_path / n), (32, 48))
        got = common.load_letterboxed_rgb(str(tmp_path / n), (32, 48))
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_load_or_create_split_matches_jax(tmp_path):
    names = [f"f{i:03d}.png" for i in range(23)]
    ratios = {"train": 0.7, "val": 0.15, "test": 0.15}
    got = common.load_or_create_split(names, str(tmp_path / "a" / "s.json"), ratios, 42)
    want = jax_common.load_or_create_split(names, str(tmp_path / "b" / "s.json"), ratios, 42)
    assert got == want
    assert (tmp_path / "a" / "s.json").read_bytes() == (tmp_path / "b" / "s.json").read_bytes()
    # an existing file is re-used as it is
    assert common.load_or_create_split(names[:3], str(tmp_path / "a" / "s.json"), ratios, 7) == got
    for rng_fn in ("stable_rng", "stable_np_rng"):
        a, b = getattr(common, rng_fn)("x.png", 2, 42), getattr(jax_common, rng_fn)("x.png", 2, 42)
        assert a.random() == b.random()


def _tree_files(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def test_generate_paired_pixelation_is_bit_identical(tmp_path):
    """The pixelation presets are deterministic: the same split file and the
    same PNGs, byte for byte (the clean images already at the target size, so
    the letterbox copies them; its resize is held above)."""
    clean = tmp_path / "clean"
    write_clean_pngs(clean, [(32, 48)] * 7)
    argv = ["--clean-dir", str(clean), "--generate", "pixelation_easy", "pixelation_hard",
            "--target-hw", "32", "48", "--batch-size", "4"]
    jax_generate_paired.main(argv + ["--out", str(tmp_path / "jax")])
    generate_paired.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    files = _tree_files(tmp_path / "jax")
    assert files == _tree_files(tmp_path / "port") and len(files) == 1 + 2 * 2 * 7
    match, mismatch, errors = filecmp.cmpfiles(tmp_path / "jax", tmp_path / "port", files,
                                               shallow=False)
    assert mismatch == [] and errors == [] and len(match) == len(files)


def test_generate_paired_noise_layout(tmp_path):
    """A random family: the same layout; degraded ≠ clean, on the u8 lattice."""
    clean = tmp_path / "clean"
    write_clean_pngs(clean, [(40, 50), (32, 48), (20, 30)])
    argv = ["--clean-dir", str(clean), "--generate", "noise", "--target-hw", "32", "48"]
    jax_generate_paired.main(argv + ["--out", str(tmp_path / "jax")])
    generate_paired.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    assert _tree_files(tmp_path / "jax") == _tree_files(tmp_path / "port")
    for p in (tmp_path / "port" / "noise").rglob("degraded/*.png"):
        deg = np.asarray(Image.open(p))
        cln = np.asarray(Image.open(str(p).replace("degraded", "clean")))
        assert deg.shape == (32, 48, 3) and not np.array_equal(deg, cln)


DRAWN = {"motion_blur": "angle_deg", "color_distortion": "gains"}


def test_generate_classifier_rows_match_jax(tmp_path):
    """Every labels.jsonl field equal to JAX's but the randomly drawn params
    (motion blur's angle, colour distortion's gains); the meta files equal;
    the images equal where the chain draws nothing and has no jpeg."""
    clean = tmp_path / "clean"
    write_clean_pngs(clean, [(32, 48)] * 5)
    argv = ["--clean-dir", str(clean), "--target-hw", "32", "48", "--variants-per-image", "3"]
    jax_generate_classifier.main(argv + ["--out", str(tmp_path / "jax")])
    generate_classifier.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    assert _tree_files(tmp_path / "jax") == _tree_files(tmp_path / "port")
    for meta in ("classes.json", "config.json"):
        assert (tmp_path / "jax" / "meta" / meta).read_text() == (
            tmp_path / "port" / "meta" / meta).read_text()
    exact_images = 0
    for split in ("train", "val", "test"):
        rows = [[json.loads(line) for line in (tmp_path / t / split / "labels.jsonl").read_text()
                 .splitlines()] for t in ("jax", "port")]
        assert len(rows[0]) == len(rows[1])
        for want, got in zip(*rows):
            for d, key in DRAWN.items():
                if d in want["params"]:
                    assert len(np.atleast_1d(got["params"][d].pop(key))) == len(
                        np.atleast_1d(want["params"][d].pop(key)))
            assert got == want
            chain = set(want["chosen_degradations"])
            if not chain & {"noise", "jpeg", *DRAWN}:
                a, b = (np.asarray(Image.open(tmp_path / t / want["file"])) for t in ("jax", "port"))
                np.testing.assert_array_equal(a, b)
                exact_images += 1
    assert exact_images > 0


def _fake_imagenet(root: Path, n_classes=6, per_class=4):
    for c in range(n_classes):
        cls = root / f"n{c:08d}"
        cls.mkdir(parents=True)
        for i in range(per_class):
            Image.new("RGB", (8, 8), (c * 40 % 256, i * 60 % 256, 0)).save(cls / f"img_{i}.png")


@pytest.mark.parametrize("nested", [False, True])
def test_select_clean_images_matches_jax(tmp_path, nested):
    _fake_imagenet(tmp_path / "imagenet")
    argv = ["--imagenet-dir", str(tmp_path / "imagenet"), "--num-classes", "4",
            "--images-per-class", "3", "--seed", "42"] + (["--nested"] if nested else [])
    jax_select.main(argv + ["--out", str(tmp_path / "jax")])
    select_clean_images.main(argv + ["--out", str(tmp_path / "port")])
    files = _tree_files(tmp_path / "jax")
    assert files == _tree_files(tmp_path / "port") and len(files) == 12


@pytest.mark.parametrize("module", ["data.dataset", "multi_degradation_image_enhancement_tpu_torch.data.dataset"])
def test_registry_maps_directory_datasets(module):
    assert resolve(module, "PairedDataset") is PairedDataset
    assert resolve(module, "UnpairedDataset") is UnpairedDataset


def test_directory_config_trains_and_scores(tmp_path):
    """``run -p train`` then ``-p test`` on a copy of config/noise.json whose
    roots point at ``generate_paired``'s output: one epoch of 8 pairs, then
    the 2 test pairs scored and written."""
    write_clean_pngs(tmp_path / "clean", [(40, 60)] * 10)
    generate_paired.main(["--clean-dir", str(tmp_path / "clean"), "--out", str(tmp_path / "data"),
                          "--generate", "noise", "--target-hw", "32", "48", "--device", "cpu"])
    assert len(os.listdir(tmp_path / "data" / "noise" / "train" / "degraded")) == 8
    cfg = write_tiny_dir_config(tmp_path, tmp_path / "data")
    engine = run.main(load_config(str(cfg), phase="train"))
    check_tiny_run(tmp_path, "noise")
    assert len(engine.dataloader) == 4
    run.main(load_config(str(cfg), phase="test"))
    assert sorted(p.name for p in (tmp_path / "outputs").glob("*.png")) == ["raw_1.png", "raw_2.png"]
    (csv_path,) = (tmp_path / "runs").glob("noise/*/test.csv")
    header, row = csv_path.read_text().splitlines()
    cols = dict(zip(header.split(","), row.split(",")))
    assert cols["stage"] == "pre" and np.isfinite(float(cols["metric_psnr"]))
    assert torch.load(tmp_path / "weights" / "CDAN_noise.pt", map_location="cpu")
