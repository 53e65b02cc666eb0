"""PyTorch port: the native host-IO engine (``csrc/host_io.cpp`` through
``data/io_native.py``) against the JAX package's (``native/mdie_io.cpp``
through its ``data/io_native.py``), the NumPy plain versions, and the
callers that decode through it.

Both engines compile the same arithmetic with the same flags, so every
comparison is bit for bit.  The libraries are built by the session fixture,
never at collection.
"""

import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
from PIL import Image

from multi_degradation_image_enhancement_tpu.data import io_native as jax_io
from multi_degradation_image_enhancement_tpu.data.dataset import _load_rgb as jax_load_rgb
from multi_degradation_image_enhancement_tpu.data.streaming import decode_chunk as jax_decode_chunk
from multi_degradation_image_enhancement_tpu_torch.data import io_native
from multi_degradation_image_enhancement_tpu_torch.data.dataset import PairedDataset, _load_rgb
from multi_degradation_image_enhancement_tpu_torch.data.loader import DeviceDataLoader
from multi_degradation_image_enhancement_tpu_torch.data.streaming import decode_chunk
from tests.torch_dist_worker import ROOT

SRC_HW = (96, 144)
TARGETS = {"at_size": SRC_HW, "enlarged": (160, 240), "shrunk": (32, 48), "odd": (31, 17)}


@pytest.fixture(scope="session")
def engines():
    """Both engines built and loaded.  The JAX package's builds into
    ``native/`` with ``make`` and caches a failed load for its process; a
    worker that opened the library while another was still writing it
    (its tests' collection builds it in every worker) retries here."""
    assert io_native.available(), io_native.build_error()
    deadline = time.monotonic() + 120.0
    while not jax_io.available():
        assert time.monotonic() < deadline, "the JAX package's native engine did not load"
        time.sleep(1.0)
        jax_io._lib_failed = False
    return io_native, jax_io


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """One random 96×144 RGB image saved as PNG and as JPEG (quality 90)."""
    d = tmp_path_factory.mktemp("host_io")
    img = np.random.RandomState(0).randint(0, 256, (*SRC_HW, 3), np.uint8)
    Image.fromarray(img).save(d / "img.png")
    Image.fromarray(img).save(d / "img.jpg", quality=90)
    return d, img


@pytest.mark.parametrize("mode", [io_native.MODE_RESIZE, io_native.MODE_LETTERBOX])
@pytest.mark.parametrize("target", list(TARGETS))
@pytest.mark.parametrize("fmt", ["png", "jpg"])
def test_decode_matches_the_jax_engine_and_the_plain_version(engines, images, fmt, target, mode):
    d, img = images
    path = str(d / f"img.{fmt}")
    th, tw = TARGETS[target]
    got = io_native.decode_image(path, th, tw, mode)
    want = jax_io.decode_image(path, th, tw, mode)
    assert got.shape == (th, tw, 3) and got.dtype == np.uint8
    assert np.array_equal(got, want)
    decoded = io_native.decode_image(path, *SRC_HW, io_native.MODE_EXACT)
    if fmt == "png":
        assert np.array_equal(decoded, img)
    plain = (io_native.resize_bilinear_np(decoded, th, tw) if mode == io_native.MODE_RESIZE
             else io_native.letterbox_np(decoded, th, tw))
    assert np.array_equal(got, plain)


def test_plain_versions_match_the_engine_on_many_shapes(engines, tmp_path):
    """Resize and letterbox at 24 random size pairs, 1 to 3× up or down,
    ragged and tiny ones included."""
    rng = np.random.RandomState(1)
    for i in range(24):
        h, w = rng.randint(1, 70, 2)
        th, tw = rng.randint(1, 90, 2)
        img = rng.randint(0, 256, (h, w, 3), np.uint8)
        path = str(tmp_path / f"{i}.png")
        Image.fromarray(img).save(path)
        for mode, plain in ((io_native.MODE_RESIZE, io_native.resize_bilinear_np),
                            (io_native.MODE_LETTERBOX, io_native.letterbox_np)):
            got = io_native.decode_image(path, th, tw, mode)
            assert np.array_equal(got, plain(img, th, tw)), (h, w, th, tw, mode)


def test_exact_mode_refuses_another_size(engines, images):
    d, img = images
    for lib in (io_native, jax_io):
        assert lib.decode_image(str(d / "img.png"), 32, 48, io_native.MODE_EXACT) is None
        assert np.array_equal(lib.decode_image(str(d / "img.png"), *SRC_HW, io_native.MODE_EXACT),
                              img)


def test_batch_zero_fills_and_counts_a_missing_file(engines, images):
    d, _ = images
    paths = [str(d / "img.png"), str(d / "missing.png"), str(d / "img.jpg")]
    before = (io_native.decode_calls, io_native.decode_failures)
    got = io_native.decode_batch(paths, 32, 48, n_threads=2)
    assert (io_native.decode_calls, io_native.decode_failures) == (before[0] + 1, before[1] + 1)
    assert np.array_equal(got, jax_io.decode_batch(paths, 32, 48, n_threads=2))
    assert not got[1].any() and got[0].any() and got[2].any()
    # the JAX engine's C call counts the same failure
    arr = np.empty_like(got)
    import ctypes

    c_paths = (ctypes.c_char_p * 3)(*[p.encode() for p in paths])
    failed = jax_io._load().mdie_decode_batch(
        c_paths, 3, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), 32, 48, 1, 2)
    assert failed == 1 and np.array_equal(arr, got)


@pytest.mark.parametrize("level", [1, 6])
def test_encode_round_trips_and_writes_the_jax_engines_file(engines, tmp_path, level):
    img = np.random.RandomState(level).randint(0, 256, (37, 53, 3), np.uint8)
    before = io_native.encode_calls
    assert io_native.encode_png(str(tmp_path / "a.png"), img, level)
    assert jax_io.encode_png(str(tmp_path / "b.png"), img, level)
    assert np.array_equal(np.asarray(Image.open(tmp_path / "a.png")), img)
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
    batch = np.stack([img, img[::-1].copy()])
    paths = [str(tmp_path / f"batch{i}.png") for i in range(2)]
    assert io_native.encode_png_batch(paths, batch, level, n_threads=2) == 0
    for p, want in zip(paths, batch):
        assert np.array_equal(np.asarray(Image.open(p)), want)
    assert io_native.encode_calls == before + 2
    assert io_native.encode_png_batch(paths[:1], batch) is None  # N does not match


def test_load_rgb_matches_the_jax_package_on_a_shrunk_image(engines, images):
    """The repaired fault: a shrunk image decoded with the JAX package's
    pixels (its engine), where PIL's antialiasing bilinear differs."""
    d, _ = images
    for fmt in ("png", "jpg"):
        path = str(d / f"img.{fmt}")
        got = _load_rgb(path, (32, 48))
        assert np.array_equal(got, jax_load_rgb(path, (32, 48)))
        pil = np.asarray(Image.open(path).convert("RGB").resize((48, 32), Image.BILINEAR))
        assert np.abs(got.astype(int) - pil).max() > 50  # what the PIL path gave before
    assert np.array_equal(decode_chunk([str(d / "img.png"), str(d / "img.jpg")], (32, 48), 2),
                          jax_decode_chunk([str(d / "img.png"), str(d / "img.jpg")], (32, 48), 2))


def test_paired_loader_decodes_a_batch_in_one_engine_call(engines, tmp_path):
    """``PairedDataset`` through the loader's host batch: both halves of the
    batch in one engine call, each image the JAX package's ``_load_rgb``."""
    rng = np.random.RandomState(2)
    for sub in ("inp", "tgt"):
        (tmp_path / sub).mkdir()
        for i in range(3):
            img = rng.randint(0, 256, (40 + 7 * i, 70 - 5 * i, 3), np.uint8)
            Image.fromarray(img).save(tmp_path / sub / f"{i}.png")
    ds = PairedDataset(str(tmp_path / "inp"), str(tmp_path / "tgt"), transform={
        "backend": "albumentations", "ops": [{"name": "Resize", "args": {"height": 24,
                                                                            "width": 32}}]})
    loader = DeviceDataLoader(ds, batch_size=3, device="cpu", num_workers=2)
    before = io_native.decode_calls
    inp, tgt = loader._host_batch(np.arange(3))
    assert io_native.decode_calls == before + 1
    for i, (a, b) in enumerate(ds.pairs):
        assert np.array_equal(inp[i], jax_load_rgb(a, (24, 32)))
        assert np.array_equal(tgt[i], jax_load_rgb(b, (24, 32)))
        assert np.array_equal(ds.load_pair(i)[0], inp[i])


def test_native_io_off_takes_pil(engines, images, monkeypatch):
    d, _ = images
    monkeypatch.setenv("MDIE_NATIVE_IO", "0")
    assert not io_native.available()
    assert io_native.decode_batch([str(d / "img.png")], 32, 48) is None
    assert not io_native.encode_png(str(d / "never.png"), np.zeros((2, 2, 3), np.uint8))
    path = str(d / "img.png")
    pil = np.asarray(Image.open(path).convert("RGB").resize((48, 32), Image.BILINEAR))
    assert np.array_equal(_load_rgb(path, (32, 48)), pil)
    assert np.array_equal(decode_chunk([path], (32, 48))[0], pil)


def test_two_processes_building_at_once_both_load_a_whole_library(tmp_path):
    """Two fresh processes build into one empty directory at the same
    moment: the lock and the atomic rename leave each a whole library."""
    script = textwrap.dedent(f"""
        import sys, time
        import numpy as np
        from pathlib import Path
        from multi_degradation_image_enhancement_tpu_torch.data import io_native
        io_native.BUILD_ROOT = Path({str(tmp_path / "build")!r})
        start = float(sys.argv[1])
        while time.time() < start:
            pass
        assert io_native.available(), io_native.build_error()
        img = np.arange(6 * 4 * 3, dtype=np.uint8).reshape(6, 4, 3)
        path = {str(tmp_path)!r} + f"/p{{sys.argv[2]}}.png"
        assert io_native.encode_png(path, img)
        assert np.array_equal(io_native.decode_image(path, 6, 4, 0), img)
        print("LOADED", io_native.library_path())
    """)
    start = time.time() + 3.0
    procs = [subprocess.Popen([sys.executable, "-c", script, str(start), str(i)], cwd=str(ROOT),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "LOADED" in out, out
    libs = list((tmp_path / "build").glob("*/*.so"))
    assert len(libs) == 1 and not list((tmp_path / "build").glob("*/.*.tmp"))


def test_chip_smoke_host_io_checks_pass_on_the_cpu(engines, tmp_path):
    """``chip_smoke.py`` phase 34's engine checks (host work only) at a small
    size: what the card's machine runs where its compiler finds the headers."""
    import chip_smoke

    res = chip_smoke.host_io_checks(tmp_path, images=9, hw=(32, 48), threads=2)
    assert res["jpeg_max_lsb"] <= 1
    assert set(res["img_s"]) == {"engine_decode", "pil_decode", "engine_encode", "pil_encode"}
    assert all(v > 0 for v in res["img_s"].values())
