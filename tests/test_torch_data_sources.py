"""PyTorch port: synthetic pairs from a directory of clean images
(``SyntheticPairedDataset(clean_root=…)`` and the loader's host-decode mode)
and the torchvision transform backend, against the JAX package.

Drawn parameters cannot match threefry, so each torchvision op gets the
parameters the JAX op draws from its key (as ``tests/test_torch_transforms.py``
does for the albumentations ops), and the loaders are compared on what does
not depend on a draw: the clean targets, their order and the masks.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from multi_degradation_image_enhancement_tpu.data import transforms as jtf
from multi_degradation_image_enhancement_tpu.data.loader import DeviceDataLoader as JaxLoader
from multi_degradation_image_enhancement_tpu.data.synthetic import (
    SyntheticPairedDataset as JaxSynthetic,
)
from multi_degradation_image_enhancement_tpu_torch import run
from multi_degradation_image_enhancement_tpu_torch.data import transforms as tf
from multi_degradation_image_enhancement_tpu_torch.data.loader import DeviceDataLoader
from multi_degradation_image_enhancement_tpu_torch.data.synthetic import SyntheticPairedDataset
from multi_degradation_image_enhancement_tpu_torch.utils.config import load_config
from tests.torch_train_cli import check_tiny_run, write_clean_pngs, write_tiny_config

torch.set_num_threads(1)  # tiny CPU runs stall under many threads per xdist worker

B, H, W = 4, 32, 48
# values / 255, no Resize: both packages decode with PIL at the files' own size
UNIT = {"backend": "albumentations",
        "ops": [{"name": "Normalize", "args": {"mean": [0, 0, 0], "std": [1, 1, 1]}}]}


@pytest.mark.parametrize("shuffle", [False, True], ids=["ordered", "shuffled"])
def test_clean_root_loader_matches_jax(tmp_path, shuffle):
    """7 clean PNGs at batch 3, two epochs: the same clean u8 images in the
    same order (the targets / 255 within an f32 ulp), the last batch padded
    by repeating its final image and masked, as the JAX loader's host-decode
    mode yields them; the inputs are the targets degraded on the device (finite, changed)."""
    write_clean_pngs(tmp_path / "clean", [(H, W)] * 7)
    (tmp_path / "clean" / "notes.txt").write_text("ignored")
    args = {"degradation": "noise", "clean_root": str(tmp_path / "clean"), "n_images": 999,
            "transform": UNIT}
    port = DeviceDataLoader(SyntheticPairedDataset(**args), 3, shuffle=shuffle, seed=5)
    ref = JaxLoader(JaxSynthetic(**args), 3, shuffle=shuffle, seed=5)
    assert len(port.dataset) == len(ref.dataset) == 7 and port.dataset.clean is None
    for _ in range(2):
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 3
        for (inp, tgt, mask), (_, jtgt, jmask) in zip(got, want):
            jtgt = np.asarray(jtgt)  # XLA divides by 255 as a product: an ulp apart
            assert np.array_equal(np.rint(tgt.numpy() * 255), np.rint(jtgt * 255))
            assert np.abs(tgt.numpy() - jtgt).max() <= 1e-7
            assert np.array_equal(mask.numpy(), np.asarray(jmask))
            assert inp.shape == tgt.shape == (3, H, W, 3)
            assert bool(torch.isfinite(inp).all()) and not torch.equal(inp, tgt)
    assert got[-1][2].tolist() == [1.0, 0.0, 0.0]


def test_clean_root_trains_through_the_cli(tmp_path):
    """``noise_synthetic`` with its train set from a ``clean_root`` of 5 PNGs
    of odd sizes (decoded at the Resize's 32×48) trains an epoch on the CPU:
    3 steps at batch 2, ``n_images`` ignored."""
    sizes = [(32, 48), (40, 60), (30, 44), (32, 48), (64, 96)]
    write_clean_pngs(tmp_path / "clean", sizes)
    cfg = json.loads(write_tiny_config(tmp_path).read_text())
    cfg["train"]["dataset"]["args"]["clean_root"] = str(tmp_path / "clean")
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(cfg))
    engine = run.main(load_config(str(path), phase="train"))
    assert len(engine.dataloader.dataset) == 5 and engine.state.step == 3
    check_tiny_run(tmp_path)


# ------------------------------------------------------------------ torchvision ops


def _images(seed=0):
    return (np.random.RandomState(seed).rand(B, H, W, 3) * 255.0).astype(np.float32)


def _jax_params(name, args, key):
    """The port's parameters for torchvision op ``name`` as the JAX op draws
    them from ``key`` (``_tv_op`` and the ops it builds)."""
    if name in ("RandomHorizontalFlip", "RandomVerticalFlip"):
        return torch.from_numpy(np.array(jax.random.uniform(key, (B,)) < args.get("p", 0.5)))
    if name == "RandomRotation":
        d = args["degrees"]
        return torch.from_numpy(np.array(jax.random.uniform(key, (B,), minval=-d, maxval=d)))
    if name == "ColorJitter":
        keys = dict(zip(("brightness", "contrast", "saturation", "hue"), jax.random.split(key, 4)))
        params = {}
        for k in ("brightness", "contrast", "saturation"):
            if args.get(k):
                lo, hi = max(0.0, 1.0 - args[k]), 1.0 + args[k]
                params[k] = jax.random.uniform(keys[k], (B,), minval=lo, maxval=hi)
        if args.get("hue"):
            params["hue"] = jax.random.uniform(keys["hue"], (B,), minval=-args["hue"],
                                               maxval=args["hue"])
        return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    return None


TV_OPS = [
    ("Resize", {"size": [24, 36]}, 1e-4),
    ("Resize", {"height": 40, "width": 56}, 1e-4),
    ("ToTensor", {}, 0.0),
    ("Normalize", {"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]}, 0.0),
    ("RandomHorizontalFlip", {"p": 0.6}, 0.0),
    ("RandomVerticalFlip", {"p": 0.6}, 0.0),
    ("ColorJitter", {"brightness": 0.3, "contrast": 0.3, "saturation": 0.3, "hue": 0.1}, 1e-3),
    ("ColorJitter", {"brightness": 0.5}, 1e-4),
]


@pytest.mark.parametrize("name,args,tol", TV_OPS,
                         ids=[f"{n}-{'-'.join(a)}" for n, a, _ in TV_OPS])
def test_torchvision_op_matches_jax(name, args, tol):
    """Each op of the torchvision backend on the same images with the JAX
    op's own draws, to ``tol`` on the output's scale (0..255, or 0..1 and
    normalised after ToTensor / Normalize): ToTensor, Normalize and the flips
    exactly, the whole ColorJitter within 1e-3 (a mean and the YIQ rotation
    in another f32 order; measured 6.1e-05), brightness alone 1e-4 (measured
    exact), the bilinear resize 1e-4 as ``tests/test_torch_train.py`` holds
    it (measured 1.5e-05)."""
    x = _images(1)
    if name == "Normalize":
        x = x / 255.0
    key = jax.random.key(3)
    want = np.asarray(jtf._tv_op(name, args)(jnp.asarray(x), key))
    sample, apply = tf._tv_op(name, args)
    params = _jax_params(name, args, key)
    got = apply(torch.from_numpy(x), params).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol, np.abs(got - want).max()
    if name in ("RandomHorizontalFlip", "RandomVerticalFlip"):
        assert 0 < int(params.sum()) < B  # some flipped, some not
    drawn = sample(torch.Size(x.shape), torch.Generator().manual_seed(0), torch.device("cpu"))
    out = apply(torch.from_numpy(x), drawn)  # the port's own draws run too
    assert out.shape == got.shape and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("degrees", [5.0, 30.0])
def test_torchvision_rotation_matches_jax(degrees):
    """RandomRotation with JAX's angles, within twice the JAX op's own
    eager-to-jit spread (tests/test_torch_classifier_data.py's rule: an ulp
    of a source coordinate moves an output by its local gradient)."""
    x = _images(2)
    key = jax.random.key(4)
    op = jtf._tv_op("RandomRotation", {"degrees": degrees})
    eager = np.asarray(op(jnp.asarray(x), key))
    spread = np.abs(eager - np.asarray(jax.jit(op)(jnp.asarray(x), key))).max()
    _, apply = tf._tv_op("RandomRotation", {"degrees": degrees})
    got = apply(torch.from_numpy(x), _jax_params("RandomRotation", {"degrees": degrees}, key))
    assert np.abs(got.numpy() - eager).max() <= max(1e-4, 2 * spread)


def test_torchvision_chain_and_its_size():
    """A torchvision block builds its chain (Resize by ``size`` sets the
    loader's size) and runs it paired, the same draws on input and target."""
    cfg = {"backend": "torchvision", "ops": [
        {"name": "Resize", "args": {"size": [24, 36]}}, {"name": "RandomHorizontalFlip"},
        {"name": "ColorJitter", "args": {"brightness": 0.2, "hue": 0.05}}, {"name": "ToTensor"},
        {"name": "Normalize", "args": {"mean": [0.5] * 3, "std": [0.5] * 3}}]}
    backend, chain = tf.build_transforms(cfg)
    assert backend == "torchvision" and chain.target_hw == (24, 36)
    x = torch.from_numpy(_images(3))
    inp, tgt = chain.apply_paired(x, x.clone(), torch.Generator().manual_seed(1))
    assert torch.equal(inp, tgt) and inp.shape == (B, 24, 36, 3)
    assert float(inp.min()) >= -1.0 and float(inp.max()) <= 1.0
    with pytest.raises(ValueError, match="torchvision"):
        tf.build_transforms({"backend": "torchvision", "ops": [{"name": "RandomErasing"}]})


def test_missing_transform_block_is_to_tensor():
    """No transform block: the torchvision ``ToTensor`` chain (values / 255,
    no size), as the JAX package builds it."""
    x = _images(4)
    for cfg in (None, {}):
        backend, chain = tf.build_transforms(cfg)
        jbackend, jchain = jtf.build_transforms(cfg, is_paired=True)
        assert backend == jbackend == "torchvision"
        assert chain.target_hw is None and jchain.target_hw is None
        got = chain(torch.from_numpy(x), torch.Generator())
        assert np.array_equal(got.numpy(), np.asarray(jchain(jnp.asarray(x), jax.random.key(0))))


def _clean_root_dataset(tmp_path):
    write_clean_pngs(tmp_path, [(32, 48), (20, 30)])
    ds = SyntheticPairedDataset(clean_root=str(tmp_path), transform={
        "backend": "albumentations", "ops": [{"name": "Resize", "args": {"height": 32, "width": 48}}]})
    assert ds.files == [str(tmp_path / "img0.png"), str(tmp_path / "img1.png")]
    first = ds.load_single(0)
    assert first.dtype == np.uint8 and np.array_equal(first, np.asarray(Image.open(ds.files[0])))
    return ds, np.asarray(Image.open(ds.files[1]).convert("RGB"))


def test_clean_root_images_decode_at_the_transform_size(tmp_path, monkeypatch):
    """``load_single`` decodes a file at the Resize's size (PIL bilinear, the
    JAX package's path without its native decoder: ``MDIE_NATIVE_IO=0``) and
    one already at that size as it is."""
    monkeypatch.setenv("MDIE_NATIVE_IO", "0")
    ds, small = _clean_root_dataset(tmp_path)
    want = np.asarray(Image.fromarray(small).resize((48, 32), Image.BILINEAR))
    assert np.array_equal(ds.load_single(1), want)


def test_clean_root_images_decode_through_the_native_engine(tmp_path):
    """The same through the native engine (the JAX package's default): the
    resized file is the engine's bilinear (its plain version, which
    tests/test_torch_host_io.py holds to the JAX package's engine)."""
    from multi_degradation_image_enhancement_tpu_torch.data import io_native

    assert io_native.available(), io_native.build_error()
    ds, small = _clean_root_dataset(tmp_path)
    got = ds.load_single(1)
    assert np.array_equal(got, io_native.resize_bilinear_np(small, 32, 48))
