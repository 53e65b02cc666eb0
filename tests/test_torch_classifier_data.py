"""PyTorch port: the classifier's data layer against the JAX package: the
generator's plans, the synthetic loader's batches, the rotation of the train
augmentation, the directory loader and the metrics."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from multi_degradation_image_enhancement_tpu.classification import metrics as JM
from multi_degradation_image_enhancement_tpu.classification.data import (
    ClassifierLoader as JaxClassifierLoader,
    MultiLabelSeverityDataset as JaxDataset,
)
from multi_degradation_image_enhancement_tpu.classification.synthetic import (
    SyntheticClassifierDataset as JaxSyntheticDataset,
    SyntheticClassifierLoader as JaxSyntheticLoader,
)
from multi_degradation_image_enhancement_tpu.data.transforms import _op_rotation as jax_rotation
from multi_degradation_image_enhancement_tpu.datasets_generation.generate_classifier import (
    plan_variant as jax_plan_variant,
)
from multi_degradation_image_enhancement_tpu_torch.classification import metrics as M
from multi_degradation_image_enhancement_tpu_torch.classification.data import (
    ClassifierLoader,
    MultiLabelSeverityDataset,
)
from multi_degradation_image_enhancement_tpu_torch.classification.synthetic import (
    SyntheticClassifierDataset,
    SyntheticClassifierLoader,
)
from multi_degradation_image_enhancement_tpu_torch.data.transforms import (
    _op_rotation,
    sample_bilinear_zero,
)
from multi_degradation_image_enhancement_tpu_torch.datasets_generation.generate_classifier import (
    plan_variant,
)

HW = (32, 48)


def test_plan_variant_matches_jax():
    """Python ``random`` streams keyed by md5: the same plans, bit for bit."""
    names = [f"img_{i:04d}.png" for i in range(50)] + ["n01440764__x.JPEG", "a b.png"]
    for seed in (42, 7):
        for name in names:
            for v in range(3):
                assert plan_variant(name, v, seed) == jax_plan_variant(name, v, seed), (name, v)


def _jax_host_batch(ds, idxs):
    """What the JAX loader's producer stacks for a batch (synthetic.py:182-191)."""
    ys = [[float(c in ds.samples[i][2]["chosen"]) for c in ds.classes] for i in idxs]
    ss = [[float(ds.samples[i][2]["severities"].get(c, 0.0)) for c in ds.classes] for i in idxs]
    ids = [f"{ds.names[ds.samples[i][0]]}::v{ds.samples[i][1]}" for i in idxs]
    return ds.samples[idxs[0]][3], np.asarray(ys, np.float32), np.asarray(ss, np.float32), ids


def test_synthetic_loader_batches_match_jax():
    """Two shuffled epochs: the same batches of the same samples (indices,
    template ids, labels, severities, ids) in the same order, images on the
    procedural clean set of the JAX package."""
    kw = dict(split="train", n_images=12, variants_per_image=2, input_hw=HW)
    jds, ds = JaxSyntheticDataset(**kw), SyntheticClassifierDataset(**kw)
    assert [s[:2] + (s[3],) for s in ds.samples] == [s[:2] + (s[3],) for s in jds.samples]
    assert [s[2] for s in ds.samples] == [s[2] for s in jds.samples]
    assert ds.labels_rows() == jds.labels_rows()
    np.testing.assert_array_equal(ds.clean_image(3), jds.clean_image(3))

    jloader = JaxSyntheticLoader(jds, batch_size=5, shuffle=True, augment=True)
    loader = SyntheticClassifierLoader(ds, batch_size=5, shuffle=True, augment=True, device="cpu")
    for epoch in range(2):
        jloader._epoch = epoch
        want = jloader._batches()
        got_batches = loader._batches()
        assert [list(map(int, b)) for b in got_batches] == [list(map(int, b)) for b in want]
        got = list(loader)
        assert len(got) == len(want)
        for idxs, (x, y, s, ids) in zip(want, got):
            template, wy, ws, wids = _jax_host_batch(jds, idxs)
            assert {jds.samples[i][3] for i in idxs} == {template}  # one template a batch
            np.testing.assert_array_equal(y.numpy(), wy)
            np.testing.assert_array_equal(s.numpy(), ws)
            assert ids == wids
            assert x.shape == (len(idxs), *HW, 3) and bool(torch.isfinite(x).all())
        assert loader._epoch == epoch + 1


@pytest.mark.parametrize("shape", [(4, 32, 48, 3), (2, 33, 47, 3)])
def test_rotation_sampling_matches_map_coordinates(shape):
    """The bilinear zero-fill sampling against ``map_coordinates(order=1,
    cval=0)`` on the same coordinates, many of them past the edges."""
    rng = np.random.RandomState(1)
    b, h, w, c = shape
    img = rng.uniform(0, 255, shape).astype(np.float32)
    sy = rng.uniform(-2.5, h + 1.5, (b, h, w)).astype(np.float32)
    sx = rng.uniform(-2.5, w + 1.5, (b, h, w)).astype(np.float32)
    sx[:, 0, :4] = [-1.0, -0.5, w - 1.0, w - 0.5]  # exactly on and just past the borders
    want = np.stack([np.stack([np.asarray(jax.scipy.ndimage.map_coordinates(
        jnp.asarray(img[i, ..., k]), [jnp.asarray(sy[i]), jnp.asarray(sx[i])], order=1, cval=0.0))
        for k in range(c)], -1) for i in range(b)])
    got = sample_bilinear_zero(torch.from_numpy(img), torch.from_numpy(sy), torch.from_numpy(sx))
    assert np.abs(got.numpy() - want).max() <= 1e-4


@pytest.mark.parametrize("degrees", [5.0, 30.0])
def test_rotation_matches_jax(degrees):
    """The whole op with JAX's own angles.  Its f32 source coordinates round
    differently between any two implementations (JAX's eager and jitted forms
    differ, the jitted one contracting to FMAs, as do XLA's and PyTorch's
    sin and cos by an ulp), and a coordinate off by an ulp moves a 0..255
    output by up to its local gradient times that ulp (up to 255 a pixel,
    at the zero-filled border too); so the port is held within twice the JAX
    op's own eager-to-jit distance, and the sampling itself at 1e-4 above."""
    rng = np.random.RandomState(2)
    img = rng.uniform(0, 255, (4, *HW, 3)).astype(np.float32)
    key = jax.random.key(5)
    angles = np.asarray(jax.random.uniform(key, (4,), minval=-degrees, maxval=degrees))
    op = jax_rotation(degrees)
    eager = np.asarray(op(jnp.asarray(img), key))
    jitted = np.asarray(jax.jit(op)(jnp.asarray(img), key))
    got = _op_rotation(degrees)[1](torch.from_numpy(img), torch.from_numpy(angles)).numpy()
    spread = np.abs(eager - jitted).max()
    err = np.abs(got - eager).max()
    assert err <= max(1e-4, 2 * spread), (err, spread)
    assert (got[:, 0, 0] == 0).any()  # a corner rotated in from outside reads the zero fill


def _write_tree(root, n=7, hw=(16, 24)):
    img_dir = root / "train" / "images"
    os.makedirs(img_dir)
    rng = np.random.RandomState(0)
    with open(root / "train" / "labels.jsonl", "w") as f:
        for i in range(n):
            name = f"x_{i}.png"
            size = hw if i % 3 else (hw[0] + 5, hw[1] + 3)  # some need the bilinear resize
            Image.fromarray(rng.randint(0, 255, (*size, 3), dtype=np.uint8)).save(img_dir / name)
            f.write(json.dumps({"file": f"train/images/{name}",
                                "labels": {"blur": i % 2, "noise": 1 - i % 2},
                                "severity": {"blur": 0.5 * (i % 2), "noise": 0.3}}) + "\n")


@pytest.mark.parametrize("shuffle", [False, True])
def test_classifier_loader_matches_jax(tmp_path, shuffle):
    """Over a labels.jsonl tree (tests/test_classifier.py's): the same order,
    decoded and normalised images, labels, severities and paths, epoch by
    epoch; the train augmentation keeps shapes and values finite."""
    _write_tree(tmp_path)
    classes = ["blur", "noise"]
    jds = JaxDataset(str(tmp_path), "train", classes, input_hw=(16, 24))
    ds = MultiLabelSeverityDataset(str(tmp_path), "train", classes, input_hw=(16, 24))
    jl = JaxClassifierLoader(jds, batch_size=3, shuffle=shuffle, augment=False, normalize=True)
    pl = ClassifierLoader(ds, batch_size=3, shuffle=shuffle, augment=False, normalize=True,
                          device="cpu")
    assert len(pl) == len(jl) == 3
    for _ in range(2):
        for (jx, jy, js, jp), (x, y, s, p) in zip(jl, pl, strict=True):
            assert p == jp
            assert np.abs(x.numpy() - np.asarray(jx)).max() <= 1e-6
            np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
            np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    aug = ClassifierLoader(ds, batch_size=4, shuffle=True, augment=True, device="cpu")
    xs = [x for x, _, _, _ in aug]
    assert [tuple(x.shape) for x in xs] == [(4, 16, 24, 3), (3, 16, 24, 3)]
    assert all(bool(torch.isfinite(x).all()) for x in xs)


def _metric_inputs():
    rng = np.random.RandomState(3)
    y = (rng.rand(40, 5) > 0.6).astype(np.float32)
    y[:, 4] = 0  # a class with no positives
    probs = np.clip(y * 0.5 + rng.rand(40, 5) * 0.6, 0, 1).astype(np.float32)
    return y, probs, rng.rand(40, 5).astype(np.float32), rng.rand(40, 5).astype(np.float32)


CLASSES = ["a", "b", "c", "d", "e"]
METRICS = {
    "f1_micro_macro": lambda m, y, p, st, sp: m.f1_micro_macro(y, m.apply_thresholds(p, [0.5] * 5)),
    "per_class_f1": lambda m, y, p, st, sp: m.per_class_f1(y, (p > 0.4).astype(np.float32), CLASSES),
    "severity_mae": lambda m, y, p, st, sp: (m.severity_mae(y, st, sp), m.severity_mae(0 * y, st, sp)),
    "apply_thresholds": lambda m, y, p, st, sp: m.apply_thresholds(p, [0.1, 0.3, 0.5, 0.7, 0.9]),
    "compute_pos_weight": lambda m, y, p, st, sp: m.compute_pos_weight(
        [{"labels": dict(zip(CLASSES, map(int, row)))} for row in y], CLASSES),
    "tune_thresholds": lambda m, y, p, st, sp: m.tune_thresholds_per_class_for_f1(
        p, y, CLASSES, list(np.linspace(0.05, 0.95, 19))),
    "pr_curve_and_ap": lambda m, y, p, st, sp: [
        (m.precision_recall_curve_binary(y[:, c], p[:, c]),
         m.average_precision(*m.precision_recall_curve_binary(y[:, c], p[:, c])[:2]))
        for c in range(4)],
    "constants": lambda m, y, p, st, sp: (m.DEFAULT_THRESH, m.EPS),
}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_matches_jax(name):
    args = _metric_inputs()
    want, got = METRICS[name](JM, *args), METRICS[name](M, *args)
    flat_w, flat_g = jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)
    assert jax.tree_util.tree_structure(want) == jax.tree_util.tree_structure(got)
    for a, b in zip(flat_w, flat_g):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
