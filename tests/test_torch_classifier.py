"""PyTorch port: the ResNet-18 multi-head classifier, its weight bridge and the
converted-npz loader, against the JAX package's ``MultiHeadClassifier``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_degradation_image_enhancement_tpu.classification.model import (
    MultiHeadClassifier as JaxClassifier,
    init_classifier_variables,
)
from multi_degradation_image_enhancement_tpu.models.resnet import (
    load_torchvision_npz as jax_load_npz,
)
from multi_degradation_image_enhancement_tpu_torch.classification.model import (
    MultiHeadClassifier,
    init_classifier,
)
from multi_degradation_image_enhancement_tpu_torch.classification.train import (
    load_checkpoint,
    save_checkpoint,
)
from multi_degradation_image_enhancement_tpu_torch.models.resnet import (
    ResNet18Features,
    load_torchvision_npz,
)
from multi_degradation_image_enhancement_tpu_torch.utils.jax_port import (
    classifier_mapping,
    classifier_state_dict,
    state_dict_to_flax,
)

H, W, N_CLASSES = 32, 48, 9


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.fixture(scope="module")
def jax_clf():
    """(module, variables as NumPy with random BN statistics) of a JAX classifier."""
    m = JaxClassifier(num_classes=N_CLASSES, dtype=jnp.float32)
    v = m.init({"params": jax.random.key(0)}, jnp.zeros((1, H, W, 3)), train=False)
    rng = np.random.RandomState(0)
    stats = jax.tree.map(lambda t: rng.uniform(0.5, 1.5, t.shape).astype(np.float32),
                         v["batch_stats"])
    return m, {"params": jax.tree.map(np.asarray, v["params"]), "batch_stats": stats}


def test_logits_match_jax(jax_clf):
    m, variables = jax_clf
    x = np.random.RandomState(1).randn(2, H, W, 3).astype(np.float32)
    want_cls, want_sev = m.apply(variables, jnp.asarray(x), train=False)
    model = MultiHeadClassifier(N_CLASSES)
    model.load_state_dict(classifier_state_dict(variables), strict=True)
    with torch.no_grad():
        got_cls, got_sev = model.eval()(torch.from_numpy(x))
    assert got_cls.dtype == torch.float32 and tuple(got_cls.shape) == (2, N_CLASSES)
    assert np.abs(got_cls.numpy() - np.asarray(want_cls)).max() <= 1e-4
    assert np.abs(got_sev.numpy() - np.asarray(want_sev)).max() <= 1e-4


def test_state_dict_round_trip_is_bit_exact(tmp_path):
    """port ``state_dict`` → Flax tree (the JAX module's own paths and shapes)
    → ``state_dict``, bit for bit; and through the port's checkpoint files."""
    model = init_classifier(torch.Generator().manual_seed(3), N_CLASSES, pretrained_backbone=False)
    sd = model.state_dict()
    tree = state_dict_to_flax(sd, classifier_mapping())
    template = JaxClassifier(num_classes=N_CLASSES).init(
        {"params": jax.random.key(0)}, jnp.zeros((1, H, W, 3)), train=False)
    for coll in ("params", "batch_stats"):
        want, got = _leaves(template[coll]), _leaves(tree[coll])
        assert [p for p, _ in want] == [p for p, _ in got]
        assert [np.shape(a) for _, a in want] == [np.shape(b) for _, b in got]
    back = classifier_state_dict(tree)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    save_checkpoint(str(tmp_path / "clf.pt"), model, {"classes": ["a"]})
    loaded = load_checkpoint(str(tmp_path / "clf.pt"), MultiHeadClassifier(N_CLASSES))
    assert all(torch.equal(loaded.state_dict()[k], v) for k, v in sd.items())
    assert (tmp_path / "clf.pt.json").read_text().count('"a"') == 1


def _fake_npz(seed: int) -> dict:
    """A seeded stand-in for the converter's ``resnet18.npz``: torchvision's
    keys, HWIO kernels, Flax BatchNorm names, and an fc head to be ignored."""
    rng = np.random.RandomState(seed)
    npz = {}
    for name, t in {**dict(ResNet18Features().named_parameters()),
                    **dict(ResNet18Features().named_buffers())}.items():
        *path, leaf = name.split(".")
        if leaf == "num_batches_tracked":
            continue
        key_leaf = {"running_mean": "mean", "running_var": "var"}.get(leaf, leaf)
        if leaf == "weight":
            key_leaf = "kernel" if t.dim() == 4 else "scale"
        shape = tuple(t.shape)
        if key_leaf == "kernel":
            shape = (shape[2], shape[3], shape[1], shape[0])  # OIHW → HWIO
        value = rng.uniform(0.5, 1.5, shape) if key_leaf == "var" else rng.randn(*shape) * 0.1
        npz["/".join(path + [key_leaf])] = value.astype(np.float32)
    npz["fc/kernel"] = rng.randn(512, 1000).astype(np.float32)
    npz["fc/bias"] = np.zeros(1000, np.float32)
    return npz


def test_npz_loader_matches_jax(tmp_path, monkeypatch):
    """The same fake npz through ``$MDIE_WEIGHTS_DIR`` into both packages'
    classifiers: every backbone parameter and statistic equal, bit for bit."""
    npz = _fake_npz(4)
    np.savez(tmp_path / "resnet18.npz", **npz)
    monkeypatch.setenv("MDIE_WEIGHTS_DIR", str(tmp_path))
    jax_vars = init_classifier_variables(JaxClassifier(num_classes=N_CLASSES), (H, W))
    want = classifier_state_dict(jax.tree.map(np.asarray, dict(jax_vars)))
    got = init_classifier(torch.Generator().manual_seed(0), N_CLASSES).state_dict()
    keys = [k for k in want if k.startswith("backbone.") and "num_batches" not in k]
    assert len(keys) == 100
    for k in keys:
        assert torch.equal(got[k], want[k]), k
    # the key rules: downsample/0 is the 1x1 conv (HWIO → OIHW), downsample/1 its BN
    assert torch.equal(got["backbone.layer2.0.downsample.0.weight"],
                       torch.from_numpy(npz["layer2/0/downsample/0/kernel"].transpose(3, 2, 0, 1)))
    assert torch.equal(got["backbone.layer4.0.downsample.1.running_var"],
                       torch.from_numpy(npz["layer4/0/downsample/1/var"]))


def test_npz_loader_rejects_bad_files():
    bad = _fake_npz(5)
    bad["conv1/kernel"] = bad["conv1/kernel"][:3]
    with pytest.raises(ValueError, match="shape"):
        load_torchvision_npz(ResNet18Features(), bad)
    with pytest.raises(ValueError, match="No resnet18 weights"):
        load_torchvision_npz(ResNet18Features(), {"fc/kernel": np.zeros((512, 1000), np.float32)})
    with pytest.raises(ValueError, match="shape"):  # the JAX loader refuses the same file
        v = JaxClassifier(num_classes=N_CLASSES).init(
            {"params": jax.random.key(0)}, jnp.zeros((1, H, W, 3)), train=False)
        jax_load_npz({"params": v["params"]["backbone"],
                      "batch_stats": v["batch_stats"]["backbone"]}, bad)
