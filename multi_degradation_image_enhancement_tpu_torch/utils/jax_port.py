"""Weight bridge: a Flax CDAN or ``MultiHeadClassifier`` ``{params,
batch_stats}`` tree ↔ the port's ``state_dict``.

The inverse of ``multi_degradation_image_enhancement_tpu/utils/torch_port.py``
``port_reference_cdan``, with the same mapping table written out again here
(this package imports nothing of JAX).  The tree is a nested dict of NumPy
arrays (``jax.tree.map(np.asarray, variables)``); nothing here needs JAX.

Layout conversions (Flax → PyTorch):
  * conv kernel HWIO → OIHW;
  * decoder deconvs: the JAX side holds the reference's stride-1
    ``ConvTranspose2d`` weight ``[in, out, kh, kw]`` as a spatially flipped
    HWIO conv kernel, so the flip is undone: ``[kh, kw, in, out]`` →
    ``[in, out, kh, kw]`` then flip kh, kw;
  * Dense kernel ``[in, out]`` → Linear weight ``[out, in]``;
  * BatchNorm scale/bias/mean/var → weight/bias/running_mean/running_var.

:func:`state_dict_to_flax` is the inverse map (NumPy only), so tests can hold
parameters and statistics after a train step against the JAX package's.

:func:`load_feature_net` carries a frozen feature network across (the JAX
package's ``VGG19Features`` or ``LPIPS`` parameter tree → the port's module),
with the key map of the npz loader (``ops.perceptual._flax_to_torch``).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Tuple

import numpy as np
import torch

from multi_degradation_image_enhancement_tpu_torch.ops.perceptual import _flax_to_torch


def _dense_block_entries(flax_prefix: Tuple[str, ...], torch_prefix: str):
    """``torch_prefix`` ends with a dot, or is empty for a bare DenseBlock."""
    out = []
    for i in range(4):
        out += [
            (flax_prefix + (f"bn_{i}",), f"{torch_prefix}layers.{i}.0", "bn"),
            (flax_prefix + (f"conv_{i}",), f"{torch_prefix}layers.{i}.2", "conv"),
        ]
    out += [
        (flax_prefix + ("bn_t",), f"{torch_prefix}transition_layer.0", "bn"),
        (flax_prefix + ("conv_t",), f"{torch_prefix}transition_layer.2", "conv"),
    ]
    return out


def _cbam_entries(flax_prefix: Tuple[str, ...], torch_prefix: str, no_spatial: bool = False):
    """``torch_prefix`` ends with a dot, or is empty for a bare CBAM; a
    ``no_spatial`` CBAM has no spatial gate on either side."""
    entries = [
        (flax_prefix + ("ChannelGate_0", "fc1"), f"{torch_prefix}ChannelGate.mlp.1", "linear"),
        (flax_prefix + ("ChannelGate_0", "fc2"), f"{torch_prefix}ChannelGate.mlp.3", "linear"),
    ]
    if not no_spatial:
        entries += [
            (flax_prefix + ("SpatialGate_0", "spatial", "Conv_0"),
             f"{torch_prefix}SpatialGate.spatial.conv", "conv_nobias"),
            (flax_prefix + ("SpatialGate_0", "spatial", "BatchNorm_0"),
             f"{torch_prefix}SpatialGate.spatial.bn", "bn"),
        ]
    return entries


def cdan_mapping():
    """(Flax module path, PyTorch module prefix, kind) for the whole CDAN."""
    entries = []
    for i in range(1, 5):
        entries += [
            (("encoder", f"conv{i}", "Conv_0"), f"encoder.conv{i}.conv", "conv"),
            (("encoder", f"conv{i}", "BatchNorm_0"), f"encoder.conv{i}.bn", "bn"),
        ]
    for i in range(1, 4):
        entries += _dense_block_entries(("encoder", f"dense{i}"), f"encoder.dense{i}.")
    entries += _cbam_entries(("bottleneck",), "bottleneck.")
    for i in range(1, 5):
        entries += [
            (("decoder", f"de{i}_conv"), f"decoder.conv{i}", "deconv"),
            (("decoder", f"de{i}_bn"), f"decoder.bn{i}", "bn"),
        ]
    for i in range(1, 4):
        entries += _cbam_entries(("decoder", f"cbam{i}"), f"decoder.cbam{i}.")
    entries += _dense_block_entries(("decoder", "final_dense"), "decoder.final_dense.")
    return entries


def classifier_mapping():
    """(Flax module path, PyTorch module prefix, kind) for the whole
    ``MultiHeadClassifier``: Flax's ``layer{i}_{j}`` is torchvision's
    ``layer{i}.{j}``, its ``downsample_conv`` / ``downsample_bn`` are
    ``downsample.0`` / ``.1``."""
    entries = [(("backbone", "conv1"), "backbone.conv1", "conv_nobias"),
               (("backbone", "bn1"), "backbone.bn1", "bn")]
    for li in range(1, 5):
        for bi in range(2):
            flax, torch_ = ("backbone", f"layer{li}_{bi}"), f"backbone.layer{li}.{bi}"
            entries += [(flax + (name,), f"{torch_}.{name}", kind) for name, kind in (
                ("conv1", "conv_nobias"), ("bn1", "bn"), ("conv2", "conv_nobias"), ("bn2", "bn"))]
            if li > 1 and bi == 0:  # stride 2 and a new width: the 1x1 downsample
                entries += [(flax + ("downsample_conv",), f"{torch_}.downsample.0", "conv_nobias"),
                            (flax + ("downsample_bn",), f"{torch_}.downsample.1", "bn")]
    return entries + [(("head_cls",), "head_cls", "linear"), (("head_sev",), "head_sev", "linear")]


def _conv(k: np.ndarray) -> np.ndarray:
    return k.transpose(3, 2, 0, 1)  # HWIO → OIHW


def _deconv(k: np.ndarray) -> np.ndarray:
    return k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]  # flipped HWIO → [in, out, kh, kw]


def conv_to_hwio(w: np.ndarray) -> np.ndarray:
    """OIHW → HWIO (the inverse of :func:`_conv`)."""
    return np.asarray(w).transpose(2, 3, 1, 0)


def _deconv_to_hwio(w: np.ndarray) -> np.ndarray:
    """``[in, out, kh, kw]`` → the flipped HWIO kernel (the inverse of :func:`_deconv`)."""
    return np.asarray(w)[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)


def _node(tree: Dict[str, Any], path: Tuple[str, ...]) -> Dict[str, Any]:
    for p in path:
        tree = tree[p]
    return tree


def convert_entries(variables: Dict[str, Any], entries) -> Dict[str, torch.Tensor]:
    """Apply a mapping table to a Flax ``{params, batch_stats}`` tree."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}
    for path, prefix, kind in entries:
        p = _node(params, path)
        if kind in ("conv", "conv_nobias"):
            sd[f"{prefix}.weight"] = _conv(np.asarray(p["kernel"]))
            if kind == "conv":
                sd[f"{prefix}.bias"] = np.asarray(p["bias"])
        elif kind == "deconv":
            sd[f"{prefix}.weight"] = _deconv(np.asarray(p["kernel"]))
            sd[f"{prefix}.bias"] = np.asarray(p["bias"])
        elif kind == "linear":
            sd[f"{prefix}.weight"] = np.asarray(p["kernel"]).T
            sd[f"{prefix}.bias"] = np.asarray(p["bias"])
        elif kind == "bn":
            s = _node(stats, path)
            sd[f"{prefix}.weight"] = np.asarray(p["scale"])
            sd[f"{prefix}.bias"] = np.asarray(p["bias"])
            sd[f"{prefix}.running_mean"] = np.asarray(s["mean"])
            sd[f"{prefix}.running_var"] = np.asarray(s["var"])
            sd[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)
        else:
            raise ValueError(f"unknown mapping kind {kind!r}")
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}  # own, writable copies


def flax_to_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A Flax CDAN ``{params, batch_stats}`` tree → the port's CDAN
    ``state_dict`` (load with ``strict=True``)."""
    return convert_entries(variables, cdan_mapping())


def dense_block_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A Flax ``DenseBlock`` tree → the port's ``DenseBlock`` ``state_dict``."""
    return convert_entries(variables, _dense_block_entries((), ""))


def cbam_state_dict(variables: Dict[str, Any], no_spatial: bool = False
                    ) -> Dict[str, torch.Tensor]:
    """A Flax ``CBAM`` tree → the port's ``CBAM`` ``state_dict`` (no
    ``SpatialGate.*`` keys for a ``no_spatial`` CBAM)."""
    return convert_entries(variables, _cbam_entries((), "", no_spatial))


def classifier_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A Flax ``MultiHeadClassifier`` tree → the port's classifier
    ``state_dict`` (load with ``strict=True``)."""
    return convert_entries(variables, classifier_mapping())


def _set(tree: Dict[str, Any], path: Tuple[str, ...], leaf: Dict[str, np.ndarray]) -> None:
    for p in path:
        tree = tree.setdefault(p, {})
    tree.update(leaf)


def state_dict_to_flax(sd: Dict[str, Any], entries=None) -> Dict[str, Any]:
    """The port's CDAN ``state_dict`` (tensors or arrays) → a Flax
    ``{params, batch_stats}`` tree of NumPy arrays (``entries`` defaults to the
    whole CDAN's mapping table; :func:`classifier_mapping` gives the
    classifier's)."""

    def get(key):
        v = sd[key]
        return np.array(v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)

    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for path, prefix, kind in cdan_mapping() if entries is None else entries:
        if kind in ("conv", "conv_nobias"):
            leaf = {"kernel": conv_to_hwio(get(f"{prefix}.weight"))}
            if kind == "conv":
                leaf["bias"] = get(f"{prefix}.bias")
        elif kind == "deconv":
            leaf = {"kernel": _deconv_to_hwio(get(f"{prefix}.weight")),
                    "bias": get(f"{prefix}.bias")}
        elif kind == "linear":
            leaf = {"kernel": get(f"{prefix}.weight").T, "bias": get(f"{prefix}.bias")}
        elif kind == "bn":
            leaf = {"scale": get(f"{prefix}.weight"), "bias": get(f"{prefix}.bias")}
            _set(stats, path, {"mean": get(f"{prefix}.running_mean"),
                               "var": get(f"{prefix}.running_var")})
        else:
            raise ValueError(f"unknown mapping kind {kind!r}")
        _set(params, path, {k: np.ascontiguousarray(v) for k, v in leaf.items()})
    return {"params": params, "batch_stats": stats}


@torch.no_grad()
def load_feature_net(module: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Copy a Flax ``params`` tree of NumPy arrays (``VGG19Features``:
    ``conv_{i}/kernel``; ``LPIPS``: ``net/conv_{i}/…``, ``lin_{k}``) into
    ``module``'s parameters; every parameter must be set, shapes must agree."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, path):
        for k, v in node.items():
            key = f"{path}/{k}" if path else k
            if isinstance(v, Mapping):
                walk(v, key)
            else:
                name, arr = _flax_to_torch(key, np.asarray(v))
                flat[name] = arr

    walk(params, "")
    own = dict(module.named_parameters())
    if set(flat) != set(own):
        raise ValueError(f"parameter names differ: {sorted(set(flat) ^ set(own))}")
    for name, arr in flat.items():
        if tuple(arr.shape) != tuple(own[name].shape):
            raise ValueError(f"shape mismatch for {name}: {arr.shape} vs {tuple(own[name].shape)}")
        own[name].copy_(torch.from_numpy(np.ascontiguousarray(arr)))
    return module
