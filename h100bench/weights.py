"""Weights made from ``--seed`` on the run's device, in a few large draws.

CDAN: a Flax-default-style init with everything a fold or a statistic reads
moved off its neutral value, so a kernel that dropped a bias, a BatchNorm
scale or a running statistic would show:

* conv, deconv and linear kernels: LeCun normal truncated at ±2σ (Flax's
  ``lecun_normal``, fan_in = kh·kw·c_in, 9·c_in for the decoder's deconvs,
  in_features for a linear), drawn as one buffer;
* biases N(0, 0.02²); BatchNorm scale 1 ± 0.1, shift ± 0.1, running mean
  ± 0.1, running variance 1 ± 0.2 (uniform), drawn as one buffer each.

Running statistics near 0 and 1 keep the decoder's ReLUs open: the network,
not the global residual, carries the output (``RefCDAN.network_share``).

The frozen loss networks (VGG19 ``features[:20]``, LPIPS-alex): He-normal
kernels (their activations stay of order one through the ReLUs), biases
N(0, 0.01²), LPIPS's ``lin`` U[0, 0.1).  :func:`write_perceptual_npz` writes
them as the npz files the program loads from ``$MDIE_WEIGHTS_DIR`` (Flax
paths, HWIO kernels); the reference takes the same tensors.
"""

from __future__ import annotations

import math
import os
from typing import Dict

import numpy as np
import torch

from h100bench.reference.cdan import cdan_shapes
from h100bench.reference.losses import ALEX_CONVS, VGG19_20

TRUNCATED_STD = 0.87962566103423978  # std of N(0, 1) cut at ±2
LPIPS_ALEX_CHANNELS = (64, 192, 384, 256, 256)


def _fan_in(name: str, shape) -> int:
    if len(shape) == 2:  # linear [out, in]
        return shape[1]
    if name.startswith("decoder.conv"):  # ConvTranspose2d [in, out, kh, kw]
        return shape[0] * shape[2] * shape[3]
    return shape[1] * shape[2] * shape[3]


def _split(flat: torch.Tensor, shapes: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape)
        at += n
    return out


@torch.no_grad()
def cdan_state(generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The CDAN weights and running statistics by published name, float32."""
    shapes = cdan_shapes()
    kernels = {k: s for k, s in shapes.items() if k.endswith(".weight") and len(s) >= 2}
    bn = {k: s for k, s in shapes.items() if len(s) == 1 and (
        k.endswith(("running_mean", "running_var")) or
        k.rsplit(".", 1)[0] + ".running_mean" in shapes)}
    biases = {k: s for k, s in shapes.items() if k not in kernels and k not in bn}

    def draw(group, fill):
        flat = torch.empty(sum(math.prod(s) for s in group.values()), device=device)
        fill(flat)
        return _split(flat, group)

    state = draw(kernels, lambda t: torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                                                generator=generator))
    for k, s in kernels.items():
        state[k].mul_(math.sqrt(1.0 / _fan_in(k, s)) / TRUNCATED_STD)
    state.update(draw(biases, lambda t: t.normal_(0.0, 0.02, generator=generator)))
    for k, t in draw(bn, lambda t: t.uniform_(-1.0, 1.0, generator=generator)).items():
        if k.endswith("running_var"):
            t.mul_(0.2).add_(1.0)
        elif k.endswith("weight"):
            t.mul_(0.1).add_(1.0)
        else:
            t.mul_(0.1)
        state[k] = t
    return {k: state[k] for k in shapes}


def perceptual_shapes() -> Dict[str, tuple]:
    shapes, c_in = {}, 3
    for i, op in enumerate(VGG19_20):
        if isinstance(op, int):
            shapes[f"vgg.conv_{i}.weight"] = (op, c_in, 3, 3)
            shapes[f"vgg.conv_{i}.bias"] = (op,)
            c_in = op
    for i, ci, co, k, _, _ in ALEX_CONVS:
        shapes[f"alex.conv_{i}.weight"] = (co, ci, k, k)
        shapes[f"alex.conv_{i}.bias"] = (co,)
    for k, c in enumerate(LPIPS_ALEX_CHANNELS):
        shapes[f"alex.lin_{k}"] = (c, 1)
    return shapes


@torch.no_grad()
def perceptual_state(generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """VGG19 ``features[:20]`` and LPIPS-alex weights by name (torch layouts)."""
    shapes = perceptual_shapes()
    flat = torch.empty(sum(math.prod(s) for s in shapes.values()), device=device)
    flat.normal_(0.0, 1.0, generator=generator)
    state = _split(flat, shapes)
    for k, t in state.items():
        if k.endswith(".weight"):
            t.mul_(math.sqrt(2.0 / math.prod(t.shape[1:])))
        elif k.endswith(".bias"):
            t.mul_(0.01)
        else:  # lin: U[0, 0.1) from the same normals, by their CDF
            t.copy_(0.05 * (1.0 + torch.erf(t / math.sqrt(2.0))))
    return state


def write_perceptual_npz(state: Dict[str, torch.Tensor], directory: str) -> None:
    """``vgg19_features.npz`` and ``lpips_alex.npz`` in ``directory``, keyed
    by the Flax paths the program's ``init_frozen_params`` maps
    (``conv_{i}/kernel`` HWIO, ``net/conv_{i}/bias``, ``lin_{k}``)."""
    os.makedirs(directory, exist_ok=True)
    host = {k: v.detach().float().cpu().numpy() for k, v in state.items()}
    files = {"vgg19_features.npz": {}, "lpips_alex.npz": {}}
    for name, arr in host.items():
        net, rest = name.split(".", 1)
        target = files["vgg19_features.npz" if net == "vgg" else "lpips_alex.npz"]
        prefix = "" if net == "vgg" else "net/"
        if rest.startswith("lin_"):
            target[rest] = arr
        elif rest.endswith(".weight"):
            target[prefix + rest[:-len(".weight")] + "/kernel"] = arr.transpose(2, 3, 1, 0)
        else:
            target[prefix + rest[:-len(".bias")] + "/bias"] = arr
    for fname, arrays in files.items():
        tmp = os.path.join(directory, fname + ".partial.npz")
        np.savez(tmp, **arrays)
        os.replace(tmp, os.path.join(directory, fname))
