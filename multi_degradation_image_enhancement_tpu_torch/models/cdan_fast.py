"""Fused CDAN inference forward (serving path).

Counterpart of ``multi_degradation_image_enhancement_tpu/models/cdan_fast.py``
``build_fast_apply`` (:435) and ``build_serving_apply`` (:406).  From an eval
``CDAN`` it builds a forward that:

* folds every conv + BatchNorm pair into one conv (the decoder's
  ``ConvTranspose2d(k3, s1, p1)`` becomes the equivalent 3×3 conv first);
* runs the four DenseBlocks through the DenseBlock kernel
  (``ops.cuda.dense_block``: CUDA on the card, the plain version on the CPU);
* keeps CBAM and the bilinear upsample as the plain modules;
* runs the folded 3×3 convs as ``F.conv2d`` (XLA's convs in the JAX package).

Activations are NCHW in ``dtype`` inside; the forward takes and returns NHWC,
[0, 1] in, f32 out.  Numerical contract: equals ``CDAN`` in eval mode to bf16
tolerance at ``dtype=bfloat16`` (the DenseBlock kernel holds features in bf16)
and to f32 tolerance at ``dtype=float32`` on the CPU.

Inference only: the forward runs under ``torch.inference_mode()`` on frozen
copies of the weights, and raises when called with grad enabled on an input
that requires grad (training goes through ``models.cdan.CDAN``).
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN, _bilinear_x2
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import (
    dense_block,
    fold_bn,
    pack_dense_block,
    require_no_grad,
)


def _fold_conv_bn(weight: torch.Tensor, bias: torch.Tensor, bn) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold inference BN into the preceding conv's OIHW weight and bias."""
    a, b = fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
    return weight * a[:, None, None, None], bias * a + b


def _deconv_as_conv(deconv) -> torch.Tensor:
    """Stride-1 ``ConvTranspose2d`` weight ``[in, out, kh, kw]`` → the
    equivalent conv weight ``[out, in, kh, kw]``: flip, then swap in/out."""
    return deconv.weight.flip(2, 3).transpose(0, 1)


@torch.no_grad()
def _fold_all(model: CDAN) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    enc, dec = model.encoder, model.decoder
    folded = {}
    for i in range(1, 5):
        block = getattr(enc, f"conv{i}")
        folded[f"conv{i}"] = _fold_conv_bn(block.conv.weight, block.conv.bias, block.bn)
    for i in range(1, 5):
        deconv = getattr(dec, f"conv{i}")
        folded[f"de{i}"] = _fold_conv_bn(_deconv_as_conv(deconv), deconv.bias, getattr(dec, f"bn{i}"))
    return folded


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was asked for but no CUDA device is available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


@torch.no_grad()
def build_fast_apply(
    model: CDAN, dtype=torch.bfloat16, device="cuda"
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build the fused inference forward from an eval ``CDAN``.

    Returns ``apply_fn(x_nhwc_01) -> restored`` (f32, NHWC) closing over the
    folded weights and DenseBlock packs, so nothing is repacked per step.
    """
    device = resolve_device(device)
    folded = {
        name: (w.to(device=device, dtype=dtype).contiguous(), b.to(device=device, dtype=dtype))
        for name, (w, b) in _fold_all(model).items()
    }
    enc, dec = model.encoder, model.decoder
    packs = {
        "dense1": pack_dense_block(enc.dense1, device),
        "dense2": pack_dense_block(enc.dense2, device),
        "dense3": pack_dense_block(enc.dense3, device),
        "final_dense": pack_dense_block(dec.final_dense, device),
    }
    cbams = {
        name: copy.deepcopy(mod).to(device=device, dtype=dtype).eval().requires_grad_(False)
        for name, mod in (("bottleneck", model.bottleneck), ("cbam1", dec.cbam1),
                          ("cbam2", dec.cbam2), ("cbam3", dec.cbam3))
    }
    frozen = [t for wb in folded.values() for t in wb]
    frozen += [p for mod in cbams.values() for p in mod.parameters()]

    def conv_relu(x: torch.Tensor, name: str) -> torch.Tensor:
        w, b = folded[name]
        return torch.relu(F.conv2d(x, w, b, padding=1))

    def apply_fn(x_nhwc: torch.Tensor) -> torch.Tensor:
        require_no_grad("the serving forward", [x_nhwc, *frozen])
        with torch.inference_mode():
            return forward(x_nhwc)

    def forward(x_nhwc: torch.Tensor) -> torch.Tensor:
        x = x_nhwc.to(device=device, dtype=dtype).permute(0, 3, 1, 2).contiguous()

        out = F.max_pool2d(conv_relu(x, "conv1"), 2)
        d1 = dense_block(out, packs["dense1"])
        skip0 = out
        out = F.max_pool2d(conv_relu(out, "conv2"), 2)
        d2 = dense_block(out, packs["dense2"])
        skip1 = out
        out = F.max_pool2d(conv_relu(out, "conv3"), 2)
        d3 = dense_block(out, packs["dense3"])
        skip2 = out
        out = cbams["bottleneck"](conv_relu(out, "conv4"))

        out = cbams["cbam1"](conv_relu(out, "de1") + skip2)
        out = out * d3
        out = cbams["cbam2"](_bilinear_x2(conv_relu(out, "de2")) + skip1)
        out = out * d2
        out = cbams["cbam3"](_bilinear_x2(conv_relu(out, "de3")) + skip0)
        out = out * d1
        out = _bilinear_x2(conv_relu(out, "de4")) + x  # de4 keeps its ReLU; global residual
        out = torch.sigmoid(dense_block(out.contiguous(), packs["final_dense"]))
        return out.permute(0, 2, 3, 1).float()

    return apply_fn


def build_serving_apply(
    model: CDAN, dtype=torch.bfloat16, device="cuda"
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The serving forward: the per-DenseBlock fused path.  (The JAX
    package's all-channel-major alternative is off in its shipped tuning and
    is not ported.)"""
    return build_fast_apply(model, dtype, device)
