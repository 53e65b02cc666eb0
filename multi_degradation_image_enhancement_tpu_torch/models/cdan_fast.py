"""Fused CDAN inference forwards (serving and eval).

Counterpart of ``multi_degradation_image_enhancement_tpu/models/cdan_fast.py``:
the per-DenseBlock forward ``build_fast_apply`` (:435), the all-channel-major
forward ``build_fast_apply_cm`` (:268), and ``build_serving_apply`` (:406),
which picks one of them per image size.  From an eval ``CDAN`` both forwards:

* fold every conv + BatchNorm pair into one conv (the decoder's
  ``ConvTranspose2d(k3, s1, p1)`` becomes the equivalent 3×3 conv first);
* run the four DenseBlocks through the DenseBlock kernel
  (``ops.cuda.dense_block``: CUDA on the card, the plain version on the CPU);
* run each of the decoder's three bilinear ×2 upsamples together with the
  skip or residual added after it as one pass of the fused kernel
  (``ops.cuda.upsample.bilinear_x2_add``), rounded once.

They differ where the JAX package's do.  :func:`build_fast_apply` runs the
folded convs as ``F.conv2d`` (XLA's convs in the JAX package), conv1's pool
as ``F.max_pool2d`` and CBAM as the plain modules.
:func:`build_fast_apply_cm` runs conv1 + BN + ReLU + 2×2 pool as one kernel
(``ops.cuda.conv_cm.conv3x3_pool``, TPU kernel #9), every other conv as the
conv kernel (``conv3x3``, #8), and each CBAM with its spatial BatchNorm
folded, together with the decoder's product by d3 / d2 / d1 after it, as one
call of the fused CBAM kernel (``ops.cuda.cbam.cbam_cm``, :func:`_cbam_cm`).
The port's channel-major layout is plain NCHW, so both
keep NCHW inside.  The JAX package's third DenseBlock route, the row-tiled
``_run_cm`` (#3) for images whose whole-image kernel does not fit VMEM, has
no branch here: the CUDA DenseBlock covers whole images at every size.

Activations are in ``dtype`` inside; the forwards take and return NHWC,
[0, 1] in, f32 out.  Numerical contract: equal to ``CDAN`` in eval mode to
bf16 tolerance at ``dtype=bfloat16`` (the kernels hold features and operands
in bf16) and to f32 tolerance at ``dtype=float32`` on the CPU with
:func:`build_fast_apply` (the CM forward's conv kernels take bf16 operands
at any dtype, as the TPU kernels do).  The serving tuning file's ``db_bf16_act``
and ``db_k_stack_max_ci`` reach every DenseBlock pack (:func:`serving_tuning`),
as the JAX package's ``_DB_BF16_ACT`` reaches its DenseBlock calls.

Inference only: the forwards run under ``torch.inference_mode()`` on frozen
copies of the weights, and raise when called with grad enabled on an input
that requires grad (training goes through ``models.cdan.CDAN``).

Spans (``utils.tracing``, recorded only under a profiler): each call of a
built forward is ``serve/forward``, each bilinear ×2 with its add
``cdan/upsample`` and each CBAM ``cdan/cbam`` (in the CM forward with the
decoder's product after it), device ranges on the card.
"""

from __future__ import annotations

import copy
import json
import os
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.cbam import cbam_cm
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.conv_cm import (
    conv3x3,
    conv3x3_pool,
    pack_conv,
    pack_conv_pool,
)
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import (
    dense_block,
    fold_bn,
    pack_dense_block,
    require_no_grad,
)
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.upsample import bilinear_x2_add
from multi_degradation_image_enhancement_tpu_torch.utils.tracing import span


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


def _pack_dense_blocks(model: CDAN, device, bf16_act=None, k_stack_max_ci=None) -> Dict[str, Any]:
    """The four DenseBlocks' packs; ``bf16_act`` / ``k_stack_max_ci`` None:
    the serving tuning file's (:func:`serving_tuning`)."""
    tuning = serving_tuning()
    bf16_act = tuning["db_bf16_act"] if bf16_act is None else bool(bf16_act)
    k = tuning["db_k_stack_max_ci"] if k_stack_max_ci is None else int(k_stack_max_ci)
    enc, dec = model.encoder, model.decoder
    blocks = {"dense1": enc.dense1, "dense2": enc.dense2, "dense3": enc.dense3,
              "final_dense": dec.final_dense}
    return {name: pack_dense_block(block, device, bf16_act, k) for name, block in blocks.items()}


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was asked for but no CUDA device is available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


@torch.no_grad()
def build_fast_apply(
    model: CDAN, dtype=torch.bfloat16, device="cuda", bf16_act=None, k_stack_max_ci=None
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build the fused inference forward from an eval ``CDAN``.

    Returns ``apply_fn(x_nhwc_01) -> restored`` (f32, NHWC) closing over the
    folded weights and DenseBlock packs, so nothing is repacked per step.
    ``bf16_act`` / ``k_stack_max_ci``: the DenseBlocks' activations
    (``ops.cuda.dense_block``); None reads them from the serving tuning file
    now, as ``cdan_fast.py:489-490`` captures ``_DB_BF16_ACT`` at build time.
    """
    device = resolve_device(device)
    folded = {
        name: (w.to(device=device, dtype=dtype).contiguous(), b.to(device=device, dtype=dtype))
        for name, (w, b) in _fold_all(model).items()
    }
    dec = model.decoder
    packs = _pack_dense_blocks(model, device, bf16_act, k_stack_max_ci)
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

    def cbam(x: torch.Tensor, name: str) -> torch.Tensor:
        with span("cdan/cbam", device=x.device):
            return cbams[name](x)

    def apply_fn(x_nhwc: torch.Tensor) -> torch.Tensor:
        require_no_grad("the serving forward", [x_nhwc, *frozen])
        with span("serve/forward", device=device), torch.inference_mode():
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
        out = cbam(conv_relu(out, "conv4"), "bottleneck")

        out = cbam(conv_relu(out, "de1") + skip2, "cbam1")
        out = out * d3
        out = cbam(_upsample_x2_add(conv_relu(out, "de2"), skip1), "cbam2")
        out = out * d2
        out = cbam(_upsample_x2_add(conv_relu(out, "de3"), skip0), "cbam3")
        out = out * d1
        out = _upsample_x2_add(conv_relu(out, "de4"), x)  # de4 keeps its ReLU; global residual
        out = torch.sigmoid(dense_block(out.contiguous(), packs["final_dense"]))
        return out.permute(0, 2, 3, 1).float()

    return apply_fn


# ---------------------------------------------------- all-channel-major forward

# The CM forward's convs after conv1, all on the conv kernel (#8).  The JAX
# package picks each one's implementation from a table (``cdan_fast.py:187-195``);
# the port has none: the card's A/B (``benchmarks/tune_serving.py``,
# ``config/serving_tuning.json`` provenance, NVIDIA H100 80GB HBM3, 700.00 W,
# 2026-10-17) timed the CM step at B=128·256² bf16 with every conv on #8 at
# 27.496 ms against 30.944 with every conv on ``F.conv2d`` (27.332 against
# 30.873 under ``db_bf16_act``).
_CM_CONVS = ("conv2", "conv3", "conv4", "de1", "de2", "de3", "de4")


def pack_cbam_cm(cbam, device=None) -> Dict[str, torch.Tensor]:
    """One CBAM's f32 weights for :func:`_cbam_cm`: the channel gate's MLP,
    and the spatial gate's 7×7 conv (no bias) with its inference BatchNorm
    folded into the kernel and one scalar bias (``cdan_fast.py:105-124``)."""
    fc1, fc2 = cbam.ChannelGate.mlp[1], cbam.ChannelGate.mlp[3]
    sp = cbam.SpatialGate.spatial
    a, b = fold_bn(sp.bn.weight, sp.bn.bias, sp.bn.running_mean, sp.bn.running_var, sp.bn.eps)

    def cast(t):
        return t.detach().to(device=device, dtype=torch.float32).contiguous()

    return {"w1": cast(fc1.weight), "b1": cast(fc1.bias), "w2": cast(fc2.weight),
            "b2": cast(fc2.bias), "k7": cast(sp.conv.weight * a[:, None, None, None]),
            "bsp": cast(b)}


def _cbam_cm(x: torch.Tensor, pack: Dict[str, torch.Tensor],
             d: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CBAM (inference) on NCHW ``x`` from :func:`pack_cbam_cm`, times the
    decoder's ``d`` where given: the channel gate on the avg- and max-pooled
    vectors, then the spatial gate on the ``[max, mean]`` compress map
    (``cdan_fast.py:127-159``), then the product (``:353-367``), as one call
    of the fused kernel (``ops.cuda.cbam``), rounded once."""
    with span("cdan/cbam", device=x.device):
        return cbam_cm(x, pack, d)


def _maxpool2x2_cm(x: torch.Tensor) -> torch.Tensor:
    """2×2 max-pool (``cdan_fast.py:252``)."""
    return F.max_pool2d(x, 2)


def _upsample_x2_add(x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """×2 half-pixel bilinear upsample of ``x`` plus ``skip``
    (``cdan_fast.py:260`` and the add after it): one pass of the fused kernel
    (``ops.cuda.upsample``), rounded once."""
    with span("cdan/upsample", device=x.device):
        return bilinear_x2_add(x, skip)


@torch.no_grad()
def build_fast_apply_cm(
    model: CDAN, dtype=torch.bfloat16, device="cuda", bf16_act=None, k_stack_max_ci=None
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build the all-channel-major inference forward from an eval ``CDAN``
    (``cdan_fast.py:268-377``): conv1 + BN + ReLU + pool through
    ``conv3x3_pool``, the other convs (:data:`_CM_CONVS`) through
    ``conv3x3``, DenseBlocks through the DenseBlock kernel, folded CBAMs.
    Same contract as :func:`build_fast_apply` (``bf16_act`` /
    ``k_stack_max_ci`` too, ``cdan_fast.py:307-308``); H a multiple of 8
    and W of 16 (:func:`cm_forward_supported`)."""
    device = resolve_device(device)
    folded = _fold_all(model)
    conv1 = pack_conv_pool(*folded["conv1"], device=device)
    convs = {name: pack_conv(*folded[name], device=device) for name in _CM_CONVS}
    packs = _pack_dense_blocks(model, device, bf16_act, k_stack_max_ci)
    dec = model.decoder
    cbams = {name: pack_cbam_cm(mod, device)
             for name, mod in (("bottleneck", model.bottleneck), ("cbam1", dec.cbam1),
                               ("cbam2", dec.cbam2), ("cbam3", dec.cbam3))}
    frozen = [conv1.w_bf16, conv1.bias]
    frozen += [t for p in convs.values() for t in (p.w_bf16, p.bias)]
    frozen += [t for p in cbams.values() for t in p.values()]

    def apply_fn(x_nhwc: torch.Tensor) -> torch.Tensor:
        require_no_grad("the serving forward", [x_nhwc, *frozen])
        with span("serve/forward", device=device), torch.inference_mode():
            return forward(x_nhwc)

    def forward(x_nhwc: torch.Tensor) -> torch.Tensor:
        x = x_nhwc.to(device=device, dtype=dtype).permute(0, 3, 1, 2).contiguous()

        out = conv3x3_pool(x, conv1)  # conv1 + BN + ReLU + 2×2 pool, one pass
        d1 = dense_block(out, packs["dense1"])
        skip0 = out
        out = _maxpool2x2_cm(conv3x3(out, convs["conv2"]))
        d2 = dense_block(out, packs["dense2"])
        skip1 = out
        out = _maxpool2x2_cm(conv3x3(out, convs["conv3"]))
        d3 = dense_block(out, packs["dense3"])
        skip2 = out
        out = _cbam_cm(conv3x3(out, convs["conv4"]), cbams["bottleneck"])

        out = _cbam_cm(conv3x3(out, convs["de1"]) + skip2, cbams["cbam1"], d3)
        out = _cbam_cm(_upsample_x2_add(conv3x3(out, convs["de2"]), skip1), cbams["cbam2"], d2)
        out = _cbam_cm(_upsample_x2_add(conv3x3(out, convs["de3"]), skip0), cbams["cbam3"], d1)
        # de4 has 3 outputs; the TPU kernel pads them to 16 and slices back
        # (:368), the CUDA kernel writes 3.  de4 keeps its ReLU.
        out = _upsample_x2_add(conv3x3(out, convs["de4"]), x)  # global residual
        out = torch.sigmoid(dense_block(out, packs["final_dense"]))
        return out.permute(0, 2, 3, 1).float()

    return apply_fn


def cm_forward_supported(h: int, w: int) -> bool:
    """Whether the CM forward takes an H×W image (``cdan_fast.py:380-403``).

    The arithmetic conditions stay: three 2× pools need H and W multiples of
    8, and the JAX package's conv1 kernel needs W a multiple of 16.  Its VMEM
    predicates (``conv_pool_supported``, ``conv_supported``,
    ``cm2_supported``) have no counterpart on the card, so the port takes the
    CM forward at sizes where the JAX package does not (256×384, for one).
    """
    return h % 8 == 0 and w % 16 == 0


TUNING_ENV = "MDIE_SERVING_TUNING"
_TUNING_PATH = Path(__file__).resolve().parents[1] / "config" / "serving_tuning.json"


def serving_tuning() -> Dict[str, Any]:
    """The serving tuning the port reads from its own
    ``config/serving_tuning.json``, or from the file ``$MDIE_SERVING_TUNING``
    names, as ``_load_serving_tuning`` (``cdan_fast.py:215-249``) reads the
    JAX package's: ``db_bf16_act`` (false) and ``db_k_stack_max_ci`` (0, the
    JAX kernel's ``_K_STACK_MAX_CI``), those defaults where the file or a key
    is missing or the file does not parse.  The port's file is written by
    its tuner on the card (``benchmarks/tune_serving.py``); the JAX
    package's file holds the TPU's choice and is never read here.

    ``db_k_stack_max_ci`` picks a TPU layout (dx taps stacked on the
    contraction axis) that also keeps its layers' activations in f32, so it
    moves a rounding point only with ``db_bf16_act`` on
    (``ops.cuda.dense_block``).  The JAX file's other keys have no place
    here: its forward choice, since the image's shape alone picks the
    forward (:func:`build_serving_apply`); ``db_nhwc_io`` (NHWC blocks
    transposed in VMEM), which moves no rounding point on the card; and
    ``fused_noise`` / ``fused_noise_bf16``, which pick between the noise
    kernel and a plain draw, while the port's serving step always runs the
    noise kernel (#1) on the card, since a plain draw on the main path would
    hide it.
    """
    out = {"db_bf16_act": False, "db_k_stack_max_ci": 0}
    path = os.environ.get(TUNING_ENV) or str(_TUNING_PATH)
    try:
        with open(path, encoding="utf-8") as f:
            cfg = json.load(f)
    except (OSError, ValueError):
        return out
    out["db_bf16_act"] = bool(cfg.get("db_bf16_act", False))
    if cfg.get("db_k_stack_max_ci") is not None:
        out["db_k_stack_max_ci"] = int(cfg["db_k_stack_max_ci"])
    return out


def build_serving_apply(
    model: CDAN, dtype=torch.bfloat16, device="cuda", tuning: Optional[Dict[str, Any]] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The serving forward (``cdan_fast.py:406-425``): the CM forward for
    every image size it takes (:func:`cm_forward_supported`, checked per
    call) and the per-block forward for the rest.  The per-block forward is
    built from ``model`` at the first call whose size needs it, outside
    ``inference_mode`` (under ``pipeline.cuda_graphed`` that is an eager
    warm-up call, before any capture).  ``tuning`` holds the keys
    :func:`serving_tuning` returns (None: the serving tuning file; the tuner
    passes each variant's); both forwards take its ``db_bf16_act`` and
    ``db_k_stack_max_ci``."""
    if tuning is None:
        tuning = serving_tuning()
    act = {"bf16_act": tuning["db_bf16_act"], "k_stack_max_ci": tuning["db_k_stack_max_ci"]}
    cm = build_fast_apply_cm(model, dtype, device, **act)
    per_block: List[Callable[[torch.Tensor], torch.Tensor]] = []

    def apply_fn(x_nhwc: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x_nhwc.shape
        if cm_forward_supported(h, w):
            return cm(x_nhwc)
        if not per_block:
            with torch.inference_mode(False):
                per_block.append(build_fast_apply(model, dtype, device, **act))
        return per_block[0](x_nhwc)

    return apply_fn
