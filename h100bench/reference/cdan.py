"""CDAN (growth 16, 4 layers per DenseBlock, CBAM) as plain functions of a
weight dict keyed by the published module names (``encoder.conv1.conv.weight``,
``encoder.dense1.layers.0.2.weight``, ``bottleneck.ChannelGate.mlp.1.weight``,
``decoder.conv1.weight``, ...).  NHWC images in [0, 1] in and out, NCHW inside.

The equations are those of the published model: ConvBlocks conv → BN → ReLU,
a 2×2 max-pool after the first three, a DenseBlock on each pooled scale,
dropout 0.2 at four encoder sites (train mode), the CBAM bottleneck, the
decoder's ``ConvTranspose2d(k3, s1, p1)`` + BN + ReLU per scale with an
additive skip, CBAM, a multiplicative DenseBlock gate and a ×2 bilinear
upsample (half-pixel), then the global residual, the final DenseBlock(3) and a
sigmoid.

BatchNorm in train mode follows the recipe the models were trained with
(the Flax semantics of the JAX package): biased batch variance, running
averages ``(1 − m)·running + m·batch`` with the biased variance, m = 0.1
(0.01 in CBAM's spatial gate).  That is the one departure from
``torch.nn.BatchNorm2d``, which keeps the unbiased variance.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

DROP_RATE = 0.2


def _fp8(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` rounded through the float8 ``dtype`` with a per-tensor scale
    (amax ↦ the format's largest finite value)."""
    scale = t.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (t / scale).to(dtype).to(t.dtype) * scale


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


# quant → (forward operand rounding, backward gradient rounding)
ROUNDINGS = {
    "fp8": (lambda t: _fp8(t, torch.float8_e4m3fn), lambda g: _fp8(g, torch.float8_e5m2)),
    "bf16": (_bf16, _bf16),
}


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the incoming gradient rounded by ``fn``."""

    @staticmethod
    def forward(ctx, t, fn):
        ctx.fn = fn
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.fn(grad), None


class RefCDAN:
    """``params``: the learnable tensors by name; ``buffers``: the BatchNorm
    running statistics by name, updated in place in train mode.
    ``quant``: None (float32); ``"fp8"`` (the control); ``"bf16"`` (a
    witness in the program's precision: operands and gradients of every
    conv and linear rounded to bf16, as a bf16 autocast computes them)."""

    def __init__(self, params: Dict[str, torch.Tensor], buffers: Dict[str, torch.Tensor],
                 quant: Optional[str] = None):
        if quant is not None and quant not in ROUNDINGS:
            raise ValueError(f"quant must be None or one of {sorted(ROUNDINGS)}, got {quant!r}")
        self.p, self.b, self.quant = params, buffers, quant
        self.training = False
        self.calibrating = False  # train-mode statistics become the running ones

    # ------------------------------------------------------------ operators

    def _q(self, t: torch.Tensor) -> torch.Tensor:
        """A forward operand rounded (the gradient passes straight through)."""
        if self.quant is None:
            return t
        return t + (ROUNDINGS[self.quant][0](t.detach()) - t.detach())

    def _qg(self, out: torch.Tensor) -> torch.Tensor:
        """The gradient reaching ``out`` rounded in the backward."""
        return out if self.quant is None else _RoundGrad.apply(out, ROUNDINGS[self.quant][1])

    def conv(self, x, name: str, padding: int):
        return self._qg(F.conv2d(self._q(x), self._q(self.p[name + ".weight"]),
                                 self.p.get(name + ".bias"), padding=padding))

    def deconv(self, x, name: str):
        return self._qg(F.conv_transpose2d(self._q(x), self._q(self.p[name + ".weight"]),
                                           self.p[name + ".bias"], padding=1))

    def linear(self, x, name: str):
        return self._qg(F.linear(self._q(x), self._q(self.p[name + ".weight"]),
                                 self.p[name + ".bias"]))

    def bn(self, x, name: str, momentum: float = 0.1, eps: float = 1e-5):
        if self.training:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            m = 1.0 if self.calibrating else momentum
            with torch.no_grad():
                for key, batch in (("running_mean", mean), ("running_var", var)):
                    run = self.b[f"{name}.{key}"]
                    run.mul_(1.0 - m).add_(m * batch.detach())
        else:
            mean, var = self.b[name + ".running_mean"], self.b[name + ".running_var"]
        scale = self.p[name + ".weight"] * torch.rsqrt(var + eps)
        return (x - mean[None, :, None, None]) * scale[None, :, None, None] + \
            self.p[name + ".bias"][None, :, None, None]

    @staticmethod
    def up2(x):
        return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)

    # --------------------------------------------------------------- blocks

    def dense(self, x, name: str, layers: int = 4):
        feats = x
        for j in range(layers):
            pre = f"{name}.layers.{j}"
            g = self.conv(torch.relu(self.bn(feats, pre + ".0")), pre + ".2", 1)
            feats = torch.cat([feats, g], dim=1)
        h = torch.relu(self.bn(feats, name + ".transition_layer.0"))
        return self.conv(h, name + ".transition_layer.2", 0)

    def cbam(self, x, name: str):
        def mlp(v):
            return self.linear(torch.relu(self.linear(v, name + ".ChannelGate.mlp.1")),
                               name + ".ChannelGate.mlp.3")

        x = x * torch.sigmoid(mlp(x.mean(dim=(2, 3))) + mlp(x.amax(dim=(2, 3))))[:, :, None, None]
        comp = torch.cat([x.amax(dim=1, keepdim=True), x.mean(dim=1, keepdim=True)], dim=1)
        sp = name + ".SpatialGate.spatial"
        s = self.bn(self.conv(comp, sp + ".conv", 3), sp + ".bn", momentum=0.01)
        return x * torch.sigmoid(s)

    def conv_block(self, x, i: int):
        pre = f"encoder.conv{i}"
        return torch.relu(self.bn(self.conv(x, pre + ".conv", 1), pre + ".bn"))

    def deconv_block(self, x, i: int):
        return torch.relu(self.bn(self.deconv(x, f"decoder.conv{i}"), f"decoder.bn{i}"))

    def _drop(self, x, keep: Optional[torch.Tensor]):
        if not self.training or self.calibrating:
            return x
        return torch.where(keep, x / (1.0 - DROP_RATE), torch.zeros((), dtype=x.dtype,
                                                                    device=x.device))

    # -------------------------------------------------------------- forward

    def trunk(self, x_nhwc, masks: Optional[Sequence[torch.Tensor]] = None):
        """(NCHW input, the decoder's last upsampled branch before the global
        residual); ``masks``: the four dropout keep masks in train mode."""
        if self.training and (masks is None or len(masks) != 4):
            raise ValueError("train mode needs the four dropout keep masks")
        masks = masks if self.training else (None,) * 4
        x = x_nhwc.permute(0, 3, 1, 2)
        out, skips, denses = x, [], []
        for i in range(1, 4):
            out = F.max_pool2d(self.conv_block(out, i), 2)
            denses.append(self.dense(out, f"encoder.dense{i}"))
            out = self._drop(out, masks[i - 1])
            skips.append(out)
        out = self._drop(self.conv_block(out, 4), masks[3])
        out = self.cbam(out, "bottleneck")
        out = self.cbam(self.deconv_block(out, 1) + skips[2], "decoder.cbam1") * denses[2]
        out = self.cbam(self.up2(self.deconv_block(out, 2)) + skips[1], "decoder.cbam2") * denses[1]
        out = self.cbam(self.up2(self.deconv_block(out, 3)) + skips[0], "decoder.cbam3") * denses[0]
        return x, self.up2(self.deconv_block(out, 4))

    def forward(self, x_nhwc, masks: Optional[Sequence[torch.Tensor]] = None):
        x, branch = self.trunk(x_nhwc, masks)
        out = torch.sigmoid(self.dense(branch + x, "decoder.final_dense"))
        return out.permute(0, 2, 3, 1)

    __call__ = forward

    @torch.no_grad()
    def with_skip(self, x_nhwc):
        """Eval mode, NHWC: (the output, the output with the decoder's
        branch removed: the input alone through the final DenseBlock and the
        sigmoid)."""
        x, branch = self.trunk(x_nhwc)
        out = torch.sigmoid(self.dense(branch + x, "decoder.final_dense"))
        skip = torch.sigmoid(self.dense(x, "decoder.final_dense"))
        return out.permute(0, 2, 3, 1), skip.permute(0, 2, 3, 1)

    @torch.no_grad()
    def calibrate(self, x_nhwc) -> None:
        """Set every running statistic to its train-mode batch statistic on
        ``x_nhwc`` (no dropout), as a trained network's statistics match its
        activations: eval BatchNorm then normalises, and the decoder's ReLUs
        stay open."""
        self.training, self.calibrating = True, True
        try:
            x, branch = self.trunk(x_nhwc, [None] * 4)
            self.dense(branch + x, "decoder.final_dense")
        finally:
            self.training, self.calibrating = False, False

    @torch.no_grad()
    def network_share(self, x_nhwc) -> float:
        """Eval mode: the share of the output's variance that the network
        carries, var(out − out_skip) / var(out), where ``out_skip`` is the
        output with the decoder's branch removed (the input alone through the
        final DenseBlock and the sigmoid).  Near 0 where closed ReLUs leave
        only the global residual."""
        out, skip = self.with_skip(x_nhwc)
        return float((out - skip).var() / out.var().clamp(min=1e-30))


def cdan_shapes(growth: int = 16, layers: int = 4) -> Dict[str, tuple]:
    """Every tensor of the published CDAN by name, with its shape, in the
    published module order (``num_batches_tracked`` left out)."""
    shapes: Dict[str, tuple] = {}

    def conv(name, c_in, c_out, k, bias=True):
        shapes[name + ".weight"] = (c_out, c_in, k, k)
        if bias:
            shapes[name + ".bias"] = (c_out,)

    def bn(name, c):
        for key in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{name}.{key}"] = (c,)

    def dense(name, c):
        for j in range(layers):
            bn(f"{name}.layers.{j}.0", c + growth * j)
            conv(f"{name}.layers.{j}.2", c + growth * j, growth, 3)
        bn(f"{name}.transition_layer.0", c + growth * layers)
        conv(f"{name}.transition_layer.2", c + growth * layers, c, 1)

    def cbam(name, c):
        shapes[name + ".ChannelGate.mlp.1.weight"] = (c // 16, c)
        shapes[name + ".ChannelGate.mlp.1.bias"] = (c // 16,)
        shapes[name + ".ChannelGate.mlp.3.weight"] = (c, c // 16)
        shapes[name + ".ChannelGate.mlp.3.bias"] = (c,)
        conv(name + ".SpatialGate.spatial.conv", 2, 1, 7, bias=False)
        bn(name + ".SpatialGate.spatial.bn", 1)

    for i, (c_in, c_out) in enumerate(((3, 64), (64, 128), (128, 256), (256, 512)), 1):
        conv(f"encoder.conv{i}.conv", c_in, c_out, 3)
        bn(f"encoder.conv{i}.bn", c_out)
    for i, c in enumerate((64, 128, 256), 1):
        dense(f"encoder.dense{i}", c)
    cbam("bottleneck", 512)
    for i, (c_in, c_out) in enumerate(((512, 256), (256, 128), (128, 64), (64, 3)), 1):
        shapes[f"decoder.conv{i}.weight"] = (c_in, c_out, 3, 3)  # ConvTranspose2d: [in, out]
        shapes[f"decoder.conv{i}.bias"] = (c_out,)
        bn(f"decoder.bn{i}", c_out)
    for i, c in enumerate((256, 128, 64), 1):
        cbam(f"decoder.cbam{i}", c)
    dense("decoder.final_dense", 3)
    return shapes


def split_state(state: Dict[str, torch.Tensor]):
    """A state dict by published names → (params, running statistics); the
    step counters (``num_batches_tracked``) are left out."""
    params, buffers = {}, {}
    for k, v in state.items():
        if k.endswith(("running_mean", "running_var")):
            buffers[k] = v
        elif not k.endswith("num_batches_tracked"):
            params[k] = v
    return params, buffers
