"""Weight initialisation of a training run (counterpart of
``multi_degradation_image_enhancement_tpu/models/torch_init.py`` and of the
Flax defaults the JAX engine draws, ``engine/model.py:319-335``).

:func:`flax_default_init_` draws Flax's defaults, the JAX engine's init
unless ``train.torch_init`` is set: every ``Conv2d``, ``ConvTranspose2d`` and
``Linear`` kernel LeCun-normal (``variance_scaling(1, "fan_in",
"truncated_normal")``: truncated at ±2σ with σ = √(1/fan_in) / 0.8796…, so
the drawn values have variance 1/fan_in), biases 0, BatchNorm scale 1,
bias 0 and running statistics 0/1.  fan_in is the JAX kernel's: kh·kw·c_in
for a conv (c_in per group, ``in_channels / groups``, as Flax's grouped
kernel holds it: a depthwise 3×3 conv's fan_in is 9), ``in_features`` for a
linear; the decoder's ``ConvTranspose2d`` layers run in the JAX package as
flipped convs reading ``in_channels`` (``models/cdan.py:312-338``), so their
fan_in is 9·``in_channels``.

:func:`torch_reinit_` (``train.torch_init: true``) is PyTorch's own
``reset_parameters`` of each conv and linear, the statistics the JAX
``torch_reinit`` re-draws: U(±1/√fan_in) for kernels and biases, with
PyTorch's ``ConvTranspose2d`` fan (9·``out_channels``, the quirk the JAX
module reproduces).  BatchNorm is left as constructed (1, 0; statistics 0/1).

Both draw from an explicit CPU generator, so the weights do not depend on the
device or on the global RNG.  The draws are PyTorch's, not threefry's: the two
packages agree in distribution, not bit for bit.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# Flax's truncated_normal variance correction: the std of N(0, 1) cut at ±2.
TRUNCATED_STD = 0.87962566103423978
_LAYERS = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)


def flax_lecun_std(layer: nn.Module) -> float:
    """σ of Flax's ``lecun_normal`` for ``layer`` (values cut at ±2σ), from
    the fan_in of the JAX kernel it stands for."""
    if isinstance(layer, nn.Linear):
        fan_in = layer.in_features
    else:
        fan_in = layer.kernel_size[0] * layer.kernel_size[1] * layer.in_channels // layer.groups
    return math.sqrt(1.0 / fan_in) / TRUNCATED_STD


@torch.no_grad()
def flax_default_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Flax's default initialisation of ``model``, in place; returns it."""
    for m in model.modules():
        if isinstance(m, _LAYERS):
            std = flax_lecun_std(m)
            w = torch.empty(m.weight.shape, dtype=torch.float32)
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
    return model


@torch.no_grad()
def torch_reinit_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """PyTorch's default initialisation of every conv and linear of
    ``model``, in place, under a seed drawn from ``generator`` (the global RNG
    state is restored after); returns it."""
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        for m in model.modules():
            if isinstance(m, _LAYERS):
                m.reset_parameters()
    return model
