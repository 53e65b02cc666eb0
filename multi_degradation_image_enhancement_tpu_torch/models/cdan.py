"""CDAN restoration network, NCHW inside: eval, train and BN-refresh modes.

Counterpart of ``multi_degradation_image_enhancement_tpu/models/cdan.py`` with
the reference's module names (``encoder.conv1.conv``, ``encoder.dense1.layers.0``,
``decoder.conv1``, ``bottleneck.ChannelGate.mlp.1``, …), so a reference
``CDAN_<task>.pt`` state_dict loads natively and JAX weights cross over through
``utils.jax_port``.  3,585,663 parameters at growth 16.

The public forward keeps the JAX package's layout: NHWC ``[B, H, W, 3]`` in
[0, 1] in, the same shape out (f32); H and W multiples of 8.

The decoder keeps the reference's ``ConvTranspose2d(k3, s1, p1)`` layers (the
JAX package runs them as spatially flipped 3×3 convs).

Modes (the JAX package's ``train`` / ``stats_refresh`` flags):

* ``model.eval()``: BatchNorm on running statistics, no dropout;
* ``model.train()``: BatchNorm on batch statistics with Flax semantics (see
  :class:`BatchNorm2d`), Dropout(0.2) at the four encoder sites;
* ``model.eval(); model.stats_refresh = True``: batch-statistics BatchNorm
  updating the running averages, no dropout (``bn_recalibration``).

``model.fused_dense = True`` routes every DenseBlock with growth 16 through
the trainable growth-layer kernel (``ops.cuda.growth_train``) with
incremental batch statistics, as ``DenseBlock._fused_impl`` does in the JAX
package; the variable tree is the same either way.  Compute precision follows
``torch.autocast`` (convs, linears and the transition product in bf16 under a
bf16 autocast), while every BatchNorm in train or refresh mode runs in f32.

Under a mesh (``parallel.mesh.shard_train_step``) the same modules run on
a rank's shard: BatchNorm is sync-BN (``models.norm.channel_stats``), and
with a ``spatial`` axis the convs, deconvs and upsamples exchange halo rows
(``models.halo``), CBAM pools over the whole image, the growth layers take
halo rows of their raw input (``growth_layer_sharded``) and dropout keeps
its slice of the global mask.

``model.remat = True`` (``train.remat``) rematerialises every ConvBlock,
DenseBlock (``final_dense`` included) and CBAM (the bottleneck included),
the set the JAX package wraps in ``nn.checkpoint`` (``cdan.py:249-263``):
each block's internals are computed again in the backward instead of being
kept (``models.norm.Rematerialized``).  The decoder's deconv + BN + ReLU and
the dropout between blocks stay outside, as there.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch
from torch import nn

from multi_degradation_image_enhancement_tpu_torch.models.cbam import CBAM
from multi_degradation_image_enhancement_tpu_torch.models.halo import (
    bilinear_x2,
    check_local_height,
    conv_same,
    conv_transpose_same,
)
from multi_degradation_image_enhancement_tpu_torch.models.norm import (
    BatchNorm2d,
    Rematerialized,
    channel_stats,
)
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.growth_train import (
    growth_layer,
    growth_layer_sharded,
)
from multi_degradation_image_enhancement_tpu_torch.parallel import collectives

DROP_RATE = 0.2
# A dropout source: None (the global RNG), a torch.Generator on the
# activations' device, or the four keep masks (bool, NCHW) in encoder order.
Dropout = Union[None, torch.Generator, Sequence[torch.Tensor]]


def dropout_keep_mask(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """A Bernoulli(0.8) keep mask (``flax.linen.Dropout``'s ``uniform < keep``)."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - DROP_RATE


def apply_dropout(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``where(keep, x / 0.8, 0)``, Flax's inverted dropout."""
    return torch.where(keep, x / (1.0 - DROP_RATE), torch.zeros((), dtype=x.dtype, device=x.device))


class ConvBlock(Rematerialized):
    """Conv 3×3 → BN → ReLU (reference ``models/cdan.py:8-19``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.bn = BatchNorm2d(out_channels)

    def block_forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(conv_same(self.conv, x)))


class DenseBlock(Rematerialized):
    """4 × (BN → ReLU → 3×3 conv to ``growth_rate``, concat), then
    BN → ReLU → 1×1 transition back to ``in_channels`` (reference
    ``models/cdan.py:22-53``).

    ``fused`` (growth 16 only, as ``cdan.py:142`` of the JAX package): the
    growth layers run through ``growth_fn`` (the kernel's
    ``ops.cuda.growth_train.growth_layer``) on f32 features, with BN as a
    per-channel affine of incremental batch statistics (each layer measures
    only its 16 new channels) and autograd through the statistics; the
    transition is an f32 affine + ReLU, then a 1×1 product in the compute
    dtype (``cdan.py:172-246``).
    """

    num_layers = 4

    def __init__(self, in_channels: int, growth_rate: int = 16):
        super().__init__()
        self.in_channels = in_channels
        self.growth_rate = growth_rate
        self.fused = False
        self.stats_refresh = False
        self.growth_fn = growth_layer
        self.layers = nn.ModuleList()
        c = in_channels
        for _ in range(self.num_layers):
            self.layers.append(
                nn.Sequential(BatchNorm2d(c), nn.ReLU(), nn.Conv2d(c, growth_rate, 3, padding=1))
            )
            c += growth_rate
        self.transition_layer = nn.Sequential(
            BatchNorm2d(c), nn.ReLU(), nn.Conv2d(c, in_channels, 1)
        )

    def block_forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused and self.growth_rate == 16:
            return self._fused_forward(x)
        feats = x
        for bn, relu, conv in self.layers:
            feats = torch.cat([feats, conv_same(conv, relu(bn(feats)))], dim=1)
        return self.transition_layer(feats)

    def _affine(self, bn: BatchNorm2d, mus, variances, norm: bool):
        """BN as ``(a, b)``; in train/refresh mode from the batch statistics,
        whose running averages it updates."""
        if norm:
            mean, var = torch.cat(mus), torch.cat(variances)
            bn.update_running(mean, var)
        else:
            mean, var = bn.running_mean, bn.running_var
        a = bn.weight * torch.rsqrt(var + bn.eps)
        return a, bn.bias - mean * a

    def _fused_forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = self.training or self.stats_refresh
        feats = x.float()
        mus, variances = [], []
        if norm:
            mu, var = channel_stats(feats)
            mus.append(mu)
            variances.append(var)
        for layer in self.layers:
            bn, conv = layer[0], layer[2]
            a, b = self._affine(bn, mus, variances, norm)
            g = growth_layer_sharded(self.growth_fn, feats, a, b, conv.weight, conv.bias)
            if norm:
                mu, var = channel_stats(g)
                mus.append(mu)
                variances.append(var)
            feats = torch.cat([feats, g], dim=1)
        bn, conv = self.transition_layer[0], self.transition_layer[2]
        a, b = self._affine(bn, mus, variances, norm)
        vt = torch.relu(feats * a[None, :, None, None] + b[None, :, None, None])
        out = torch.einsum("oc,bchw->bohw", conv.weight[:, :, 0, 0], vt)
        return out + conv.bias.to(out.dtype)[None, :, None, None]


class Encoder(nn.Module):
    """Reference ``models/cdan.py:55-98``: ConvBlocks 3→64→128→256→512, a 2×2
    max-pool after the first three, a DenseBlock gate per scale computed on the
    pooled features, Dropout(0.2) at four places (train mode only)."""

    def __init__(self, growth_rate: int = 16):
        super().__init__()
        self.conv1 = ConvBlock(3, 64)
        self.conv2 = ConvBlock(64, 128)
        self.conv3 = ConvBlock(128, 256)
        self.conv4 = ConvBlock(256, 512)
        self.dense1 = DenseBlock(64, growth_rate)
        self.dense2 = DenseBlock(128, growth_rate)
        self.dense3 = DenseBlock(256, growth_rate)
        self.pool = nn.MaxPool2d(2, 2)

    def _drop(self, x: torch.Tensor, i: int, dropout: Dropout) -> torch.Tensor:
        """Under a mesh the keep mask is drawn (or given) at the global
        batch's shape and each rank keeps its slice: the masks of a sharded
        step are the single-device step's, bit for bit."""
        if not self.training:
            return x
        if dropout is None or isinstance(dropout, torch.Generator):
            keep = dropout_keep_mask(collectives.global_shape(x.shape, 2), dropout, x.device)
        else:
            keep = dropout[i]
        return apply_dropout(x, collectives.local_slice(keep, 2))

    def forward(self, x: torch.Tensor, dropout: Dropout = None):
        skips, denses = [], []
        out = x
        for i, (conv, dense) in enumerate(((self.conv1, self.dense1), (self.conv2, self.dense2),
                                           (self.conv3, self.dense3))):
            out = self.pool(conv(out))
            denses.append(dense(out))
            out = self._drop(out, i, dropout)
            skips.append(out)
        out = self._drop(self.conv4(out), 3, dropout)
        return out, skips, denses


class Decoder(nn.Module):
    """Reference ``models/cdan.py:100-159``: per scale a deconv + BN + ReLU,
    additive skip, CBAM, multiplicative dense gate, bilinear ×2; then the global
    residual, the final DenseBlock(3) and a sigmoid.  ``conv4`` (3 outputs)
    keeps its ReLU."""

    def __init__(self, growth_rate: int = 16):
        super().__init__()
        widths = [(512, 256), (256, 128), (128, 64), (64, 3)]
        for i, (cin, cout) in enumerate(widths, 1):
            setattr(self, f"conv{i}", nn.ConvTranspose2d(cin, cout, 3, stride=1, padding=1))
            setattr(self, f"bn{i}", BatchNorm2d(cout))
        self.cbam1 = CBAM(256)
        self.cbam2 = CBAM(128)
        self.cbam3 = CBAM(64)
        self.final_dense = DenseBlock(3, growth_rate)

    def _deconv(self, x: torch.Tensor, i: int) -> torch.Tensor:
        return torch.relu(getattr(self, f"bn{i}")(conv_transpose_same(getattr(self, f"conv{i}"), x)))

    def forward(self, x, out, skips, denses):
        out = self.cbam1(self._deconv(out, 1) + skips[2])
        out = out * denses[2]
        out = self.cbam2(bilinear_x2(self._deconv(out, 2)) + skips[1])
        out = out * denses[1]
        out = self.cbam3(bilinear_x2(self._deconv(out, 3)) + skips[0])
        out = out * denses[0]
        out = bilinear_x2(self._deconv(out, 4)) + x  # global residual
        return torch.sigmoid(self.final_dense(out))


class CDAN(nn.Module):
    """CDAN encoder–decoder with CBAM attention (reference ``models/cdan.py:164-176``)."""

    def __init__(self, growth_rate: int = 16):
        super().__init__()
        self.encoder = Encoder(growth_rate)
        self.bottleneck = CBAM(512)
        self.decoder = Decoder(growth_rate)

    def dense_blocks(self):
        return [m for m in self.modules() if isinstance(m, DenseBlock)]

    @property
    def fused_dense(self) -> bool:
        return all(block.fused for block in self.dense_blocks())

    @fused_dense.setter
    def fused_dense(self, value: bool) -> None:
        for block in self.dense_blocks():
            block.fused = bool(value)

    @property
    def remat(self) -> bool:
        blocks = [m for m in self.modules() if isinstance(m, Rematerialized)]
        return all(block.remat for block in blocks)

    @remat.setter
    def remat(self, value: bool) -> None:
        for m in self.modules():
            if isinstance(m, Rematerialized):
                m.remat = bool(value)

    @property
    def stats_refresh(self) -> bool:
        return all(block.stats_refresh for block in self.dense_blocks())

    @stats_refresh.setter
    def stats_refresh(self, value: bool) -> None:
        for m in self.modules():
            if isinstance(m, (DenseBlock, BatchNorm2d)):
                m.stats_refresh = bool(value)

    def forward(self, x_nhwc: torch.Tensor, dropout: Dropout = None) -> torch.Tensor:
        """``dropout`` is read in train mode only (see :data:`Dropout`).
        Under a mesh's ``spatial`` axis ``x_nhwc`` is this rank's H shard."""
        check_local_height(x_nhwc.shape[1])
        x = x_nhwc.permute(0, 3, 1, 2)
        out, skips, denses = self.encoder(x, dropout)
        out = self.bottleneck(out)
        out = self.decoder(x, out, skips, denses)
        return out.permute(0, 2, 3, 1).float()


def eval_forward(model: nn.Module, dtype: torch.dtype) -> Callable[[torch.Tensor], torch.Tensor]:
    """``model`` (in eval mode, on its device) as an inference forward in
    ``dtype``: under a bf16 autocast on the input's device for bf16, plainly
    for f32.  The counterpart of ``CDAN(dtype).apply(v, x, train=False)``
    with every DenseBlock unfused, the route of the JAX pipeline
    (``pipeline.py:125-126``) and of the evaluation engine with
    ``fused_kernels: false``, which both use this helper.

    Under the autocast the convolutions, transposed convolutions and linears
    run in bf16.  Eval BatchNorm is ``torch.nn.BatchNorm2d``'s: it takes the
    bf16 activations as they come and returns bf16, normalising in f32 with
    one rounding.  The JAX module runs eval BatchNorm in the compute dtype
    (``dtype=jnp.float32 if norm else self.dtype``, ``models/cdan.py:64,
    156,166,340``), i.e. in bf16 arithmetic; the port keeps PyTorch's kernel
    (an emulation of bf16 arithmetic would cost extra passes), so the two
    differ by bf16 rounding only.  Where BatchNorm's input is f32
    (``final_dense``, after the f32 global residual) the port's output stays
    f32 and the conv after it rounds it to bf16, where JAX rounds at the
    BatchNorm."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"eval_forward: dtype must be float32 or bfloat16, got {dtype}")
    bf16 = dtype == torch.bfloat16

    @torch.no_grad()
    def forward(x: torch.Tensor) -> torch.Tensor:
        with torch.autocast(x.device.type, dtype=torch.bfloat16, enabled=bf16):
            return model(x)

    return forward


@torch.no_grad()
def init_cdan(generator: torch.Generator) -> CDAN:
    """A CDAN in eval mode with seeded weights and random BN statistics.

    Weights take PyTorch's default init under a seed drawn from ``generator``
    (the global RNG state is restored after); every BatchNorm's running mean
    and variance are drawn U(0.5, 1.5) from ``generator`` so every BN fold is
    exercised.  Stands in for trained weights, which the repo does not ship.
    """
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = CDAN()
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.running_mean.uniform_(0.5, 1.5, generator=generator)
            m.running_var.uniform_(0.5, 1.5, generator=generator)
    return model.eval()
