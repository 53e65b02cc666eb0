"""Restormer (Zamir et al., *Restormer: Efficient Transformer for
High-Resolution Image Restoration*, CVPR 2022), written from the published
``basicsr/models/archs/restormer_arch.py`` of swz30/Restormer, with its module
names, so that a state dict of the published model loads as it is.

Defaults are the blind Gaussian colour denoising options
(``Denoising/Options/GaussianColorDenoising_Restormer.yml``): ``dim`` 48,
``num_blocks`` [4, 6, 6, 8], 4 refinement blocks, ``heads`` [1, 2, 4, 8],
``ffn_expansion_factor`` 2.66, no biases, the bias-free LayerNorm; 44
transformer blocks and 26,111,668 parameters.  Over a C-channel map:

* LayerNorm per pixel over C, ``x / sqrt(var_C(x) + 1e-5) · w`` (bias-free:
  the numerator is not centred) or ``(x − mean_C) / sqrt(var_C + 1e-5) · w + b``;
* MDTA (:class:`Attention`): ``q, k, v = chunk3(dw3x3(conv1x1(x, C→3C)))``;
  per head, q and k L2-normalised over the H·W pixels, ``A = softmax_rows(τ ·
  q̂ k̂ᵀ)``, a c×c matrix per image and head; ``conv1x1(A v)``
  (:func:`channel_attention`);
* GDFN (:class:`FeedForward`): ``a, g = chunk2(dw3x3(conv1x1(x, C→2·hidden)))``,
  ``conv1x1(gelu(a) · g)`` with ``hidden = int(C · 2.66)`` (:func:`gated_gelu`);
* a block: ``x += MDTA(LN1(x))``, then ``x += GDFN(LN2(x))``; down
  ``PixelUnshuffle(2)(conv3x3(C→C/2))``, up ``PixelShuffle(2)(conv3x3(C→2C))``;
  a 3-level encoder, a latent, a decoder with skips, refinement blocks and
  ``conv3x3(2·dim→3)`` plus the input image.

:class:`Restormer` is the training and evaluation module: NHWC in [0, 1] in
and out, as the engine passes images (``dropout`` is accepted and ignored:
the network has none).  :func:`serving_forward` is the served forward, the
function ``-p test`` and the benchmark call; see :class:`ServingForward`.
``dual_pixel_task`` (the defocus deblurring variant with a skip conv) is not
ported.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dwconv import (
    depthwise3x3,
    depthwise3x3_gated,
)
from multi_degradation_image_enhancement_tpu_torch.utils.tracing import span

LN_EPS = 1e-5
NORM_EPS = 1e-12  # F.normalize's
LAYER_NORM_TYPES = ("BiasFree", "WithBias")
LEVELS = ("encoder_level1", "encoder_level2", "encoder_level3", "latent",
          "decoder_level3", "decoder_level2", "decoder_level1", "refinement")


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias) -> torch.Tensor:
    """LayerNorm over the channels of NCHW ``x`` in float32 (biased variance
    about the mean); ``bias`` None is the bias-free form, whose numerator is
    not centred.  Float32 out."""
    x = x.float()
    var, mean = torch.var_mean(x, dim=1, keepdim=True, unbiased=False)
    scale = torch.rsqrt(var + LN_EPS)
    if bias is None:
        return x * scale * weight[:, None, None]
    return (x - mean) * scale * weight[:, None, None] + bias[:, None, None]


def gram(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q kᵀ over the last dim, [..., c, n] × [..., c, n] → [..., c, c], in
    float32: the operands' products summed and kept in f32.  Outside
    autograd on CUDA, a bf16 GEMM with an f32 output (``torch.bmm(...,
    out_dtype=torch.float32)``); elsewhere (that op has no CPU kernel, and a
    train step differentiates through the Gram) the product of the operands
    widened to f32, the same sums: bf16 products are exact in f32."""
    if q.is_cuda and q.dtype == torch.bfloat16 and not (q.requires_grad or k.requires_grad):
        lead = q.shape[:-2]
        out = torch.bmm(q.flatten(0, -3), k.flatten(0, -3).transpose(1, 2),
                        out_dtype=torch.float32)
        return out.view(*lead, q.shape[-2], k.shape[-2])
    return torch.matmul(q.float(), k.float().transpose(-2, -1))


def channel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      temperature: torch.Tensor, heads: int) -> torch.Tensor:
    """MDTA's transposed attention: ``softmax_rows(τ · q̂ k̂ᵀ) v`` per image and
    head, q̂ and k̂ L2-normalised over the pixels.  ``q, k, v``: NCHW;
    ``temperature``: [heads, 1, 1].

    The Gram q kᵀ (a c×c matrix summed over all H·W pixels, :func:`gram`)
    takes the operands as they are and keeps its sums in f32; it is divided
    by the f32 norms after, which is ``F.normalize``'s q̂ k̂ᵀ: ``max(‖q_i‖,
    1e-12) · max(‖k_j‖, 1e-12)``.  The logits and the softmax are float32;
    ``A v`` runs in ``v``'s dtype.  (Rounding the Gram to bf16 instead made
    the bf16 forward's gap to the float32 reference 1.1–1.8× the bf16
    reference's at 64×96 on the CPU, against 1.0–1.1× with it kept in f32.)"""
    b, ch, h, w = q.shape
    q, k, v = (t.reshape(b, heads, ch // heads, h * w) for t in (q, k, v))
    qn = torch.linalg.vector_norm(q, dim=-1, keepdim=True, dtype=torch.float32)
    kn = torch.linalg.vector_norm(k, dim=-1, keepdim=True, dtype=torch.float32)
    logits = gram(q, k) / (qn.clamp_min(NORM_EPS) * kn.clamp_min(NORM_EPS).transpose(-2, -1))
    attn = torch.softmax(logits * temperature.float(), dim=-1)
    return torch.matmul(attn.to(v.dtype), v).reshape(b, ch, h, w)


def gated_gelu(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """GDFN's gate: ``gelu(a) · g`` (the exact, erf GELU)."""
    return F.gelu(a) * g


def _conv(c_in: int, c_out: int, k: int, bias: bool, groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, kernel_size=k, padding=k // 2, groups=groups, bias=bias)


class _Body(nn.Module):
    """A LayerNorm's parameters under the published ``.body`` name."""

    def __init__(self, dim: int, with_bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim)) if with_bias else None


class LayerNorm(nn.Module):
    def __init__(self, dim: int, layer_norm_type: str):
        super().__init__()
        if layer_norm_type not in LAYER_NORM_TYPES:
            raise ValueError(f"layer_norm_type must be one of {LAYER_NORM_TYPES}, "
                             f"got {layer_norm_type!r}")
        self.body = _Body(dim, layer_norm_type == "WithBias")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.body.weight, self.body.bias)


class Attention(nn.Module):
    """MDTA."""

    def __init__(self, dim: int, num_heads: int, bias: bool):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = _conv(dim, dim * 3, 1, bias)
        self.qkv_dwconv = _conv(dim * 3, dim * 3, 3, bias, groups=dim * 3)
        self.project_out = _conv(dim, dim, 1, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.qkv_dwconv(self.qkv(x)).chunk(3, dim=1)
        return self.project_out(channel_attention(q, k, v, self.temperature, self.num_heads))


class FeedForward(nn.Module):
    """GDFN."""

    def __init__(self, dim: int, ffn_expansion_factor: float, bias: bool):
        super().__init__()
        hidden = int(dim * ffn_expansion_factor)
        self.project_in = _conv(dim, hidden * 2, 1, bias)
        self.dwconv = _conv(hidden * 2, hidden * 2, 3, bias, groups=hidden * 2)
        self.project_out = _conv(hidden, dim, 1, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, g = self.dwconv(self.project_in(x)).chunk(2, dim=1)
        return self.project_out(gated_gelu(a, g))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, ffn_expansion_factor: float, bias: bool,
                 layer_norm_type: str):
        super().__init__()
        self.norm1 = LayerNorm(dim, layer_norm_type)
        self.attn = Attention(dim, num_heads, bias)
        self.norm2 = LayerNorm(dim, layer_norm_type)
        self.ffn = FeedForward(dim, ffn_expansion_factor, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


class OverlapPatchEmbed(nn.Module):
    def __init__(self, in_c: int, embed_dim: int, bias: bool):
        super().__init__()
        self.proj = _conv(in_c, embed_dim, 3, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class Downsample(nn.Module):
    def __init__(self, n_feat: int):
        super().__init__()
        self.body = nn.Sequential(_conv(n_feat, n_feat // 2, 3, False), nn.PixelUnshuffle(2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x)


class Upsample(nn.Module):
    def __init__(self, n_feat: int):
        super().__init__()
        self.body = nn.Sequential(_conv(n_feat, n_feat * 2, 3, False), nn.PixelShuffle(2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x)


class Restormer(nn.Module):
    """The published network (see the module's docstring); ``forward`` takes
    NHWC images, H and W multiples of 8, and returns NHWC float32."""

    def __init__(self, inp_channels: int = 3, out_channels: int = 3, dim: int = 48,
                 num_blocks: Sequence[int] = (4, 6, 6, 8), num_refinement_blocks: int = 4,
                 heads: Sequence[int] = (1, 2, 4, 8), ffn_expansion_factor: float = 2.66,
                 bias: bool = False, layer_norm_type: str = "BiasFree"):
        super().__init__()

        def level(width: int, n_heads: int, n: int) -> nn.Sequential:
            return nn.Sequential(*[TransformerBlock(width, n_heads, ffn_expansion_factor, bias,
                                                    layer_norm_type) for _ in range(n)])

        self.patch_embed = OverlapPatchEmbed(inp_channels, dim, bias)
        self.encoder_level1 = level(dim, heads[0], num_blocks[0])
        self.down1_2 = Downsample(dim)
        self.encoder_level2 = level(dim * 2, heads[1], num_blocks[1])
        self.down2_3 = Downsample(dim * 2)
        self.encoder_level3 = level(dim * 4, heads[2], num_blocks[2])
        self.down3_4 = Downsample(dim * 4)
        self.latent = level(dim * 8, heads[3], num_blocks[3])
        self.up4_3 = Upsample(dim * 8)
        self.reduce_chan_level3 = _conv(dim * 8, dim * 4, 1, bias)
        self.decoder_level3 = level(dim * 4, heads[2], num_blocks[2])
        self.up3_2 = Upsample(dim * 4)
        self.reduce_chan_level2 = _conv(dim * 4, dim * 2, 1, bias)
        self.decoder_level2 = level(dim * 2, heads[1], num_blocks[1])
        self.up2_1 = Upsample(dim * 2)
        self.decoder_level1 = level(dim * 2, heads[0], num_blocks[0])
        self.refinement = level(dim * 2, heads[0], num_refinement_blocks)
        self.output = _conv(dim * 2, out_channels, 3, bias)

    def forward(self, x_nhwc: torch.Tensor, dropout=None) -> torch.Tensor:
        inp = x_nhwc.permute(0, 3, 1, 2)
        enc1 = self.encoder_level1(self.patch_embed(inp))
        enc2 = self.encoder_level2(self.down1_2(enc1))
        enc3 = self.encoder_level3(self.down2_3(enc2))
        latent = self.latent(self.down3_4(enc3))
        dec3 = self.decoder_level3(self.reduce_chan_level3(
            torch.cat([self.up4_3(latent), enc3], 1)))
        dec2 = self.decoder_level2(self.reduce_chan_level2(
            torch.cat([self.up3_2(dec3), enc2], 1)))
        dec1 = self.decoder_level1(torch.cat([self.up2_1(dec2), enc1], 1))
        out = self.output(self.refinement(dec1)) + inp
        return out.permute(0, 2, 3, 1).float()


class _Block:
    """One block's weights as the served forward reads them."""

    def __init__(self, blk: TransformerBlock, cast):
        self.norm1 = (blk.norm1.body.weight.float(), _opt(blk.norm1.body.bias))
        self.norm2 = (blk.norm2.body.weight.float(), _opt(blk.norm2.body.bias))
        at, ff = blk.attn, blk.ffn
        self.heads, self.temperature = at.num_heads, at.temperature.float()
        self.qkv, self.qkv_dw, self.attn_out = (cast(at.qkv), cast(at.qkv_dwconv),
                                                cast(at.project_out))
        self.ffn_in, self.ffn_dw, self.ffn_out = (cast(ff.project_in), cast(ff.dwconv),
                                                  cast(ff.project_out))


def _opt(t):
    return None if t is None else t.float()


class ServingForward:
    """The served forward of a :class:`Restormer`: NHWC images in [0, 1] in,
    the restored NHWC float32 out, under ``inference_mode``.

    In bf16 the convs and the attention's two products run in bf16 (float32
    accumulation; bf16 out, but for the Gram, whose c×c sums stay float32);
    the residual stream, the LayerNorms' statistics, the attention's L2
    norms, logits and softmax are float32.  In float32 all
    of it is.  The weights are cast once, when it is built.

    The depthwise 3×3 convs run through ``ops.cuda.dwconv`` (one hand-written
    CUDA kernel on the card, its plain version on the CPU): MDTA's as
    :func:`depthwise3x3`, GDFN's with its gate ``gelu(a) · g`` as
    :func:`depthwise3x3_gated`, each sum and the gate in float32, rounded
    once.  The kernel takes NCHW maps, so the forward makes its input NCHW
    in memory first and every map stays so.

    Spans (``utils.tracing``, device ranges on the card): ``serve/forward``
    around a call, ``restormer/mdta`` around each block's LN1 + MDTA +
    residual add and ``restormer/gdfn`` around its LN2 + GDFN + residual
    add, and inside each ``restormer/dwconv`` around its depthwise conv (in
    GDFN with the gate): 177 device ranges a forward.  Counters
    ``mdta_calls`` and ``gdfn_calls`` add one a block, 44 each a forward of
    the published network, on the host (no sync)."""

    def __init__(self, model: Restormer, dtype: torch.dtype, device):
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"serving_forward: dtype must be float32 or bfloat16, got {dtype}")
        self.dtype, self.device = dtype, torch.device(device)
        self.mdta_calls = self.gdfn_calls = 0
        with torch.no_grad():
            model = model.to(self.device)

            def cast(conv: nn.Conv2d):
                b = None if conv.bias is None else conv.bias.detach().to(dtype)
                return conv.weight.detach().to(dtype), b

            self.embed, self.out = cast(model.patch_embed.proj), cast(model.output)
            self.down = [cast(m.body[0]) for m in (model.down1_2, model.down2_3, model.down3_4)]
            self.up = [cast(m.body[0]) for m in (model.up4_3, model.up3_2, model.up2_1)]
            self.reduce = [cast(model.reduce_chan_level3), cast(model.reduce_chan_level2)]
            self.levels = {lv: [_Block(b, cast) for b in getattr(model, lv)] for lv in LEVELS}

    @staticmethod
    def _conv(x: torch.Tensor, conv) -> torch.Tensor:
        w, b = conv  # a dense conv, padded k // 2 as :func:`_conv` builds each
        return F.conv2d(x, w, b, padding=w.shape[-1] // 2)

    def _level(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """The level's blocks over the float32 residual stream ``x``."""
        x = x.float()
        for blk in self.levels[name]:
            with span("restormer/mdta", device=x.device):
                y = self._conv(layer_norm(x, *blk.norm1).to(self.dtype), blk.qkv)
                with span("restormer/dwconv", device=x.device):
                    y = depthwise3x3(y, *blk.qkv_dw)
                q, k, v = y.chunk(3, dim=1)
                a = channel_attention(q, k, v, blk.temperature, blk.heads)
                x = x + self._conv(a, blk.attn_out)
            self.mdta_calls += 1
            with span("restormer/gdfn", device=x.device):
                y = self._conv(layer_norm(x, *blk.norm2).to(self.dtype), blk.ffn_in)
                with span("restormer/dwconv", device=x.device):
                    y = depthwise3x3_gated(y, *blk.ffn_dw)
                x = x + self._conv(y, blk.ffn_out)
            self.gdfn_calls += 1
        return x

    def __call__(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        with span("serve/forward", device=self.device), torch.inference_mode():
            # NCHW in memory, so every map after it is too (a NHWC batch's permute
            # would carry channels_last strides through every conv)
            inp = x_nhwc.permute(0, 3, 1, 2).float().contiguous()
            enc1 = self._level(self._conv(inp.to(dt), self.embed), "encoder_level1")
            enc2 = self._level(self._down(enc1, 0), "encoder_level2")
            enc3 = self._level(self._down(enc2, 1), "encoder_level3")
            latent = self._level(self._down(enc3, 2), "latent")
            dec3 = self._level(self._conv(torch.cat([self._up(latent, 0), enc3.to(dt)], 1),
                                          self.reduce[0]), "decoder_level3")
            dec2 = self._level(self._conv(torch.cat([self._up(dec3, 1), enc2.to(dt)], 1),
                                          self.reduce[1]), "decoder_level2")
            dec1 = self._level(torch.cat([self._up(dec2, 2), enc1.to(dt)], 1), "decoder_level1")
            out = self._conv(self._level(dec1, "refinement").to(dt), self.out).float() + inp
            return out.permute(0, 2, 3, 1).contiguous()

    def _down(self, x: torch.Tensor, i: int) -> torch.Tensor:
        return F.pixel_unshuffle(self._conv(x.to(self.dtype), self.down[i]), 2)

    def _up(self, x: torch.Tensor, i: int) -> torch.Tensor:
        return F.pixel_shuffle(self._conv(x.to(self.dtype), self.up[i]), 2)


def serving_forward(model: Restormer, dtype=torch.bfloat16, device="cuda") -> ServingForward:
    """``model``'s served forward in ``dtype`` on ``device`` (see
    :class:`ServingForward`): the callable ``-p test`` scores through on the
    card and the benchmark times."""
    return ServingForward(model, dtype, device)
