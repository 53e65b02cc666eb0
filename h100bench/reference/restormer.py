"""Restormer as plain functions of a weight dict keyed by the published
module names (``patch_embed.proj.weight``, ``encoder_level1.0.norm1.body.weight``,
``encoder_level1.0.attn.temperature``, ``latent.7.ffn.dwconv.weight``,
``up2_1.body.0.weight``, ``output.weight``, ...).  NHWC images in and out,
NCHW inside, float32.

It follows ``basicsr/models/archs/restormer_arch.py`` of swz30/Restormer
line for line: the bias-free LayerNorm ``x / sqrt(var + 1e-5) · w`` (biased
variance, numerator not centred) or the with-bias one, over the channels of
each pixel; MDTA with ``F.normalize`` over the pixels, ``(q̂ @ k̂ᵀ) ·
temperature``, a row softmax and ``@ v``; GDFN ``gelu(x1) · x2``; the
3-level encoder, the latent, the decoder with its skips and channel
reductions, the refinement blocks and the output conv plus the input.  The
architecture is read from the weights themselves (widths, blocks a level,
heads from each temperature's shape, the LayerNorm type from the presence
of its bias).  Departures: ``to_3d`` / ``to_4d`` (rearranges to [B, HW, C]
and back around each LayerNorm) are a reduction over dim 1 instead, the
same arithmetic; ``dual_pixel_task`` is not written (the published options
set it false).

``quant``: as ``reference/cdan.py``, ``"bf16"`` (the witness: the operands
of every conv and of both attention products rounded to bf16) or ``"fp8"``
(the control: the same operands in float8 e4m3 with a per-tensor scale).
``fault``: a planted fault in the reference's own arithmetic, for the
control's stand-ins: ``"attention_transposed"`` (softmax of τ · k̂ q̂ᵀ) or
``"gate_swapped"`` (gelu on the gate's second half, not its first).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from h100bench.reference.cdan import ROUNDINGS

FAULTS = ("attention_transposed", "gate_swapped")
LN_EPS = 1e-5


def restormer_shapes(dim: int = 48, num_blocks=(4, 6, 6, 8), num_refinement_blocks: int = 4,
                     heads=(1, 2, 4, 8), ffn_expansion_factor: float = 2.66, bias: bool = False,
                     layer_norm_type: str = "BiasFree", inp_channels: int = 3,
                     out_channels: int = 3) -> Dict[str, tuple]:
    """Every tensor of the published Restormer by name, with its shape, in
    the published module order."""
    shapes: Dict[str, tuple] = {}

    def conv(name, c_in, c_out, k, groups=1, with_bias=bias):
        shapes[name + ".weight"] = (c_out, c_in // groups, k, k)
        if with_bias:
            shapes[name + ".bias"] = (c_out,)

    def norm(name, c):
        shapes[name + ".body.weight"] = (c,)
        if layer_norm_type == "WithBias":
            shapes[name + ".body.bias"] = (c,)

    def block(name, c, h):
        hidden = int(c * ffn_expansion_factor)
        norm(name + ".norm1", c)
        shapes[f"{name}.attn.temperature"] = (h, 1, 1)
        conv(f"{name}.attn.qkv", c, 3 * c, 1)
        conv(f"{name}.attn.qkv_dwconv", 3 * c, 3 * c, 3, groups=3 * c)
        conv(f"{name}.attn.project_out", c, c, 1)
        norm(name + ".norm2", c)
        conv(f"{name}.ffn.project_in", c, 2 * hidden, 1)
        conv(f"{name}.ffn.dwconv", 2 * hidden, 2 * hidden, 3, groups=2 * hidden)
        conv(f"{name}.ffn.project_out", hidden, c, 1)

    def level(name, c, h, n):
        for i in range(n):
            block(f"{name}.{i}", c, h)

    conv("patch_embed.proj", inp_channels, dim, 3)
    level("encoder_level1", dim, heads[0], num_blocks[0])
    conv("down1_2.body.0", dim, dim // 2, 3, with_bias=False)
    level("encoder_level2", dim * 2, heads[1], num_blocks[1])
    conv("down2_3.body.0", dim * 2, dim, 3, with_bias=False)
    level("encoder_level3", dim * 4, heads[2], num_blocks[2])
    conv("down3_4.body.0", dim * 4, dim * 2, 3, with_bias=False)
    level("latent", dim * 8, heads[3], num_blocks[3])
    conv("up4_3.body.0", dim * 8, dim * 16, 3, with_bias=False)
    conv("reduce_chan_level3", dim * 8, dim * 4, 1)
    level("decoder_level3", dim * 4, heads[2], num_blocks[2])
    conv("up3_2.body.0", dim * 4, dim * 8, 3, with_bias=False)
    conv("reduce_chan_level2", dim * 4, dim * 2, 1)
    level("decoder_level2", dim * 2, heads[1], num_blocks[1])
    conv("up2_1.body.0", dim * 2, dim * 4, 3, with_bias=False)
    level("decoder_level1", dim * 2, heads[0], num_blocks[0])
    level("refinement", dim * 2, heads[0], num_refinement_blocks)
    conv("output", dim * 2, out_channels, 3)
    return shapes


class RefRestormer:
    """``params``: the tensors by published name.  ``quant``: None (float32),
    ``"bf16"`` (the witness) or ``"fp8"`` (the control).  ``fault``: None or
    one of :data:`FAULTS`."""

    def __init__(self, params: Dict[str, torch.Tensor], quant: Optional[str] = None,
                 fault: Optional[str] = None):
        if quant is not None and quant not in ROUNDINGS:
            raise ValueError(f"quant must be None or one of {sorted(ROUNDINGS)}, got {quant!r}")
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"fault must be None or one of {FAULTS}, got {fault!r}")
        self.p, self.quant, self.fault = params, quant, fault
        self.entropies: Optional[List[float]] = None  # a list while :meth:`probe` runs

    def _q(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.quant is None else ROUNDINGS[self.quant][0](t)

    def conv(self, x, name: str):
        w = self.p[name + ".weight"]
        groups = x.shape[1] // w.shape[1]
        return F.conv2d(self._q(x), self._q(w), self.p.get(name + ".bias"),
                        padding=w.shape[-1] // 2, groups=groups)

    def norm(self, x, name: str):
        w, b = self.p[name + ".body.weight"], self.p.get(name + ".body.bias")
        var, mu = torch.var_mean(x, dim=1, keepdim=True, unbiased=False)
        if b is None:
            return x / torch.sqrt(var + LN_EPS) * w[:, None, None]
        return (x - mu) / torch.sqrt(var + LN_EPS) * w[:, None, None] + b[:, None, None]

    def attention(self, x, name: str):
        temperature = self.p[name + ".temperature"]
        heads = temperature.shape[0]
        b, c, h, w = x.shape
        q, k, v = self.conv(self.conv(x, name + ".qkv"), name + ".qkv_dwconv").chunk(3, dim=1)
        q, k, v = (t.reshape(b, heads, c // heads, h * w) for t in (q, k, v))
        q, k = F.normalize(q, dim=-1), F.normalize(k, dim=-1)
        if self.fault == "attention_transposed":
            q, k = k, q
        attn = (self._q(q) @ self._q(k).transpose(-2, -1)) * temperature
        attn = attn.softmax(dim=-1)
        if self.entropies is not None:
            ent = -(attn * attn.clamp_min(1e-30).log()).sum(-1).mean()
            self.entropies.append(float(ent) / math.log(c // heads))
        out = (self._q(attn) @ self._q(v)).reshape(b, c, h, w)
        return self.conv(out, name + ".project_out")

    def feed_forward(self, x, name: str):
        x1, x2 = self.conv(self.conv(x, name + ".project_in"), name + ".dwconv").chunk(2, dim=1)
        if self.fault == "gate_swapped":
            x1, x2 = x2, x1
        return self.conv(F.gelu(x1) * x2, name + ".project_out")

    def level(self, x, name: str):
        i = 0
        while f"{name}.{i}.attn.temperature" in self.p:
            pre = f"{name}.{i}"
            x = x + self.attention(self.norm(x, pre + ".norm1"), pre + ".attn")
            x = x + self.feed_forward(self.norm(x, pre + ".norm2"), pre + ".ffn")
            i += 1
        return x

    def forward(self, x_nhwc):
        inp = x_nhwc.permute(0, 3, 1, 2)
        enc1 = self.level(self.conv(inp, "patch_embed.proj"), "encoder_level1")
        enc2 = self.level(F.pixel_unshuffle(self.conv(enc1, "down1_2.body.0"), 2), "encoder_level2")
        enc3 = self.level(F.pixel_unshuffle(self.conv(enc2, "down2_3.body.0"), 2), "encoder_level3")
        latent = self.level(F.pixel_unshuffle(self.conv(enc3, "down3_4.body.0"), 2), "latent")
        dec3 = F.pixel_shuffle(self.conv(latent, "up4_3.body.0"), 2)
        dec3 = self.level(self.conv(torch.cat([dec3, enc3], 1), "reduce_chan_level3"),
                          "decoder_level3")
        dec2 = F.pixel_shuffle(self.conv(dec3, "up3_2.body.0"), 2)
        dec2 = self.level(self.conv(torch.cat([dec2, enc2], 1), "reduce_chan_level2"),
                          "decoder_level2")
        dec1 = F.pixel_shuffle(self.conv(dec2, "up2_1.body.0"), 2)
        dec1 = self.level(torch.cat([dec1, enc1], 1), "decoder_level1")
        out = self.conv(self.level(dec1, "refinement"), "output") + inp
        return out.permute(0, 2, 3, 1)

    __call__ = forward

    @torch.no_grad()
    def probe(self, x_nhwc) -> Tuple[float, List[float]]:
        """One forward on ``x_nhwc``: (the share of the output's variance that
        the network, not the global residual, carries, var(out − x) /
        var(out); each MDTA's mean row entropy over ln c, in forward order,
        near 1 where the attention is nearly uniform)."""
        self.entropies = []
        try:
            out = self.forward(x_nhwc)
            share = float((out - x_nhwc).var() / out.var().clamp(min=1e-30))
            return share, self.entropies
        finally:
            self.entropies = None
