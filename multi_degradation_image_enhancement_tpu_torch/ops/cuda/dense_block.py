"""Inference DenseBlock: CUDA kernels (``csrc/dense_block.cu``), the BN fold,
the parameter pack, and the plain PyTorch version.

Counterpart of ``multi_degradation_image_enhancement_tpu/ops/pallas/
dense_block_cm.py`` (``_kernel2`` via ``_run_cm2``, and the row-tiled
``_kernel`` via ``_run_cm``, whose NHWC entry is :func:`fused_dense_block_cm`)
and of ``ops/pallas/dense_block.py`` (``fold_bn``, and the row-major
``_kernel`` whose entry is :func:`fused_dense_block`).  NCHW in and out:
``[B, c_in, H, W]`` → ``[B, c_out, H, W]`` in x's dtype, with no channel
padding (the NHWC entries: NHWC in and out).

:func:`dense_block` takes the plain version only for a tensor on the CPU.  For
a CUDA tensor it launches an entry pass into an NHWC bf16 concat buffer, one
growth kernel per layer and one transition kernel, all products on the tensor
cores (``wgmma``), or raises; ``dense_block.launches`` counts every launch,
:data:`LAUNCHES_PER_BLOCK` for each of CDAN's blocks, and
``dense_block.bf16_act_launches`` those among them that activate in bf16.
It is inference only: the kernels have no backward, so it raises when grad
is enabled and x or a pack tensor requires grad, on either device (the
trainable growth layer is ``ops.cuda.growth_train``).

``bf16_act`` (``serving_tuning.json``'s ``db_bf16_act``,
``dense_block_cm.py:515-523``) runs the affine and ReLU in bf16, a and b
rounded to bf16: the product rounded, the sum rounded, then the ReLU; for
the transition always, for a growth layer only where the JAX kernel's
channel count ``ceil16(c_in) + 16·i`` exceeds ``k_stack_max_ci`` (the
K-stacked layers activate in f32 whatever the flag, ``:532-535``).  The
pack holds both and says per launch (:meth:`DenseBlockPack.layer_bf16_act`);
the kernel and the plain version round at the same two points.

The kernels read the pack's padded operands (:class:`DenseBlockPack`): the
NHWC bf16 concat buffer ``[B, H, W, c_buf]`` holds x in channels
``[0, c_in_pad)`` and layer i's output in ``[c_in_pad + g_pad·i, + g_pad)``,
so every slot starts on 16 bytes; module channel ``c`` sits at buffer
channel ``chan_index[c]``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import List

import torch
import torch.nn.functional as F

from multi_degradation_image_enhancement_tpu_torch.ops.cuda import _build
from multi_degradation_image_enhancement_tpu_torch.utils.tracing import span

BN_EPS = 1e-5
C_ALIGN = 8  # c_in is padded to it: 16 bytes, the kernels' vector load
G_ALIGN = 16  # growth is padded to it: the growth kernel's wgmma N
K_CHUNK = 32  # channels of the kernels' K chunk: the K operands are padded to it
N_WIDE = 64  # the transition's N granule above 8 outputs
JAX_C_ALIGN = 16  # the JAX kernel pads c_in to 16 (``_ceil16``): its K-stack threshold reads that
NUM_LAYERS = 4  # growth layers of each of CDAN's DenseBlocks
# Launches of one DenseBlock call on the card: the entry pass, one growth
# kernel a layer, the transition.
LAUNCHES_PER_BLOCK = 1 + NUM_LAYERS + 1


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def fold_bn(scale, bias, mean, var, eps: float = BN_EPS):
    """Inference BatchNorm → per-channel affine ``(a, b)`` with ``a·x + b``."""
    a = scale / torch.sqrt(var + eps)
    return a, bias - mean * a


@dataclass
class DenseBlockPack:
    """A DenseBlock's folded parameters (f32), the plain version's operands,
    and the kernels' padded operands, derived from them.

    Layer ``i`` reads ``c_in + growth·i`` channels; ``w[i]`` is
    ``[growth, c_i, 3, 3]``; the transition ``wt`` is ``[c_out, c_total]``.

    The kernels' operands, in buffer channels (``chan_index``), zeros on
    every pad: ``ak[i]``, ``bk[i]`` f32 ``[k_pad_i]``; ``wk[i]`` bf16
    ``[9, g_pad, k_pad_i]`` K-major (tap ``3·ky + kx``, output, channel), with
    ``k_pad_i`` = ``c_in_pad + g_pad·i`` rounded up to :data:`K_CHUNK`;
    ``biask[i]`` f32 ``[g_pad]``; ``atk``, ``btk`` f32 ``[kt_pad]`` and
    ``wtk`` bf16 ``[n_pad, kt_pad]`` with ``kt_pad`` = ``c_buf`` rounded up
    to :data:`K_CHUNK` and ``n_pad`` = c_out padded to 8 (up to 8) or to
    :data:`N_WIDE`; ``biastk`` f32 ``[n_pad]``.

    ``bf16_act`` and ``k_stack_max_ci``: which activations run in bf16
    (:meth:`layer_bf16_act`, the module docstring).
    """

    c_in: int
    growth: int
    a: List[torch.Tensor]
    b: List[torch.Tensor]
    w: List[torch.Tensor]
    bias: List[torch.Tensor]
    at: torch.Tensor
    bt: torch.Tensor
    wt: torch.Tensor
    biast: torch.Tensor
    bf16_act: bool = False
    k_stack_max_ci: int = 0
    chan_index: torch.Tensor = field(init=False)
    ak: List[torch.Tensor] = field(init=False)
    bk: List[torch.Tensor] = field(init=False)
    wk: List[torch.Tensor] = field(init=False)
    biask: List[torch.Tensor] = field(init=False)
    atk: torch.Tensor = field(init=False)
    btk: torch.Tensor = field(init=False)
    wtk: torch.Tensor = field(init=False)
    biastk: torch.Tensor = field(init=False)

    def __post_init__(self):
        # A handful of launches for the whole pack: the NHWC entries fold a
        # module on every call, so the host cost of this shows in their time.
        lay = _layout(self.c_in, self.growth, self.num_layers, self.c_out, self.wt.device)
        self.chan_index = lay["chan"]
        n = self.num_layers
        ab = self.wt.new_zeros((2 * n + 2, _round_up(self.c_buf, K_CHUNK)))
        ab.index_put_(lay["ab"], torch.cat([*(t for ab_i in zip(self.a, self.b) for t in ab_i),
                                           self.at, self.bt]))
        biases = self.wt.new_zeros((n + 1, max(self.g_pad, self.n_pad)))
        biases.index_put_(lay["bias"], torch.cat([*self.bias, self.biast]))
        self.ak, self.bk, self.wk, self.biask = [], [], [], []
        for i in range(n):
            ci = self.c_in + self.growth * i
            k_pad = _round_up(self.c_in_pad + self.g_pad * i, K_CHUNK)
            self.ak.append(ab[2 * i, :k_pad])
            self.bk.append(ab[2 * i + 1, :k_pad])
            wk = self.wt.new_zeros((3, 3, self.g_pad, k_pad), dtype=torch.bfloat16)
            w = self.w[i].permute(2, 3, 0, 1).to(torch.bfloat16)
            wk[:, :, :self.growth, self.chan_index[:ci]] = w
            self.wk.append(wk.view(9, self.g_pad, k_pad))
            self.biask.append(biases[i, :self.g_pad])
        self.atk, self.btk = ab[2 * n], ab[2 * n + 1]
        wtk = self.wt.new_zeros((self.n_pad, ab.shape[1]), dtype=torch.bfloat16)
        wtk[:self.c_out, self.chan_index] = self.wt.to(torch.bfloat16)
        self.wtk = wtk
        self.biastk = biases[n, :self.n_pad]

    def layer_bf16_act(self, i: int) -> bool:
        """Whether growth layer ``i`` (or, for ``i`` = ``num_layers``, the
        transition) activates in bf16: with ``bf16_act``, the transition
        always and a growth layer where the JAX kernel's ``ceil16(c_in) +
        16·i`` channels exceed ``k_stack_max_ci``."""
        if not self.bf16_act:
            return False
        if i == self.num_layers:
            return True
        return _round_up(self.c_in, JAX_C_ALIGN) + self.g_pad * i > self.k_stack_max_ci

    @property
    def num_layers(self) -> int:
        return len(self.w)

    @property
    def c_total(self) -> int:
        return self.c_in + self.growth * self.num_layers

    @property
    def c_out(self) -> int:
        return self.wt.shape[0]

    @property
    def c_in_pad(self) -> int:
        return _round_up(self.c_in, C_ALIGN)

    @property
    def g_pad(self) -> int:
        return _round_up(self.growth, G_ALIGN)

    @property
    def c_buf(self) -> int:
        """Channels of the kernels' NHWC concat buffer."""
        return self.c_in_pad + self.g_pad * self.num_layers

    @property
    def n_pad(self) -> int:
        return 8 if self.c_out <= 8 else _round_up(self.c_out, N_WIDE)


@functools.lru_cache(maxsize=None)
def _layout(c_in: int, growth: int, layers: int, c_out: int, device) -> dict:
    """Index tensors of the pack's padded layout, made once per shape and
    device: ``chan`` (module channel → buffer channel) and the (row, column)
    positions of the stacked affines ``[a_0, b_0, …, a_t, b_t]`` and biases."""
    c_in_pad, g_pad = _round_up(c_in, C_ALIGN), _round_up(growth, G_ALIGN)
    chan = [c if c < c_in else c_in_pad + (c - c_in) // growth * g_pad + (c - c_in) % growth
            for c in range(c_in + growth * layers)]
    rows, cols = [], []
    for i in range(layers):
        ci = c_in + growth * i
        rows += [2 * i] * ci + [2 * i + 1] * ci
        cols += chan[:ci] * 2
    rows += [2 * layers] * len(chan) + [2 * layers + 1] * len(chan)
    cols += chan * 2
    b_rows = [i for i in range(layers) for _ in range(growth)] + [layers] * c_out
    b_cols = list(range(growth)) * layers + list(range(c_out))

    def t(v):
        return torch.tensor(v, dtype=torch.long, device=device)

    return {"chan": t(chan), "ab": (t(rows), t(cols)), "bias": (t(b_rows), t(b_cols))}


@torch.no_grad()
def _folded(block, device, dtype=None) -> dict:
    """A ``models.cdan.DenseBlock``'s BatchNorms folded (eval statistics) and
    its weights, f32 on ``device``; with ``dtype`` the folded affines are
    rounded to it."""

    def f32(t):
        return t.detach().to(device=device, dtype=torch.float32).contiguous()

    def affine(bn):
        a, b = (f32(t) for t in fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps))
        return (a, b) if dtype is None else (a.to(dtype).float(), b.to(dtype).float())

    fields = {"c_in": block.in_channels, "growth": block.growth_rate, "a": [], "b": [], "w": [],
              "bias": []}
    for layer in block.layers:
        a, b = affine(layer[0])
        fields["a"].append(a)
        fields["b"].append(b)
        fields["w"].append(f32(layer[2].weight))
        fields["bias"].append(f32(layer[2].bias))
    conv = block.transition_layer[2]
    fields["at"], fields["bt"] = affine(block.transition_layer[0])
    fields.update(wt=f32(conv.weight[:, :, 0, 0]), biast=f32(conv.bias))
    return fields


def pack_dense_block(block, device=None, bf16_act: bool = False,
                     k_stack_max_ci: int = 0) -> DenseBlockPack:
    """Fold a ``models.cdan.DenseBlock``'s BatchNorms (eval statistics) and
    collect its weights for the kernels."""
    return DenseBlockPack(**_folded(block, device), bf16_act=bool(bf16_act),
                          k_stack_max_ci=int(k_stack_max_ci))


def require_no_grad(what: str, tensors) -> None:
    """Raise if autograd would record through an inference-only kernel."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} is inference only (its kernels have no backward): run it under "
            "torch.no_grad()/inference_mode(), or train through models.cdan.CDAN"
        )


def _pack_tensors(pack: DenseBlockPack):
    return [*pack.a, *pack.b, *pack.w, *pack.bias, pack.at, pack.bt, pack.wt, pack.biast]


def _activate(feats: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              bf16: bool = False) -> torch.Tensor:
    """relu(f·a + b) per channel: in f32, or with ``bf16`` in bf16 arithmetic
    (f, a and b rounded to bf16; the product and then the sum rounded, as
    two operations)."""
    if bf16:
        bf = torch.bfloat16
        prod = feats.to(bf) * a.to(bf)[None, :, None, None]
        return torch.relu(prod + b.to(bf)[None, :, None, None])
    return torch.relu(feats.float() * a[None, :, None, None] + b[None, :, None, None])


def dense_block_plain(x: torch.Tensor, pack: DenseBlockPack) -> torch.Tensor:
    """Plain PyTorch version, with the features held in x's dtype.

    For bf16 x it rounds where the kernel rounds (activated operand, weights,
    each ``g + bias``, the output); for f32 x it is the block in f32.  Convs
    accumulate in f32.  ``F.conv2d``'s zero padding pads the activated value,
    as the kernel's SAME padding does.  The activations the pack marks bf16
    (:meth:`DenseBlockPack.layer_bf16_act`) run in bf16 arithmetic, at any x
    dtype.
    """
    dt = x.dtype
    feats = x
    for i, (a, b, w, bias) in enumerate(zip(pack.a, pack.b, pack.w, pack.bias)):
        v = _activate(feats, a, b, pack.layer_bf16_act(i)).to(dt).float()
        g = F.conv2d(v, w.to(dt).float(), bias, padding=1)
        feats = torch.cat([feats, g.to(dt)], dim=1)
    vt = _activate(feats, pack.at, pack.bt, pack.layer_bf16_act(pack.num_layers)).to(dt).float()
    out = F.conv2d(vt, pack.wt.to(dt).float()[:, :, None, None], pack.biast)
    return out.to(dt)


def _dense_block_cuda(x: torch.Tensor, pack: DenseBlockPack, nhwc: bool) -> torch.Tensor:
    """The kernels on a CUDA x, NCHW ``[B, c_in, H, W]`` (NHWC ``[B, H, W,
    c_in]`` with ``nhwc``) → the same layout with c_out channels."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dense_block: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"dense_block: x must be 4-D, got {tuple(x.shape)}")
    bsz, c_in, h, w = (x.shape[0], x.shape[3], x.shape[1], x.shape[2]) if nhwc else x.shape
    if c_in != pack.c_in:
        raise ValueError(f"dense_block: x has {c_in} channels, the pack expects {pack.c_in}")
    _build.require(x, "x", x.dtype)
    _build.require_batch(bsz, "dense_block")
    if min(h, w) <= 0:
        raise ValueError(f"dense_block: empty image {h}x{w}")
    c_buf, g_pad = pack.c_buf, pack.g_pad
    for i in range(pack.num_layers):
        k_pad = _round_up(pack.c_in_pad + g_pad * i, K_CHUNK)
        _build.require(pack.ak[i], f"ak{i}", torch.float32, (k_pad,))
        _build.require(pack.bk[i], f"bk{i}", torch.float32, (k_pad,))
        _build.require(pack.wk[i], f"wk{i}", torch.bfloat16, (9, g_pad, k_pad))
        _build.require(pack.biask[i], f"biask{i}", torch.float32, (g_pad,))
    kt_pad = _round_up(c_buf, K_CHUNK)
    _build.require(pack.atk, "atk", torch.float32, (kt_pad,))
    _build.require(pack.btk, "btk", torch.float32, (kt_pad,))
    _build.require(pack.wtk, "wtk", torch.bfloat16, (pack.n_pad, kt_pad))
    _build.require(pack.biastk, "biastk", torch.float32, (pack.n_pad,))

    lib = _build.load()
    stream = _build.stream_of(x)
    feats = torch.empty((bsz, h, w, c_buf), dtype=torch.bfloat16, device=x.device)
    shape = (bsz, h, w, pack.c_out) if nhwc else (bsz, pack.c_out, h, w)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    with _build.on_device(x):
        err = lib.mdie_db_entry(x.data_ptr(), int(x.dtype == torch.float32), int(nhwc), bsz,
                                c_in, h, w, pack.c_in_pad, feats.data_ptr(), c_buf, stream)
        _build.check(err, "dense_block entry pass")
        dense_block.launches += 1
        for i in range(pack.num_layers):
            ci = pack.c_in_pad + g_pad * i
            err = lib.mdie_db_growth(
                feats.data_ptr(), bsz, h, w, c_buf, ci, _round_up(ci, K_CHUNK),
                pack.ak[i].data_ptr(), pack.bk[i].data_ptr(), pack.wk[i].data_ptr(),
                pack.biask[i].data_ptr(), g_pad, int(pack.layer_bf16_act(i)), stream,
            )
            _build.check(err, f"dense_block growth layer {i}")
            dense_block.launches += 1
            dense_block.bf16_act_launches += int(pack.layer_bf16_act(i))
        err = lib.mdie_db_transition(
            feats.data_ptr(), bsz, h, w, c_buf, kt_pad, pack.atk.data_ptr(), pack.btk.data_ptr(),
            pack.wtk.data_ptr(), pack.biastk.data_ptr(), pack.n_pad, pack.c_out, out.data_ptr(),
            int(x.dtype == torch.bfloat16), int(nhwc), int(pack.layer_bf16_act(pack.num_layers)),
            stream,
        )
        _build.check(err, "dense_block transition")
    dense_block.launches += 1
    dense_block.bf16_act_launches += int(pack.layer_bf16_act(pack.num_layers))
    return out


def dense_block(x: torch.Tensor, pack: DenseBlockPack) -> torch.Tensor:
    """Inference DenseBlock, NCHW ``[B, c_in, H, W]`` → ``[B, c_out, H, W]``.

    On a CUDA tensor (f32 or bf16): the entry pass rounds x into an NHWC bf16
    concat buffer, one growth launch per layer writes its slot, then the
    transition launch.  On the CPU: the plain version.  Raises when grad is
    enabled and x or the pack requires grad.
    """
    with span("kernel/dense_block"):
        require_no_grad("dense_block", [x, *_pack_tensors(pack)])
        if x.device.type == "cpu":
            return dense_block_plain(x, pack)
        return _dense_block_cuda(x, pack, nhwc=False)


dense_block.launches = 0
dense_block.bf16_act_launches = 0


def fused_dense_block_cm(x_nhwc: torch.Tensor, block, bf16_act: bool = False,
                         k_stack_max_ci: int = 0) -> torch.Tensor:
    """Inference DenseBlock from a ``models.cdan.DenseBlock`` module's eval
    statistics, NHWC ``[B, H, W, c_in]`` in and out; ``bf16_act`` and
    ``k_stack_max_ci`` as ``_kernel`` takes them (``dense_block_cm.py:148-159``).

    Counterpart of ``dense_block_cm.py:773`` ``fused_dense_block_cm``, the
    entry of the row-tiled TPU kernel (``_kernel``, ``_run_cm``).  Its row
    tiles with 5-row halos exist only because VMEM is 128 MiB; the growth and
    transition kernels here cover whole images at any size, so this is an
    entry point of :func:`dense_block`'s kernels (launches counted there),
    not a second kernel: its entry pass copies the NHWC x into the concat
    buffer as it is and the transition writes NHWC.  ``_kernel`` rounds where
    ``_kernel2`` does, so the plain version is the same.
    """
    pack = pack_dense_block(block, x_nhwc.device, bf16_act, k_stack_max_ci)
    return _nhwc_entry(x_nhwc, pack, "fused_dense_block_cm")


def _nhwc_entry(x_nhwc: torch.Tensor, pack: DenseBlockPack, what: str) -> torch.Tensor:
    with span("kernel/dense_block"):
        require_no_grad(what, [x_nhwc, *_pack_tensors(pack)])
        if x_nhwc.device.type == "cpu":
            return dense_block_plain(x_nhwc.permute(0, 3, 1, 2), pack).permute(0, 2, 3, 1)
        return _dense_block_cuda(x_nhwc, pack, nhwc=True)


def fold_dense_block(block, dtype: torch.dtype, device=None) -> DenseBlockPack:
    """:func:`pack_dense_block` with the folded affines (``a``, ``b``, ``at``,
    ``bt``) rounded to ``dtype``, as ``dense_block.py:289`` folds them in
    x's dtype; the conv biases stay f32 there too."""
    return DenseBlockPack(**_folded(block, device, dtype))


def fused_dense_block(x_nhwc: torch.Tensor, block) -> torch.Tensor:
    """Inference DenseBlock from a ``models.cdan.DenseBlock`` module's eval
    statistics, NHWC ``[B, H, W, c_in]`` → ``[B, H, W, c_in]`` in x's dtype
    (f32 or bf16).

    Counterpart of ``dense_block.py:276`` ``fused_dense_block``, the entry of
    the row-major TPU kernel #10 (``_kernel``, ``:56``).  Its math is that of
    ``_kernel2``: the input and every feature rounded to bf16 (even for f32
    x, ``:80``), bf16 weights into f32-accumulating dots (``:97``), each
    ``g + bias`` rounded to bf16 (``:132``), SAME padding of the activated
    value, the folded affine and the output in x's dtype.  The growth and
    transition kernels of :func:`dense_block` do exactly that, so this is an
    entry point (launches counted there, :data:`LAUNCHES_PER_BLOCK` a call,
    NHWC in and out with no permute), not a second kernel.
    What the TPU design adds answers VMEM and the matrix unit's lane width
    and has no counterpart here: the 4-row halos (``HALO``), the tile chooser
    (``_choose_tile``), the 128-lane channel padding (``_round128``,
    ``_pad_rows``) and the dx-tap packing (``pack_growth_kernel``).

    The plain version, taken on the CPU, is :func:`dense_block_plain` on the
    same fold; it keeps f32 features for f32 x, so it sits a bf16 rounding
    class away from the kernel and from JAX there.
    """
    return _nhwc_entry(x_nhwc, fold_dense_block(block, x_nhwc.dtype, x_nhwc.device),
                       "fused_dense_block")
