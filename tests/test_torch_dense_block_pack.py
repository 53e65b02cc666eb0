"""PyTorch port: the DenseBlock kernels' pack (ops/cuda/dense_block.py) and
their layout, emulated on the CPU.

The CUDA kernels (csrc/dense_block.cu) read an NHWC bf16 concat buffer with
padded slots and K-major padded weights.  ``emulate_kernels`` repeats their
arithmetic in that layout (tap-by-tap products in f32 on bf16-rounded
operands) and is held against the plain version and the JAX kernel; on the
card ``chip_smoke.py`` holds the kernels against the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_degradation_image_enhancement_tpu.models.cdan import DenseBlock as JaxDenseBlock
from multi_degradation_image_enhancement_tpu_torch.models.cdan import DenseBlock
from multi_degradation_image_enhancement_tpu_torch.ops.cuda import dense_block as db
from multi_degradation_image_enhancement_tpu_torch.utils.jax_port import dense_block_state_dict


def _block(c_in: int, growth: int, seed: int, bf16_weights: bool = False) -> DenseBlock:
    """A port DenseBlock with seeded weights and live BatchNorm statistics;
    with ``bf16_weights`` its conv weights are bf16-representable, so the
    kernels' bf16 weights equal the plain version's f32 ones."""
    rng = np.random.default_rng(seed)
    block = DenseBlock(c_in, growth_rate=growth).eval()
    with torch.no_grad():
        for name, t in block.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            if name.endswith("running_var"):
                v = rng.uniform(0.5, 1.5, t.shape)
            elif name.endswith("weight") and t.dim() == 4:
                v = rng.normal(0.0, (2.0 / (t.shape[1] * t.shape[2] * t.shape[3])) ** 0.5, t.shape)
            else:
                v = rng.normal(0.0, 0.2, t.shape)
            v = torch.from_numpy(v.astype(np.float32))
            if bf16_weights and t.dim() == 4:
                v = v.to(torch.bfloat16).float()
            t.copy_(v)
    return block


def emulate_kernels(x: torch.Tensor, pack: db.DenseBlockPack, rounded: bool = True,
                    nhwc: bool = False) -> torch.Tensor:
    """The kernels' arithmetic in their layout, on the CPU.

    NCHW x (NHWC with ``nhwc``) goes into an NHWC buffer of ``pack.c_buf``
    channels at the pack's slots; each growth layer activates channels
    ``[0, c_i)`` of it (zero past c_i and outside the image), sums the nine
    taps' K-major products ``window @ wk[tap].T`` in f32 and writes its
    ``g_pad``-channel slot; the transition is one product with ``wtk``.  With
    ``rounded`` it rounds to bf16 where the kernels do (the input, the
    activated operand, each ``g + bias``) and the output to x's dtype;
    without, it stays in f32 (the bf16 weights are exact)."""
    def rnd(t):
        return t.to(torch.bfloat16).float() if rounded else t

    xs = x if nhwc else x.permute(0, 2, 3, 1)
    bsz, h, w, c_in = xs.shape
    buf = torch.zeros((bsz, h, w, pack.c_buf))
    buf[..., :c_in] = rnd(xs.float())
    for i in range(pack.num_layers):
        ci = pack.c_in_pad + pack.g_pad * i
        v = rnd(torch.relu(buf[..., :ci] * pack.ak[i][:ci] + pack.bk[i][:ci]))
        v = torch.nn.functional.pad(v, (0, 0, 1, 1, 1, 1))  # SAME: zeros after activation
        g = torch.zeros((bsz, h, w, pack.g_pad))
        for tap in range(9):
            ky, kx = divmod(tap, 3)
            g += v[:, ky:ky + h, kx:kx + w, :] @ pack.wk[i][tap, :, :ci].float().T
        buf[..., ci:ci + pack.g_pad] = rnd(g + pack.biask[i])
    k = pack.c_buf
    vt = rnd(torch.relu(buf * pack.atk[:k] + pack.btk[:k]))
    out = (vt @ pack.wtk[:, :k].float().T + pack.biastk)[..., :pack.c_out]
    out = out.to(x.dtype) if rounded else out
    return out if nhwc else out.permute(0, 3, 1, 2)


@pytest.mark.parametrize("c_in,growth", [(3, 16), (64, 16), (128, 16), (3, 12), (64, 12)])
def test_pack_slot_layout(c_in, growth):
    """Slots start on 8 channels (x) and 16 (each layer); every pad of the
    kernels' operands is zero; weights sit K-major at the slots' channels."""
    block = _block(c_in, growth, seed=c_in + growth)
    pack = db.pack_dense_block(block)
    c_in_pad, g_pad = -(-c_in // 8) * 8, -(-growth // 16) * 16
    c_buf = c_in_pad + 4 * g_pad
    assert (pack.c_in_pad, pack.g_pad, pack.c_buf) == (c_in_pad, g_pad, c_buf)
    assert db.LAUNCHES_PER_BLOCK == pack.num_layers + 2
    want_idx = list(range(c_in)) + [c_in_pad + g_pad * j + r for j in range(4) for r in range(growth)]
    assert pack.chan_index.tolist() == want_idx
    pads = sorted(set(range(pack.c_buf)) - set(want_idx))
    for i in range(4):
        ci_mod, ci = c_in + growth * i, c_in_pad + g_pad * i
        k_pad = -(-ci // db.K_CHUNK) * db.K_CHUNK
        cols = pack.chan_index[:ci_mod]
        assert pack.wk[i].shape == (9, g_pad, k_pad) and pack.wk[i].dtype == torch.bfloat16
        assert pack.ak[i].shape == (k_pad,) and pack.biask[i].shape == (g_pad,)
        torch.testing.assert_close(pack.ak[i][cols], pack.a[i], rtol=0, atol=0)
        torch.testing.assert_close(pack.bk[i][cols], pack.b[i], rtol=0, atol=0)
        dead = torch.ones(k_pad, dtype=torch.bool)
        dead[cols] = False
        assert not pack.ak[i][dead].any() and not pack.bk[i][dead].any()
        assert not pack.wk[i][:, :, dead].any() and not pack.wk[i][:, growth:].any()
        assert not pack.biask[i][growth:].any()
        for o, c, ky, kx in ((0, 0, 0, 0), (growth - 1, ci_mod - 1, 2, 1), (growth // 2, ci_mod // 2, 1, 2)):
            assert pack.wk[i][3 * ky + kx, o, pack.chan_index[c]] == pack.w[i][o, c, ky, kx].to(torch.bfloat16)
    kt_pad = -(-c_buf // db.K_CHUNK) * db.K_CHUNK
    assert pack.wtk.shape == (pack.n_pad, kt_pad) and pack.atk.shape == (kt_pad,)
    assert torch.equal(pack.wtk[:c_in, pack.chan_index], pack.wt.to(torch.bfloat16))
    assert not pack.wtk[:, pads].any() and not pack.wtk[c_in:].any()
    assert not pack.atk[pads].any() and not pack.btk[pads].any()
    assert not pack.biastk[c_in:].any()


@pytest.mark.parametrize("c_out,n_pad", [(3, 8), (8, 8), (12, 64), (64, 64), (128, 128), (256, 256)])
def test_transition_n_pad(c_out, n_pad):
    """The transition's c_out pads to 8 up to 8 outputs (final_dense's 3),
    else to 64; the kernel takes N tiles of 128 where n_pad allows, else 64."""
    pack = db.pack_dense_block(_block(c_out, 16, seed=c_out))
    assert pack.c_out == c_out and pack.n_pad == n_pad
    assert pack.biastk.shape == (n_pad,) and pack.wtk.shape[0] == n_pad


@pytest.mark.parametrize("c_in,growth,h,w", [(3, 16, 7, 13), (64, 12, 9, 11), (128, 16, 5, 8)])
def test_emulation_matches_plain_f32(c_in, growth, h, w):
    """In f32 (bf16-exact weights, no rounding) the kernels' layout computes
    the plain version's block: sum order only."""
    pack = db.pack_dense_block(_block(c_in, growth, seed=11, bf16_weights=True))
    x = torch.from_numpy(np.random.default_rng(12).random((2, c_in, h, w), dtype=np.float32))
    got = emulate_kernels(x, pack, rounded=False)
    want = db.dense_block_plain(x, pack)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("c_in,growth,h,w", [(3, 16, 11, 6), (64, 12, 6, 9)])
def test_emulation_matches_plain_bf16(c_in, growth, h, w):
    """Rounded where the kernels round, the emulation sits within a few bf16
    rounding flips of the bf16 plain version, which rounds at the same points."""
    pack = db.pack_dense_block(_block(c_in, growth, seed=13))
    x = torch.from_numpy(np.random.default_rng(14).random((2, c_in, h, w), dtype=np.float32))
    x = x.to(torch.bfloat16)
    got = emulate_kernels(x, pack)
    want = db.dense_block_plain(x, pack)
    assert got.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs()
    assert err.max().item() <= 5e-2 and err.mean().item() <= 1e-3


@pytest.mark.parametrize("c_in,h,w", [(3, 16, 24), (64, 8, 16)])
def test_emulation_matches_jax_run_cm2_interpret(c_in, h, w):
    """The emulation against the TPU kernel's body (_run_cm2) in interpret
    mode, bf16 class (tests/test_pallas_kernels.py:64-65)."""
    from multi_degradation_image_enhancement_tpu.ops.pallas.dense_block_cm import (
        _run_cm2,
        pack_params_cm,
    )

    rng = np.random.RandomState(c_in)
    x = rng.rand(2, h, w, c_in).astype(np.float32)
    m = JaxDenseBlock(c_in, growth_rate=16)
    v = jax.jit(lambda k, z: m.init({"params": k}, z, train=False))(jax.random.key(c_in), x)
    stats = jax.tree.map(lambda t: rng.uniform(0.5, 1.5, t.shape).astype(np.float32), v["batch_stats"])
    params = jax.tree.map(np.asarray, v["params"])
    packed = pack_params_cm(params, stats, c_in)
    xcm = jnp.asarray(x).transpose(0, 3, 1, 2).reshape(2, c_in, h * w)
    out = _run_cm2(xcm, packed, c_in=c_in, hw_shape=(h, w), interpret=True)
    want = np.asarray(out[:, :c_in, :]).reshape(2, c_in, h, w)

    block = DenseBlock(c_in)
    block.load_state_dict(dense_block_state_dict({"params": params, "batch_stats": stats}))
    pack = db.pack_dense_block(block.eval())
    for dt in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(dt)
        err = np.abs(emulate_kernels(xt, pack).float().numpy() - want)
        assert err.max() <= 5e-2 and err.mean() <= 5e-3, (dt, err.max(), err.mean())


@pytest.mark.parametrize("entry", ["fused_dense_block_cm", "fused_dense_block"])
def test_nhwc_entries_match_emulation(entry):
    """Both NHWC entries (#3's and #10's; the plain version on the CPU)
    against the kernels' layout emulated straight from NHWC, as their entry
    pass copies x in: bf16 class, no launch counted on the CPU."""
    c_in, h, w = 3, 9, 14
    block = _block(c_in, 16, seed=21)
    x = torch.from_numpy(np.random.default_rng(22).random((2, h, w, c_in), dtype=np.float32))
    pack = (db.pack_dense_block(block) if entry == "fused_dense_block_cm"
            else db.fold_dense_block(block, torch.float32))
    n0 = db.dense_block.launches
    with torch.no_grad():
        got = getattr(db, entry)(x, block)
    assert db.dense_block.launches == n0 and got.shape == (2, h, w, c_in)
    want = emulate_kernels(x, pack, nhwc=True)
    err = (got - want).abs()
    assert err.max().item() <= 5e-2 and err.mean().item() <= 5e-3
