"""PyTorch port: the trainable growth layer's kernel layout (ops/cuda/growth_train.py
packs, csrc/growth_train.cu), emulated on the CPU.

The CUDA kernels read K-major packed weights (``pack_fwd_weights``,
``pack_dv_weights``), stage halo'd boxes of bf16 operands, and sum the
backward's weight, scale and shift gradients as per-tile partials.
``emulate_growth_train`` repeats that arithmetic in that layout (tap-by-tap
products of bf16-rounded operands in f32; dW, da and db as per-tile partials
summed over each block's walk of tiles, then over the blocks in the sum
kernel's fixed order) and is held against the plain version and the JAX
``growth_layer_cm`` (Pallas, interpret mode).  On the card ``chip_smoke.py``
holds the kernels against the plain version.

Tolerances (those of tests/test_torch_growth_train.py): TIGHT = 2e-3 of
max(scale, 1) against the plain version and the JAX kernels (same rounding
points, other summation orders), CLASS = 2e-2 against the f32 oracle (bf16
operands).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multi_degradation_image_enhancement_tpu.ops.pallas import growth_train as jgt
from multi_degradation_image_enhancement_tpu_torch.ops.cuda import growth_train as gt
from multi_degradation_image_enhancement_tpu_torch.utils.jax_port import conv_to_hwio

TIGHT = 2e-3
CLASS = 2e-2
TILE_W, FWD_TILE_H, BWD_TILE_H = 32, 16, 8  # csrc/growth_train.cu gt::kTW, kFH, kBH
SUM_ROWS = 32  # the sum kernel's row stride (kSumRows)

# (B, c, H, W): c past one chunk of each pass (32, 64) and ragged tiles
SHAPES = [(2, 3, 11, 37), (1, 19, 9, 33), (2, 64, 8, 40), (1, 72, 13, 35)]


def _inputs(B, c, h, w, seed):
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.randn(B, c, h, w).astype(np.float32),
        a=rng.uniform(0.5, 1.5, c).astype(np.float32),
        b=(rng.randn(c) * 0.1).astype(np.float32),
        w=(rng.randn(16, c, 3, 3) * 0.1).astype(np.float32),  # OIHW
        bias=(rng.randn(16) * 0.1).astype(np.float32),
        r=rng.randn(B, 16, h, w).astype(np.float32),  # cotangent
    )


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _boxes(t, tiles_h, tiles_w, tile_h, channels):
    """NCHW ``t`` as NHWC, zero-padded by one pixel before and enough after for
    whole tiles, and with zero channels up to ``channels``: every halo'd box
    of the tile walk is a slice."""
    bsz, c, h, w = t.shape
    nhwc = t.permute(0, 2, 3, 1)
    return F.pad(nhwc, (0, channels - c, 1, tiles_w * TILE_W - w + 1, 1, tiles_h * tile_h - h + 1))


def _activated(x, a, b):
    """bf16(relu(x*a + b)), the product and the sum rounded apart (f32 ops)."""
    return _bf16(torch.relu(x * a[None, :, None, None] + b[None, :, None, None]))


def fixed_order_sum(rows):
    """The sum kernel's order: thread k sums rows k, k + 32, ..., then the 32
    partial sums are added in order."""
    partial = [sum(rows[k::SUM_ROWS], torch.zeros_like(rows[0])) for k in range(SUM_ROWS)]
    total = torch.zeros_like(rows[0])
    for p in partial:
        total = total + p
    return total


def emulate_fwd(x, a, b, w, bias):
    """The forward kernel's arithmetic: per 32-channel chunk and 16-channel K
    step, nine tap products of the staged box with the packed weights."""
    bsz, c, h, wd = x.shape
    wk = gt.pack_fwd_weights(_bf16(w))  # [chunks, 9, 4, 16, 8]
    n = wk.shape[0]
    tiles_h, tiles_w = -(-h // FWD_TILE_H), -(-wd // TILE_W)
    vp = _boxes(_activated(x, a, b), tiles_h, tiles_w, FWD_TILE_H, n * gt.FWD_CHUNK)
    g = torch.zeros((bsz, h, wd, gt.GROWTH))
    for k in range(n):
        for ks in range(gt.FWD_CHUNK // 16):  # every K step; channels past c are zeros
            c0 = gt.FWD_CHUNK * k + 16 * ks
            for tap in range(9):
                ky, kx = divmod(tap, 3)
                win = vp[:, ky:ky + h, kx:kx + wd, c0:c0 + 16]
                wmat = wk[k, tap, 2 * ks:2 * ks + 2].permute(0, 2, 1).reshape(16, gt.GROWTH)
                g = g + win @ wmat
    return (g + bias).permute(0, 3, 1, 2)


def bwd_tiles(bsz, h, w, n_groups):
    """The backward's walk: group i takes tiles i, i + n_groups, ... of the
    batch's (image, tile row, tile column) order; each tile's (image, y0, x0)."""
    tiles_h, tiles_w = -(-h // BWD_TILE_H), -(-w // TILE_W)
    tiles = [(img, ty * BWD_TILE_H, tx * TILE_W)
             for img in range(bsz) for ty in range(tiles_h) for tx in range(tiles_w)]
    return [tiles[i::n_groups] for i in range(min(n_groups, len(tiles)))]


def emulate_bwd(x, a, b, w, dg, n_groups=3):
    """The backward kernel's arithmetic: dv as nine tap products of the
    staged bf16 dg box with the packed, flipped weights; the mask from the
    staged v; dW as MN-major products of the v and dg boxes per tile; dW, da
    and db summed over each group's tiles in walk order, then over the groups
    in the sum kernel's order.  Returns ``(dx, dw, da, db)`` (dw OIHW)."""
    bsz, c, h, wd = x.shape
    wdv = gt.pack_dv_weights(_bf16(w))  # [chunks, 9, 2, 64, 8]
    c_pad = wdv.shape[0] * gt.DV_CHUNK
    tiles_h, tiles_w = -(-h // BWD_TILE_H), -(-wd // TILE_W)
    vp = _boxes(_activated(x, a, b), tiles_h, tiles_w, BWD_TILE_H, c_pad)
    dgp = _boxes(_bf16(dg), tiles_h, tiles_w, BWD_TILE_H, gt.GROWTH)
    xp = _boxes(x, tiles_h, tiles_w, BWD_TILE_H, c_pad)[:, 1:-1, 1:-1]
    inside = torch.zeros(vp.shape[1:3], dtype=torch.bool)
    inside[1:h + 1, 1:wd + 1] = True

    dv = torch.zeros((bsz, vp.shape[1] - 2, vp.shape[2] - 2, c_pad))
    for k in range(wdv.shape[0]):
        for tap in range(9):
            ky, kx = divmod(tap, 3)
            win = dgp[:, ky:ky + dv.shape[1], kx:kx + dv.shape[2]]
            wmat = wdv[k, tap].permute(0, 2, 1).reshape(gt.GROWTH, gt.DV_CHUNK)
            sl = slice(gt.DV_CHUNK * k, gt.DV_CHUNK * (k + 1))
            dv[..., sl] = dv[..., sl] + win @ wmat
    dvm = torch.where(vp[:, 1:-1, 1:-1] > 0, dv, torch.zeros(()))
    dx = (dvm[:, :h, :wd, :c] * a).permute(0, 3, 1, 2)

    rows = []
    for group in bwd_tiles(bsz, h, wd, n_groups):
        dw_g = torch.zeros((c_pad, 9, gt.GROWTH))
        da_g, db_g = torch.zeros(c_pad), torch.zeros(c_pad)
        for img, y0, x0 in group:
            d = dgp[img, y0 + 1:y0 + 1 + BWD_TILE_H, x0 + 1:x0 + 1 + TILE_W].reshape(-1, gt.GROWTH)
            for tap in range(9):
                ky, kx = divmod(tap, 3)
                v = vp[img, y0 + ky:y0 + ky + BWD_TILE_H, x0 + kx:x0 + kx + TILE_W].reshape(-1, c_pad)
                dw_g[:, tap] = dw_g[:, tap] + v.T @ d
            m = dvm[img, y0:y0 + BWD_TILE_H, x0:x0 + TILE_W].reshape(-1, c_pad)
            mask = inside[y0 + 1:y0 + 1 + BWD_TILE_H, x0 + 1:x0 + 1 + TILE_W].reshape(-1, 1)
            m = torch.where(mask, m, torch.zeros(()))
            da_g = da_g + (m * xp[img, y0:y0 + BWD_TILE_H, x0:x0 + TILE_W].reshape(-1, c_pad)).sum(0)
            db_g = db_g + m.sum(0)
        rows.append(torch.cat([dw_g.reshape(-1), da_g, db_g]))
    total = fixed_order_sum(rows)
    n_dw = c_pad * 9 * gt.GROWTH
    dw = total[:n_dw].reshape(c_pad, 3, 3, gt.GROWTH)[:c].permute(3, 0, 1, 2)
    return dx, dw, total[n_dw:n_dw + c], total[n_dw + c_pad:n_dw + c_pad + c]


def emulate_growth_train(d, n_groups=3):
    """``(g, [dx, da, db, dw])`` of the kernels' emulation for the numpy inputs ``d``."""
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    g = emulate_fwd(t["x"], t["a"], t["b"], t["w"], t["bias"])
    dx, dw, da, db = emulate_bwd(t["x"], t["a"], t["b"], t["w"], t["r"], n_groups)
    return g.numpy(), [dx.numpy(), da.numpy(), db.numpy(), dw.numpy()]


def _plain(d):
    t = {k: torch.from_numpy(v).requires_grad_(k != "r") for k, v in d.items()}
    g = gt.growth_layer_plain(t["x"], t["a"], t["b"], t["w"], t["bias"])
    (g * t["r"]).sum().backward()
    return g.detach().numpy(), [t[k].grad.numpy() for k in ("x", "a", "b", "w")]


def _oracle(d):
    """f32 autodiff of the same layer with no rounding anywhere."""
    t = {k: torch.from_numpy(v).requires_grad_(k != "r") for k, v in d.items()}
    v = torch.relu(t["x"] * t["a"][None, :, None, None] + t["b"][None, :, None, None])
    g = F.conv2d(v, t["w"], t["bias"], padding=1)
    (g * t["r"]).sum().backward()
    return g.detach().numpy(), [t[k].grad.numpy() for k in ("x", "a", "b", "w")]


def _jax(d):
    """(g, [dx, da, db, dw OIHW]) of the JAX kernels in interpret mode."""
    B, c, h, w = d["x"].shape

    def f(x, a, b, k, bias):
        return jgt.growth_layer_cm(x, a, b, jgt.pack_growth(k, jgt._ceil16(c)), bias, c, (h, w), True)

    args = (jnp.asarray(d["x"].reshape(B, c, h * w)), jnp.asarray(d["a"]), jnp.asarray(d["b"]),
            jnp.asarray(conv_to_hwio(d["w"])), jnp.asarray(d["bias"]))
    g = f(*args)
    r = jnp.asarray(d["r"].reshape(B, 16, h * w))
    dx, da, db, dk = jax.grad(lambda *p: jnp.sum(f(*p) * r), argnums=(0, 1, 2, 3))(*args)
    dw = np.transpose(np.asarray(dk), (3, 2, 0, 1))  # HWIO -> OIHW
    return np.asarray(g).reshape(B, 16, h, w), [np.asarray(dx).reshape(B, c, h, w),
                                                np.asarray(da), np.asarray(db), dw]


def _close(got, want, tol, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * max(scale, 1.0), f"{what}: {err} vs scale {scale}"


def _hold(got, want, tol, who):
    (g, grads), (wg, wgrads) = got, want
    _close(g, wg, tol, f"g vs {who}")
    for name, p, q in zip(("dx", "da", "db", "dw"), grads, wgrads):
        assert p.shape == q.shape, name
        _close(p, q, tol, f"{name} vs {who}")


# ------------------------------------------------------------------ packing


def unpack_fwd_weights(wk, c):
    """Inverse of ``pack_fwd_weights``: OIHW ``[16, c, 3, 3]``."""
    n = wk.shape[0]
    return wk.permute(3, 0, 2, 4, 1).reshape(gt.GROWTH, n * gt.FWD_CHUNK, 3, 3)[:, :c]


def unpack_dv_weights(wdv, c):
    """Inverse of ``pack_dv_weights``: OIHW ``[16, c, 3, 3]``."""
    n = wdv.shape[0]
    wf = wdv.permute(2, 4, 0, 3, 1).reshape(gt.GROWTH, n * gt.DV_CHUNK, 3, 3)[:, :c]
    return wf.flip(2, 3)


@pytest.mark.parametrize("c", [3, 19, 64, 72])
def test_pack_fwd_weights_layout(c):
    """[chunk, tap, group, o, i] = w[o, 32 chunk + 8 group + i, ky, kx], zeros
    past c, and unpacking gives OIHW back."""
    w = torch.randn(16, c, 3, 3).to(torch.bfloat16)
    wk = gt.pack_fwd_weights(w)
    assert wk.shape == (-(-c // 32), 9, 4, 16, 8) and wk.dtype == torch.bfloat16
    assert wk.is_contiguous()
    rng = np.random.RandomState(c)
    for _ in range(50):
        k, t, g, o, i = (rng.randint(s) for s in wk.shape)
        ch = 32 * k + 8 * g + i
        want = w[o, ch, t // 3, t % 3] if ch < c else 0.0
        assert float(wk[k, t, g, o, i]) == float(want)
    flat = wk.permute(1, 3, 0, 2, 4).reshape(9, 16, -1)  # [tap, o, channel]
    assert torch.all(flat[:, :, c:] == 0)
    assert torch.equal(unpack_fwd_weights(wk, c), w)


@pytest.mark.parametrize("c", [3, 19, 64, 72])
def test_pack_dv_weights_layout(c):
    """[chunk, tap, og, j, i] = w[8 og + i, 64 chunk + j, 2 - ky, 2 - kx] (the
    transposed conv's flipped taps), zeros past c, and unpacking gives OIHW
    back."""
    w = torch.randn(16, c, 3, 3).to(torch.bfloat16)
    wdv = gt.pack_dv_weights(w)
    assert wdv.shape == (-(-c // 64), 9, 2, 64, 8) and wdv.dtype == torch.bfloat16
    assert wdv.is_contiguous()
    rng = np.random.RandomState(c + 1)
    for _ in range(50):
        k, t, og, j, i = (rng.randint(s) for s in wdv.shape)
        ch = 64 * k + j
        want = w[8 * og + i, ch, 2 - t // 3, 2 - t % 3] if ch < c else 0.0
        assert float(wdv[k, t, og, j, i]) == float(want)
    flat = wdv.permute(1, 2, 4, 0, 3).reshape(9, 16, -1)  # [tap, o, channel]
    assert torch.all(flat[:, :, c:] == 0)
    assert torch.equal(unpack_dv_weights(wdv, c), w)


@pytest.mark.parametrize("bsz,h,w,n_groups", [(2, 11, 37, 3), (1, 33, 47, 7), (3, 8, 32, 100)])
def test_bwd_tiles_cover_every_pixel_once(bsz, h, w, n_groups):
    """The backward's persistent walk visits every tile exactly once, and its
    32x8 tiles cover every pixel exactly once."""
    seen = torch.zeros((bsz, -(-h // BWD_TILE_H) * BWD_TILE_H, -(-w // TILE_W) * TILE_W))
    groups = bwd_tiles(bsz, h, w, n_groups)
    assert len(groups) == min(n_groups, sum(len(g) for g in groups))
    for group in groups:
        for img, y0, x0 in group:
            seen[img, y0:y0 + BWD_TILE_H, x0:x0 + TILE_W] += 1
    assert torch.all(seen == 1)


# ------------------------------------------------------------- emulation


@pytest.mark.parametrize("B,c,h,w", SHAPES)
def test_emulation_matches_plain(B, c, h, w):
    """The kernels' layout and summation order against the plain version
    (TIGHT) and the f32 oracle (CLASS)."""
    d = _inputs(B, c, h, w, seed=c + h)
    got = emulate_growth_train(d)
    _hold(got, _plain(d), TIGHT, "plain")
    _hold(got, _oracle(d), CLASS, "oracle")


@pytest.mark.parametrize("B,c,h,w", SHAPES)
def test_emulation_matches_jax(B, c, h, w):
    """The kernels' layout against the JAX growth_layer_cm in interpret mode (TIGHT)."""
    d = _inputs(B, c, h, w, seed=2 * c + w)
    _hold(emulate_growth_train(d), _jax(d), TIGHT, "JAX")


@pytest.mark.parametrize("n_groups", [1, 5])
def test_emulation_block_count_moves_only_rounding(n_groups):
    """How many blocks share the walk changes only the order of the f32 sums
    of dW, da and db (the kernel picks it from the SM count)."""
    d = _inputs(2, 72, 13, 35, seed=5)
    _hold(emulate_growth_train(d, n_groups), emulate_growth_train(d, 3), TIGHT, "3 groups")
