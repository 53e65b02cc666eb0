"""PyTorch port: the fused CBAM with the decoder's product (ops/cuda/cbam.py).

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it against
the plain version there); here: the plain version against an independent
float64 construction from an eval ``models.cbam.CBAM`` with live statistics,
with and without the product, at the four served shapes and odd sizes; the
wrapper's refusals and its shape-chosen plan; and the CM forward, whose four
CBAMs now go through the fused call, against the ``CDAN`` module.
"""

import numpy as np
import pytest
import torch

from multi_degradation_image_enhancement_tpu_torch.models import cdan_fast
from multi_degradation_image_enhancement_tpu_torch.models.cbam import CBAM
from multi_degradation_image_enhancement_tpu_torch.models.cdan import init_cdan
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.cbam import (
    CbamPlan,
    cbam_cm,
    cbam_plan,
    scratch_floats,
    vector_path,
)

# The four served CBAM inputs at 256² (bottleneck, cbam1, cbam2, cbam3) at
# B=2, then odd H and W and 1×1.
SHAPES = [(2, 512, 32, 32), (2, 256, 32, 32), (2, 128, 64, 64), (2, 64, 128, 128),
          (2, 16, 5, 7), (1, 32, 1, 1)]
DTYPES = [torch.bfloat16, torch.float32]


def _live_cbam(c: int, seed: int = 0) -> CBAM:
    """An eval CBAM with seeded weights and spatial BatchNorm statistics and
    affine far from the identity, so every part of both gates counts."""
    gen = torch.Generator().manual_seed(seed)
    torch.manual_seed(seed)
    cbam = CBAM(c).eval()
    bn = cbam.SpatialGate.spatial.bn
    with torch.no_grad():
        bn.running_mean.uniform_(-0.3, 0.3, generator=gen)
        bn.running_var.uniform_(0.2, 0.8, generator=gen)
        bn.weight.uniform_(0.5, 1.5, generator=gen)
        bn.bias.uniform_(-0.5, 0.5, generator=gen)
    return cbam


def _inputs(shape, dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g).to(dtype)
    d = (torch.rand(shape, generator=g) * 2).to(dtype)
    return x, d


def _reference64(cbam: CBAM, x: torch.Tensor, d=None) -> np.ndarray:
    """CBAM (· d) in float64 numpy from the module's own parameters: the
    shared MLP on the H×W mean and max, the [max, mean] map over channels,
    the 7×7 cross-correlation (zero padding 3), the BatchNorm from its
    running statistics, no fold."""
    def np64(t):
        return t.detach().double().numpy()

    x64 = np64(x)
    fc1, fc2 = cbam.ChannelGate.mlp[1], cbam.ChannelGate.mlp[3]
    w1, b1, w2, b2 = np64(fc1.weight), np64(fc1.bias), np64(fc2.weight), np64(fc2.bias)

    def mlp(v):
        return np.maximum(v @ w1.T + b1, 0.0) @ w2.T + b2

    gate = 1.0 / (1.0 + np.exp(-(mlp(x64.mean(axis=(2, 3))) + mlp(x64.max(axis=(2, 3))))))
    xg = x64 * gate[:, :, None, None]
    comp = np.stack([xg.max(axis=1), xg.mean(axis=1)], axis=1)  # [B, 2, H, W]
    _, _, h, w = x64.shape
    pad = np.pad(comp, ((0, 0), (0, 0), (3, 3), (3, 3)))
    k = np64(cbam.SpatialGate.spatial.conv.weight)[0]  # [2, 7, 7]
    conv = np.zeros((x64.shape[0], h, w))
    for ci in range(2):
        for ky in range(7):
            for kx in range(7):
                conv += k[ci, ky, kx] * pad[:, ci, ky:ky + h, kx:kx + w]
    bn = cbam.SpatialGate.spatial.bn
    conv = ((conv - np64(bn.running_mean)[0]) / np.sqrt(np64(bn.running_var)[0] + bn.eps)
            * np64(bn.weight)[0] + np64(bn.bias)[0])
    y = xg / (1.0 + np.exp(-conv))[:, None]
    return y if d is None else y * np64(d)


def _bf16_ulp_gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise distance in bf16 steps (sign-magnitude bits made ordered)."""
    def ordered(t):
        v = t.view(torch.int16).to(torch.int32)
        return torch.where(v < 0, -(v & 0x7FFF), v)

    return (ordered(a) - ordered(b)).abs()


@pytest.mark.parametrize("with_d", [False, True], ids=["cbam", "cbam_times_d"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_is_the_float64_cbam_rounded_once(shape, dtype, with_d):
    """The CPU path (f32, f32 weights, one rounding) is the float64 CBAM of
    the unfolded module (times d): within f32 rounding at f32, within one
    bf16 step (nearly all equal) at bf16."""
    cbam = _live_cbam(shape[1])
    x, d = _inputs(shape, dtype)
    d = d if with_d else None
    with torch.no_grad():
        got = cbam_cm(x, cdan_fast.pack_cbam_cm(cbam), d)
    assert got.dtype == dtype and got.shape == x.shape
    want = _reference64(cbam, x, d)
    if dtype == torch.bfloat16:
        gap = _bf16_ulp_gap(got, torch.from_numpy(want).to(dtype))
        assert gap.max() <= 1 and (gap == 0).float().mean() >= 0.99
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)


def test_reference_is_the_module():
    """The float64 construction agrees with the f32 module's own forward, so
    it holds the CBAM's meaning, not a copy of the kernel's."""
    cbam = _live_cbam(64, seed=3)
    x, _ = _inputs((2, 64, 9, 12), torch.float32, seed=4)
    with torch.no_grad():
        module = cbam(x)
    np.testing.assert_allclose(module.numpy(), _reference64(cbam, x), rtol=1e-4, atol=1e-5)


def _pack_and_x(dtype=torch.bfloat16):
    pack = cdan_fast.pack_cbam_cm(_live_cbam(32))
    x, d = _inputs((2, 32, 4, 8), dtype)
    return pack, x, d


@pytest.mark.parametrize("case", ["x_int", "x_half", "x_3d", "x_empty", "d_shape", "d_dtype",
                                  "d_device", "w1_shape", "k7_shape"])
def test_wrapper_rejects(case):
    pack, x, d = _pack_and_x()
    bad = {
        "x_int": (x.to(torch.int32), pack, None),
        "x_half": (x.half(), pack, None),
        "x_3d": (x[0], pack, None),
        "x_empty": (x[:, :, :0], pack, None),
        "d_shape": (x, pack, d[:, :, :, :4]),
        "d_dtype": (x, pack, d.float()),
        "d_device": (x, pack, torch.empty(x.shape, dtype=x.dtype, device="meta")),
        "w1_shape": (x, {**pack, "w1": pack["w1"][:, :16]}, None),
        "k7_shape": (x, {**pack, "k7": pack["k7"][:, :1]}, None),
    }[case]
    with pytest.raises(ValueError, match="cbam_cm"):
        cbam_cm(*bad)


def test_wrapper_refuses_grad():
    """No backward: with grad enabled and x or d requiring grad it raises;
    under no_grad it runs."""
    pack, x, d = _pack_and_x(torch.float32)
    with pytest.raises(RuntimeError, match="inference only"):
        cbam_cm(x.requires_grad_(), pack)
    with pytest.raises(RuntimeError, match="inference only"):
        cbam_cm(x.detach(), pack, d.requires_grad_())
    with torch.no_grad():
        assert cbam_cm(x, pack, d).shape == x.shape


def test_cpu_path_counts_no_launch():
    before = cbam_cm.launches
    pack, x, d = _pack_and_x()
    cbam_cm(x, pack, d)
    cbam_cm(x, pack)
    assert cbam_cm.launches == before


def test_vector_path_rule():
    """The 16-byte path needs W % 8 == 0 and x, y and d 16-byte aligned."""
    _, x, d = _pack_and_x()
    assert vector_path(x, torch.empty_like(x), d)
    assert vector_path(x, torch.empty_like(x))
    odd = torch.zeros(2, 32, 4, 12, dtype=torch.bfloat16)
    assert not vector_path(odd, torch.empty_like(odd))
    flat = torch.zeros(1 + x.numel(), dtype=torch.bfloat16)
    shifted = flat[1:].view(x.shape)  # 2 bytes past an aligned start
    assert not vector_path(x, torch.empty_like(x), shifted)


# (shape, plan) at the two serving cells' shapes on an H100's 132 SMs: B=128·256²
# has planes and tiles to spare and takes the largest tiles, no splits; 4 rows
# of 256×384 split H×W in the pool pass where B·C is short, take small compress
# tiles where H×W is, and split the channels of each apply tile.
PLANS = [
    ((128, 512, 32, 32), CbamPlan(splits=1, pg=32, tw=32, cs=1)),
    ((128, 128, 64, 64), CbamPlan(splits=1, pg=32, tw=64, cs=1)),
    ((128, 64, 128, 128), CbamPlan(splits=1, pg=32, tw=64, cs=1)),
    ((4, 512, 32, 48), CbamPlan(splits=1, pg=8, tw=16, cs=8)),
    ((4, 128, 64, 96), CbamPlan(splits=4, pg=8, tw=32, cs=2)),
    ((4, 64, 128, 192), CbamPlan(splits=8, pg=32, tw=64, cs=1)),
    ((2, 16, 5, 7), CbamPlan(splits=1, pg=8, tw=8, cs=1)),
]


@pytest.mark.parametrize("shape, plan", PLANS, ids=[str(s) for s, _ in PLANS])
def test_plan_follows_the_shape(shape, plan):
    """The plan the kernel takes from the shape, and the rules it keeps: a
    pool chunk sweeps at least 256 pixels (unless the plane is smaller), an
    apply tile's width divides W rounded up to 8, each apply thread keeps at
    least two channels."""
    b, c, h, w = shape
    got = cbam_plan(b, c, h, w)
    assert got == plan
    assert got.pg in (8, 16, 32) and got.tw in (8, 16, 32, 64)
    assert got.splits == 1 or -(-h * w // got.splits) >= 256
    assert (-(-w // 8) * 8) % got.tw == 0
    assert got.cs == 1 or -(-c // got.cs) >= 16
    assert scratch_floats(b, c, h, w, got.splits) == (2 * b * c * got.splits + b * c
                                                      + 2 * b * h * w)


@pytest.fixture(scope="module")
def live_model():
    """``init_cdan`` with BatchNorm statistics redrawn so the decoder's ReLUs
    keep the restoration path live (``chip_smoke.live_cdan``'s draw)."""
    gen = torch.Generator().manual_seed(0)
    model = init_cdan(gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.05, 0.05, generator=gen)
                m.running_var.uniform_(0.1, 0.3, generator=gen)
    return model.eval()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_cm_forward_matches_module_through_the_fused_call(live_model, dtype, monkeypatch):
    """The CM forward makes four fused calls, the decoder's three with their
    d3 / d2 / d1, and still matches the f32 ``CDAN`` module to the bf16 bar
    of tests/test_torch_cdan.py."""
    calls = []

    def counted(x, pack, d=None):
        calls.append((tuple(x.shape), None if d is None else tuple(d.shape)))
        return cbam_cm(x, pack, d)

    monkeypatch.setattr(cdan_fast, "cbam_cm", counted)
    x = torch.rand((2, 16, 32, 3), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        ref = live_model(x)
    got = cdan_fast.build_fast_apply_cm(live_model, dtype, "cpu")(x)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert ref.std() > 0.05  # the restoration path is live, not a constant map
    assert calls == [((2, 512, 2, 4), None), ((2, 256, 2, 4), (2, 256, 2, 4)),
                     ((2, 128, 4, 8), (2, 128, 4, 8)), ((2, 64, 8, 16), (2, 64, 8, 16))]
    err = (got - ref).abs()
    assert err.max() < 2e-2 and err.mean() < 2e-3, (err.max(), err.mean())
