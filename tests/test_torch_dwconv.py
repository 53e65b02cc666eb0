"""PyTorch port: the depthwise 3×3 conv of the served Restormer
(``ops/cuda/dwconv.py``), plain and with GDFN's gate, on the CPU:

* the plain versions of ``depthwise3x3`` and ``depthwise3x3_gated`` equal an
  independent float64 construction (nine explicit shifted products with zero
  padding; ``0.5·a·(1 + erf(a/√2))·g``) at the served channel counts, on
  1×1, 2×3 and W % 8 ≠ 0 planes, with and without bias, in f32 and bf16;
* the entry points refuse a wrong dtype, a non-NCHW x, an odd channel count
  for the gate, weights or bias of the wrong shape or dtype, a device
  mismatch, an empty x and a tensor that requires grad, and count no launch
  on the CPU;
* ``dwconv_plan`` covers every plane once at the ten served shapes of a
  B=4·480×640 forward on 132 SMs, each on the 16-byte path, with at most 6%
  of a plane's rows read twice;
* the served forward calls each entry point 44 times, on NCHW maps even
  for an NHWC batch;
* ``dwconv_roofline`` reads None without its span, counts 49.42 GB a
  B=4·480×640 forward (against a count written out level by level here),
  and divides that bound by the span's device time;
* the Restormer cell's CPU dry run reads ``correct`` as served, and false
  with the gate swapped (``gelu(g)·a``) in the gated plain version, the
  gate the served forward runs on the CPU.

The kernel itself runs only on the card: ``chip_smoke.py`` phase 43 holds it
against the plain versions there.
"""

import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from h100bench import flops, traces
from multi_degradation_image_enhancement_tpu_torch.models import restormer
from multi_degradation_image_enhancement_tpu_torch.models.restormer import Restormer, serving_forward
from multi_degradation_image_enhancement_tpu_torch.ops.cuda import dwconv
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dwconv import (
    depthwise3x3,
    depthwise3x3_gated,
    dwconv_plan,
)

ROOT = Path(__file__).resolve().parents[1]
# the depthwise convs' input channels in the published network: MDTA's 3C and
# GDFN's 2·int(2.66·C) at C = 48, 96, 192, 384
SERVED_CHANNELS = (144, 254, 288, 510, 576, 1020, 1152, 2042)
# (output channels, H, W, gated) of each distinct call of a B=4·480×640 forward
SERVED_CALLS = [(144, 480, 640, False), (288, 480, 640, False), (288, 240, 320, False),
                (576, 120, 160, False), (1152, 60, 80, False), (127, 480, 640, True),
                (255, 480, 640, True), (255, 240, 320, True), (510, 120, 160, True),
                (1021, 60, 80, True)]
# f32 against float64: nine products summed in f32 (values of a few units)
# err by ~1e-6; bf16: one rounding, at most half a bf16 step (2^-8 of the
# value at most), plus the f32 error where it flips a tie.
F32_TOL = 1e-5


def taps_f64(x, w, b=None):
    """The depthwise 3×3 conv, zero padding 1, as nine shifted products
    summed in float64."""
    x = x.double()
    n, c, h, wd = x.shape
    xp = torch.zeros(n, c, h + 2, wd + 2, dtype=torch.float64)
    xp[:, :, 1:-1, 1:-1] = x
    k = w.double().reshape(c, 3, 3)
    y = torch.zeros(n, c, h, wd, dtype=torch.float64)
    for dy in range(3):
        for dx in range(3):
            y += k[:, dy, dx][None, :, None, None] * xp[:, :, dy:dy + h, dx:dx + wd]
    if b is not None:
        y += b.double()[None, :, None, None]
    return y


def gate_f64(y):
    a, g = y.chunk(2, dim=1)
    return 0.5 * a * (1 + torch.erf(a / math.sqrt(2))) * g


def _inputs(shape, dtype, bias, seed=0):
    gen = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = torch.randn(shape, generator=gen).to(dtype)
    w = (torch.randn(c, 1, 3, 3, generator=gen) / 3).to(dtype)
    b = torch.randn(c, generator=gen).to(dtype) if bias else None
    return x, w, b


def _check(x, w, b, gated):
    got = (depthwise3x3_gated if gated else depthwise3x3)(x, w, b)
    want = taps_f64(x, w, b)
    if gated:
        want = gate_f64(want)
    assert got.dtype == x.dtype and got.shape == want.shape
    err = (got.double() - want).abs()
    if x.dtype == torch.bfloat16:
        limit = 2.0 ** -8 * want.abs() + F32_TOL * (1 + want.abs())
    else:
        limit = F32_TOL * (1 + want.abs())
    assert bool((err <= limit).all()), float((err - limit).max())


@pytest.mark.parametrize("gated", [False, True], ids=["plain", "gated"])
@pytest.mark.parametrize("c", SERVED_CHANNELS)
def test_plain_versions_equal_float64_taps_at_the_served_channels(c, gated):
    x, w, b = _inputs((1, c, 4, 16), torch.float32, bias=c % 3 == 0, seed=c)
    _check(x, w, b, gated)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("gated", [False, True], ids=["plain", "gated"])
@pytest.mark.parametrize("hw", [(1, 1), (2, 3), (5, 13)], ids=["1x1", "2x3", "5x13"])
def test_plain_versions_equal_float64_taps_on_odd_planes(hw, gated, bias, dtype):
    x, w, b = _inputs((2, 6, *hw), dtype, bias, seed=hw[0] * 31 + hw[1])
    _check(x, w, b, gated)


def _bad(case):
    x, w, b = _inputs((1, 6, 4, 8), torch.float32, bias=True)
    gated = False
    if case == "dtype":
        x = x.half()
    elif case == "not_nchw":
        x = x[0]
    elif case == "empty":
        x = x[:, :, :0]
    elif case == "odd_channels":
        x, w, b, gated = x[:, :5], w[:5], b[:5], True
    elif case == "weight_shape":
        w = w.reshape(6, 3, 3)
    elif case == "weight_dtype":
        w = w.double()
    elif case == "bias_shape":
        b = b[:4]
    elif case == "device":
        w = torch.empty(w.shape, device="meta")
    return x, w, b, gated


BAD = {"dtype": "must be float32 or bfloat16", "not_nchw": "is not NCHW", "empty": "is empty",
       "odd_channels": "not the two halves", "weight_shape": r"w \(6, 3, 3\) is not",
       "weight_dtype": "w is torch.float64", "bias_shape": r"b \(4,\) is not",
       "device": "w on meta"}


@pytest.mark.parametrize("case", list(BAD))
def test_entry_points_refuse_what_the_kernel_does_not_take(case):
    x, w, b, gated = _bad(case)
    with pytest.raises(ValueError, match=BAD[case]):
        (depthwise3x3_gated if gated else depthwise3x3)(x, w, b)


@pytest.mark.parametrize("gated", [False, True], ids=["plain", "gated"])
def test_inference_only_and_no_launch_on_the_cpu(gated):
    fn = depthwise3x3_gated if gated else depthwise3x3
    x, w, _ = _inputs((1, 4, 3, 8), torch.float32, bias=False)
    n0 = (dwconv.launches, dwconv.gated_launches)
    with pytest.raises(RuntimeError, match="inference only"):
        fn(x.requires_grad_(), w)
    with torch.no_grad():
        assert fn(x, w).shape == (1, 2 if gated else 4, 3, 8)
    assert (dwconv.launches, dwconv.gated_launches) == n0


@pytest.mark.parametrize("c, h, w, gated", SERVED_CALLS,
                         ids=[f"{'gdfn' if g else 'mdta'}_{c}x{h}x{w}" for c, h, w, g in SERVED_CALLS])
def test_plan_covers_each_served_plane_once_with_few_halo_rows(c, h, w, gated):
    plan = dwconv_plan(4, c, h, w, 132)
    assert plan.rows * plan.bands >= h > plan.rows * (plan.bands - 1)  # every row, one band
    assert 2 * (plan.bands - 1) <= 0.06 * h  # rows read twice, of the plane's
    assert w % dwconv.GROUP == 0  # the 16-byte path
    assert 4 * c * plan.bands * (w // dwconv.GROUP) < 2 ** 32  # the kernel's unit count


@pytest.mark.parametrize("b, c, h, w", [(1, 1, 1, 1), (2, 6, 7, 13), (1, 3, 1000, 8),
                                        (128, 64, 256, 256)])
def test_plan_at_other_shapes_and_cards(b, c, h, w):
    for sms in (1, 16, 132):
        plan = dwconv_plan(b, c, h, w, sms)
        assert plan.rows * plan.bands >= h > plan.rows * (plan.bands - 1)
        assert 2 * (plan.bands - 1) <= 0.06 * h
    # a smaller card needs fewer threads: never more bands
    assert dwconv_plan(b, c, h, w, 1).bands <= dwconv_plan(b, c, h, w, 132).bands


def test_served_forward_calls_each_entry_point_44_times(monkeypatch):
    calls = {"plain": [], "gated": []}

    def spy(kind, fn):
        def run(x, w, b=None):
            assert x.is_contiguous()  # NCHW in memory, as the kernel takes it
            calls[kind].append(tuple(x.shape))
            return fn(x, w, b)
        return run

    monkeypatch.setattr(restormer, "depthwise3x3", spy("plain", depthwise3x3))
    monkeypatch.setattr(restormer, "depthwise3x3_gated", spy("gated", depthwise3x3_gated))
    model = Restormer().eval()
    # an NHWC batch, whose NCHW permute has channels_last strides
    out = serving_forward(model, torch.float32, "cpu")(torch.rand(1, 16, 24, 3))
    assert out.shape == (1, 16, 24, 3)
    assert len(calls["plain"]) == len(calls["gated"]) == 44
    assert sorted({s[1] for s in calls["plain"]}) == [144, 288, 576, 1152]
    assert sorted({s[1] for s in calls["gated"]}) == [254, 510, 1020, 2042]


def _reader():
    path = ROOT / "h100bench" / "metrics" / "dwconv_roofline.py"
    spec = importlib.util.spec_from_file_location("dwconv_roofline_under_test", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _bytes_written_out(batch, h, w):
    """The 88 calls' bytes a forward, level by level: (C, pixels, blocks)."""
    p = h * w
    levels = [(48, p, 4), (96, p // 4, 6), (192, p // 16, 6), (384, p // 64, 8),
              (192, p // 16, 6), (96, p // 4, 6), (96, p, 4), (96, p, 4)]
    total = 0
    for c, px, n in levels:
        hidden = int(c * 2.66)
        mdta = batch * px * (3 * c + 3 * c) * 2 + 3 * c * 9 * 2
        gdfn = batch * px * (2 * hidden + hidden) * 2 + 2 * hidden * 9 * 2
        total += n * (mdta + gdfn)
    return total


def _ctx(totals, kind="restormer_serve"):
    return {"kind": kind, "trace": object(), "span_totals": totals, "batch": 4, "height": 480,
            "width": 640, "network": {"dim": 48, "bias": False, "layer_norm_type": "BiasFree"}}


def test_dwconv_roofline_counts_49_42_gb_a_forward():
    work = _reader().call_bytes(4, 480, 640)
    assert len(work) == 88
    assert sum(work) == _bytes_written_out(4, 480, 640)
    assert round(sum(work) / 1e9, 2) == 49.42
    assert sum(work) / flops.HBM_BYTES_PER_S == pytest.approx(14.75e-3, abs=5e-6)


@pytest.mark.parametrize("case", ["no_span", "other_kind", "no_trace", "partial_forward"])
def test_dwconv_roofline_reads_none_without_whole_forwards_of_its_span(case):
    (read,) = traces.load_readers(["dwconv_roofline"]).values()
    ctx = {"no_span": _ctx({"restormer/mdta": (88, 100.0)}),
           "other_kind": _ctx({"restormer/dwconv": (88, 20.0)}, kind="serve"),
           "no_trace": {**_ctx({"restormer/dwconv": (88, 20.0)}), "trace": None},
           "partial_forward": _ctx({"restormer/dwconv": (87, 20.0)})}[case]
    assert read(ctx) is None


def test_dwconv_roofline_divides_the_bound_by_the_span_time():
    (read,) = traces.load_readers(["dwconv_roofline"]).values()
    total = _bytes_written_out(4, 480, 640)
    got = read(_ctx({"restormer/dwconv": (3 * 88, 60.0), "restormer/mdta": (132, 300.0)}))
    assert got == pytest.approx(100.0 * 3 * total / flops.HBM_BYTES_PER_S / 60e-3, rel=1e-12)


# The cell's CPU dry run in a process of its own: the harness refuses a
# process that has loaded JAX, as other test files of one worker may have.
_DRY_RUN = """
import sys
import torch
from multi_degradation_image_enhancement_tpu_torch.ops.cuda import dwconv
from h100bench import run

def halves_swapped(t):
    c = t.shape[0] // 2
    return torch.cat([t[c:], t[:c]])

if sys.argv[1] == "gate_swapped":  # gelu(g) * a in place of gelu(a) * g
    plain = dwconv.depthwise3x3_gated_plain
    dwconv.depthwise3x3_gated_plain = lambda x, w, b=None: plain(
        halves_swapped(x.transpose(0, 1)).transpose(0, 1), halves_swapped(w),
        None if b is None else halves_swapped(b))
sys.exit(run.main(["--workload", "restormer_noise.serve_vga_b4", "--seed", str(2**31 + 11),
                   "--seconds", "0.3", "--trace", "0", "--device", "cpu"]))
"""


@pytest.mark.parametrize("plant", ["as_served", "gate_swapped"])
def test_the_restormer_cell_catches_a_gate_swapped_in_the_served_forward(plant):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    got = subprocess.run([sys.executable, "-c", _DRY_RUN, plant], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-2000:]
    res = json.loads(got.stdout.strip().splitlines()[-1])
    over = [k for k, c in res["compared"].items() if c["value"] > c["limit"]]
    assert (res["correct"], bool(over)) == ((True, False) if plant == "as_served" else (False, True))
