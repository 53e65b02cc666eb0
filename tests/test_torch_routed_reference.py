"""PyTorch port: the routed nine-expert pipeline as its CLI builds it
(``run_pipeline.build_full_pipeline`` on seeded files, float32 on the CPU)
against the benchmark's plain reference (``h100bench/reference/routed.py``
over ``resnet.py`` and ``cdan.py``), at the ``routed9.serve_b32`` cell's
dry-run size, B=9·32×48, with all nine experts and the classifier at their
published widths:

* balanced routes, every pool batch: the same routes, probabilities within
  1e-5, restored rows within :data:`IMAGE_TOL`;
* a skewed batch, every row of one family: the rows past the expert's
  capacity come back untouched, and ``dropped_rows`` counts them;
* thresholds of 1.0: every row clean and untouched;
* in each case the router's counters add what the call did;
* with the profiler off the pipeline's spans build nothing; under a CPU
  ``torch.profiler`` each appears once a call (``pipeline/expert`` once an
  expert with rows);
* the router's routes, decided on the device, are the reference's on
  skewed random probabilities at several batch sizes (ties, rows past
  capacity, clean rows), and its counters add their sizes;
* on the CPU :func:`pipeline.cuda_graphed` runs each forward as it is and
  captures nothing;
* ``flops_routed9``'s ResNet-18 count is torchvision's at 224².
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from h100bench import cell as cells
from h100bench import drive_routed, flops_routed9, weights_routed
from h100bench.reference import exact_f32, routed
from multi_degradation_image_enhancement_tpu_torch.pipeline import (
    CLEAN,
    DROPPED,
    RoutedRestorer,
    cuda_graphed,
)
from multi_degradation_image_enhancement_tpu_torch.run_pipeline import build_full_pipeline
from multi_degradation_image_enhancement_tpu_torch.utils import tracing

CELL = "routed9.serve_b32"
SEED = 2**31 + 21
CPU = torch.device("cpu")
# Both sides compute in float32 with TF32 off, in another order (torch's
# BatchNorm kernel against (x − mean)·scale + shift); where a max-pool, a
# CBAM channel max or a ReLU sits at a near-tie that order flips it, which
# takes the worst pixel to 1.2e-3 over six seeds while the mean stays under
# 2e-7.  A row restored by another expert, or not at all, is off by 0.02 and
# more on its mean.
IMAGE_TOL = {"max": 1e-2, "mean": 1e-5}


@pytest.fixture(scope="module")
def setup():
    cell = cells.load(CELL, cpu_dry_run=True)
    return drive_routed.prepare(cell, SEED, CPU)


def _build(s, directory, thresholds=None):
    path = weights_routed.write_files(str(directory), s.experts, s.names, s.classifier)
    if thresholds is not None:  # what a classifier's training run leaves beside it
        (directory / "thresholds_val.json").write_text(json.dumps({"thresholds": thresholds}))
    return build_full_pipeline(path, str(directory), "top1", device="cpu")


@pytest.fixture(scope="module")
def pipe(setup, tmp_path_factory):
    return _build(setup, tmp_path_factory.mktemp("routed9"))


def _reference(s, x, thresholds=None):
    clf, experts = drive_routed._reference(s)
    thr = s.thresholds if thresholds is None else thresholds
    with exact_f32():
        return routed.pipeline(clf, experts, thr, s.capacity_factor, x)


def _program(pipe, x):
    """(restored, probabilities, routes, the counters the call added)."""
    before = drive_routed.counters(pipe.router)
    out, probs = pipe(x)
    added = {k: v - before[k] for k, v in drive_routed.counters(pipe.router).items()}
    return out, probs, pipe.router.route(probs, pipe.thresholds).tolist(), added


def _close(out, want):
    d = (out - want).abs()
    assert float(d.max()) <= IMAGE_TOL["max"] and float(d.mean()) <= IMAGE_TOL["mean"]


@pytest.mark.parametrize("batch", range(4))
def test_balanced_routes_match_the_reference(setup, pipe, batch):
    x = setup.pool[batch]
    out, probs, routes, added = _program(pipe, x)
    want, p_ref, r_ref = _reference(setup, x)
    assert routes == r_ref == setup.family[9 * batch:9 * (batch + 1)].tolist()
    assert float((probs - p_ref).abs().max()) <= 1e-5
    _close(out, want)
    assert added == drive_routed.expected_counts(r_ref) == {
        "expert_calls": 9, "routed_rows": 9, "dropped_rows": 0, "clean_rows": 0}


def _one_family(s, family):
    own = torch.cat(s.pool)[s.family == family]
    return own[torch.arange(9) % own.shape[0]]


@pytest.mark.parametrize("family", [1, 7])
def test_rows_past_capacity_pass_through_and_are_counted(setup, pipe, family):
    x = _one_family(setup, family)
    out, probs, routes, added = _program(pipe, x)
    want, p_ref, r_ref = _reference(setup, x)
    cap = routed.capacity(9, 9, setup.capacity_factor)
    assert routes == r_ref == [family] * cap + [DROPPED] * (9 - cap)
    assert float((probs - p_ref).abs().max()) <= 1e-5
    assert torch.equal(out[cap:], x[cap:])
    _close(out, want)
    assert added == {"expert_calls": 1, "routed_rows": cap, "dropped_rows": 9 - cap,
                     "clean_rows": 0}


def test_thresholds_of_one_leave_every_row_clean(setup, tmp_path):
    pipe = _build(setup, tmp_path, {n: 1.0 for n in setup.names})
    x = setup.pool[0]
    out, probs, routes, added = _program(pipe, x)
    _, p_ref, r_ref = _reference(setup, x, torch.ones_like(setup.thresholds))
    assert routes == r_ref == [CLEAN] * 9
    assert float((probs - p_ref).abs().max()) <= 1e-5 and float(probs.max()) < 1.0
    assert torch.equal(out, x)
    assert added == {"expert_calls": 0, "routed_rows": 0, "dropped_rows": 0, "clean_rows": 9}


def test_spans_build_nothing_with_the_profiler_off(setup, pipe, monkeypatch):
    def no_span(*args, **kwargs):
        raise AssertionError("a span was built with no profiler running")

    monkeypatch.setattr(tracing, "_Span", no_span)
    assert not torch.autograd._profiler_enabled()
    out, _ = pipe(setup.pool[1])
    assert out.shape == setup.pool[1].shape


def _spans(prof):
    out = {}
    for e in prof.events():
        if e.name.startswith("pipeline/"):
            out[e.name] = out.get(e.name, 0) + 1
    return out


@pytest.mark.parametrize("mix", ["balanced", "one_family"])
def test_spans_under_a_profiler(setup, pipe, mix):
    x = setup.pool[2] if mix == "balanced" else _one_family(setup, 5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe(x)
    experts = 9 if mix == "balanced" else 1
    assert _spans(prof) == {"pipeline/forward": 1, "pipeline/classify": 1, "pipeline/route": 1,
                            "pipeline/expert": experts}


@pytest.mark.parametrize("batch,seed", [(5, 0), (32, 1), (32, 2), (40, 3)])
def test_routes_decided_on_the_device_are_the_references(batch, seed):
    """Probabilities on a coarse grid (so argmax ties occur), skewed to three
    of nine experts (so buckets overflow), some rows under every threshold."""
    gen = torch.Generator().manual_seed(seed)
    probs = torch.randint(0, 5, (batch, 9), generator=gen).float() / 4
    probs[:, 3:] *= 0.5
    probs[torch.rand(batch, generator=gen) < 0.2] = 0.1
    thr = torch.full((9,), 0.5)
    router = RoutedRestorer([lambda x: x] * 9, [f"e{e}" for e in range(9)])
    routes = router.route(probs, thr).tolist()
    want = routed.route(probs, thr, router.capacity_factor)
    assert routes == want
    assert batch < 32 or (DROPPED in want and CLEAN in want)
    assert (router.dropped_rows, router.clean_rows) == (want.count(DROPPED), want.count(CLEAN))


def test_cuda_graphed_leaves_a_cpu_forward_as_it_is():
    calls = []

    def double(x):
        calls.append(x.shape)
        return 2 * x

    graphed, missing = cuda_graphed([double, None])
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(graphed(x), 2 * x) and torch.equal(graphed(x[:1]), 2 * x[:1])
    assert missing is None and graphed.captures == 0 and calls == [(2, 3), (1, 3)]


def test_resnet18_flops_are_torchvisions():
    assert flops_routed9.resnet18_flops(224, 224, classes=1000, heads=0) == pytest.approx(
        3.64e9, rel=0.01)
