"""The port's spans (``utils.tracing``): off, a shared no-op that records
nothing; on, under a CPU ``torch.profiler``, host ranges of the serving
forward and the train step, nested as the code nests them and none of them
a user annotation; device ranges on the stream and from the event pool of
their own card, and the registry bounded and cleared by ``reset()`` (fake
CUDA events and streams)."""

import itertools

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multi_degradation_image_enhancement_tpu_torch.engine.model import make_train_step
from multi_degradation_image_enhancement_tpu_torch.engine.state import TrainState
from multi_degradation_image_enhancement_tpu_torch.models.cdan import init_cdan
from multi_degradation_image_enhancement_tpu_torch.models.cdan_fast import build_serving_apply
from multi_degradation_image_enhancement_tpu_torch.ops.losses import build_loss_pipeline
from multi_degradation_image_enhancement_tpu_torch.utils import tracing

def _spans(prof):
    """{span name: [profiler event]} of the events named ``layer/what``."""
    out = {}
    for e in prof.events():
        if "/" in e.name and not e.name.startswith(("aten::", "ProfilerStep")):
            out.setdefault(e.name, []).append(e)
    return out


def _ancestors(event):
    names, p = [], event.cpu_parent
    while p is not None:
        names.append(p.name)
        p = p.cpu_parent
    return names


def _serving_apply():
    model = init_cdan(torch.Generator().manual_seed(0)).eval()
    return build_serving_apply(model, torch.float32, "cpu",
                               tuning={"db_bf16_act": False, "db_k_stack_max_ci": 0})


def test_span_off_is_the_shared_noop_and_records_nothing(monkeypatch):
    """No profiler: ``span`` returns the one shared no-op and builds no CUDA
    event.  A profiler the spans do not see (the check patched to off)
    gets no span event from a whole serving forward."""
    def no_event(*args, **kwargs):
        raise AssertionError("a CUDA event was built with spans off")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    monkeypatch.setattr(tracing, "_new_event", no_event)
    assert not torch.autograd._profiler_enabled()
    first = tracing.span("serve/forward", device=torch.device("cuda", 1))
    assert first is tracing.span("cdan/cbam") and first is tracing._OFF
    with first:
        pass
    apply = _serving_apply()
    x = torch.rand(1, 16, 16, 3)
    apply(x)
    monkeypatch.setattr(tracing, "_profiler_enabled", lambda: False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        apply(x)
    assert _spans(prof) == {}
    assert tracing.device_totals() == {} and tracing.dropped() == 0


@pytest.mark.parametrize("hw", [(40, 40), (32, 48)], ids=["per_block", "cm"])
def test_serving_forward_spans_nest_under_the_forward(hw):
    """Both routes of the serving forward, each chosen by the image's shape:
    one ``serve/forward`` a call holding 3 upsamples (each around the fused
    upsample + add's entry), 4 CBAMs (on the CM route each around the fused
    CBAM's entry) and the kernel entry points, all host ops, no user
    annotation; no device range on the CPU."""
    apply = _serving_apply()
    x = torch.rand(1, *hw, 3)
    apply(x)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        apply(x)
    spans = _spans(prof)
    want = {"serve/forward": 1, "cdan/upsample": 3, "cdan/cbam": 4, "kernel/dense_block": 4,
            "kernel/bilinear_x2_add": 3}
    if hw == (32, 48):
        want.update({"kernel/conv3x3": 7, "kernel/conv3x3_pool": 1, "kernel/cbam": 4})
    assert {name: len(events) for name, events in spans.items()} == want
    for name, events in spans.items():
        for e in events:
            assert not e.is_user_annotation, name
            if name != "serve/forward":
                assert "serve/forward" in _ancestors(e), name
            if name == "kernel/bilinear_x2_add":
                assert "cdan/upsample" in _ancestors(e)
            if name == "kernel/cbam":
                assert "cdan/cbam" in _ancestors(e)
    assert tracing.device_totals() == {}


@pytest.mark.parametrize("worst_case", [None, {"fraction": 0.5, "scale": 2.0}],
                         ids=["plain", "worst_case"])
def test_train_step_spans_nest_by_phase(worst_case):
    """One step of ``make_train_step`` over two loss terms: ``train/step``
    holds the four phases, ``train/loss`` each term's span, in both the
    plain and the worst-case path of the pipeline."""
    loss_cfg = {"terms": [{"name": "l1", "weight": 1.0}, {"name": "ssim", "weight": 0.5}]}
    if worst_case:
        loss_cfg["worst_case"] = worst_case
    model = init_cdan(torch.Generator().manual_seed(0))
    state = TrainState.create(model, 1e-4)
    step = make_train_step(build_loss_pipeline(loss_cfg, "cpu"), "fp32")
    x, y = torch.rand(2, 16, 16, 3), torch.rand(2, 16, 16, 3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss = step(state, x, y, torch.Generator().manual_seed(2))
    assert torch.isfinite(loss["total"])
    spans = _spans(prof)
    parents = {"train/step": None, "train/forward": "train/step", "train/loss": "train/step",
               "train/backward": "train/step", "train/optimizer": "train/step",
               "loss/l1": "train/loss", "loss/ssim": "train/loss"}
    assert set(parents) <= set(spans)
    for name, parent in parents.items():
        (event,) = spans[name]
        assert not event.is_user_annotation, name
        enclosing = [a for a in _ancestors(event) if a in parents]
        assert enclosing[:1] == ([parent] if parent else []), name
    order = sorted(("train/forward", "train/loss", "train/backward", "train/optimizer"),
                   key=lambda n: spans[n][0].time_range.start)
    assert order == ["train/forward", "train/loss", "train/backward", "train/optimizer"]


CARD = torch.device("cuda")


class FakeStream:
    def __init__(self, device_index):
        self.device_index = device_index


class FakeEvent:
    """A timing CUDA event's interface on a clock of whole milliseconds; it
    completes at once unless the class holds it back, and, like a CUDA
    event, serves only the card of the stream it was first recorded on."""

    clock = itertools.count()
    held = False
    built = 0

    def __init__(self):
        FakeEvent.built += 1
        self.t, self.done, self.card = None, False, None

    def record(self, stream):
        if self.card not in (None, stream.device_index):
            raise RuntimeError("an event recorded on another card's stream")
        self.card = stream.device_index
        self.t, self.done = next(FakeEvent.clock), not FakeEvent.held

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        return float(end.t - self.t)


@pytest.fixture
def fake_device(monkeypatch):
    """Spans on without a profiler, device ranges on fake events and
    streams (``cuda`` alone is card 0); the registry empty before and
    after."""
    monkeypatch.setattr(tracing, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(tracing, "_new_event", FakeEvent)
    monkeypatch.setattr(tracing, "_current_stream", lambda dev: FakeStream(dev.index or 0))
    monkeypatch.setattr(tracing, "_free", {})
    monkeypatch.setattr(FakeEvent, "held", False)
    monkeypatch.setattr(FakeEvent, "built", 0)
    tracing.reset()
    yield
    tracing.reset()


def test_device_ranges_fold_nest_and_reuse_their_events(fake_device):
    for _ in range(5):
        with tracing.span("train/step", device=CARD):
            with tracing.span("train/forward", device=CARD):
                pass
    assert len(tracing._pending) == 10  # nothing folds on the way
    totals = tracing.device_totals()
    assert totals["train/forward"] == (5, 5.0)  # start and end one tick apart
    assert totals["train/step"][0] == 5 and totals["train/step"][1] == 5 * 3.0
    assert FakeEvent.built == 20 and len(tracing._pending) == 0
    for _ in range(5):  # the folded events are recorded again
        with tracing.span("train/step", device=CARD):
            pass
    assert tracing.device_totals()["train/step"][0] == 10 and FakeEvent.built == 20
    with tracing.span("serve/forward", device=torch.device("cpu")):  # a host range only
        pass
    assert "serve/forward" not in tracing.device_totals()
    with tracing.span("train/step", device=CARD):
        pass
    tracing.reset()  # a range in flight goes back to the pool
    assert tracing.device_totals() == {} and len(tracing._free[0]) == 20


def test_registry_stays_bounded_and_reset_clears_it(fake_device, monkeypatch):
    monkeypatch.setattr(tracing, "MAX_PENDING", 4)
    FakeEvent.held = True  # the device never catches up on the way
    for _ in range(10):
        with tracing.span("train/step", device=CARD):
            pass
    assert len(tracing._pending) == 4 and tracing.dropped() == 6
    assert FakeEvent.built == 8
    FakeEvent.held = False
    tracing._pending[0][3].synchronize()  # the oldest range ends: the next one folds it
    with tracing.span("train/step", device=CARD):
        pass
    assert len(tracing._pending) == 4 and tracing.dropped() == 6
    assert tracing._totals["train/step"][0] == 1 and FakeEvent.built == 8
    FakeEvent.held = True
    assert tracing.device_totals() == {"train/step": (5, 5.0)}  # waits once, folds all
    tracing.reset()
    assert tracing.device_totals() == {} and tracing.dropped() == 0
    assert len(tracing._pending) == 0


@pytest.mark.parametrize("cards", [(0, 1), (2, 0)], ids=["current_first", "other_first"])
def test_device_range_records_on_its_own_cards_stream(fake_device, cards):
    """A range on ``cuda:N`` records on card N's current stream, whichever
    card is current, with events from card N's pool: ranges on two cards in
    turn fold apart and reuse their own events, none on another card."""
    for rounds in (1, 2, 3):
        for card in cards:
            with tracing.span("serve/forward", device=torch.device("cuda", card)):
                pass
        assert tracing.device_totals() == {"serve/forward": (2 * rounds, 2.0 * rounds)}
    assert FakeEvent.built == 4
    assert sorted(tracing._free) == sorted(cards)
    for card, events in tracing._free.items():
        assert len(events) == 2 and {e.card for e in events} == {card}
