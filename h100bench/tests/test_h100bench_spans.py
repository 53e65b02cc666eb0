"""The benchmark's five readers of the program's device ranges
(``h100bench/metrics/_spans.py``): None without a trace, or where the
program recorded no range; else the share of their ranges' device ms."""

from types import SimpleNamespace

import pytest

from h100bench import traces
from multi_degradation_image_enhancement_tpu_torch.utils import tracing

READERS = {  # metric -> (the ranges it sums, the range it divides by)
    "upsample_share.serve": (("cdan/upsample",), "serve/forward"),
    "cbam_share.serve": (("cdan/cbam",), "serve/forward"),
    "forward_share.train": (("train/forward",), "train/step"),
    "backward_share.train": (("train/backward",), "train/step"),
    "perceptual_share.step": (("loss/vgg_perceptual", "loss/lpips"), "train/step"),
}


def test_span_readers_find_nothing_without_a_trace_or_ranges(monkeypatch):
    readers = traces.load_readers(list(READERS))
    assert all(fn({"kind": "serve"}) is None for fn in readers.values())
    monkeypatch.setattr(tracing, "device_totals", lambda: {})
    ctx = {"trace": SimpleNamespace(busy_s=0.0, steps=1), "host_trace": None}
    assert all(fn(dict(ctx)) is None for fn in readers.values())


@pytest.mark.parametrize("metric", list(READERS))
def test_span_reader_gives_its_share(metric, monkeypatch, capsys):
    totals = {"serve/forward": (40, 1000.0), "cdan/upsample": (120, 350.0),
              "cdan/cbam": (160, 70.0), "train/step": (20, 3600.0),
              "train/forward": (20, 900.0), "train/loss": (20, 600.0),
              "train/backward": (20, 2000.0), "loss/vgg_perceptual": (20, 150.0),
              "loss/lpips": (20, 210.0)}
    monkeypatch.setattr(tracing, "device_totals", lambda: dict(totals))
    parts, whole = READERS[metric]
    want = 100.0 * sum(totals[p][1] for p in parts) / totals[whole][1]
    trace = SimpleNamespace(busy_s=0.5, window_s=0.52, steps=20)
    ctx = {"trace": trace, "host_trace": trace}
    (read,) = traces.load_readers([metric]).values()
    assert read(ctx) == pytest.approx(want)
    assert "[h100bench] program spans" in capsys.readouterr().err
    del totals[whole]
    assert read({"trace": trace, "host_trace": trace}) is None
