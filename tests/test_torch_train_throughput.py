"""The port's training-throughput script (``benchmarks/train_throughput.py``)
on the CPU at B=2·32×48: its rows, and its step is the engine's."""

import json
import math

import torch

from multi_degradation_image_enhancement_tpu_torch.benchmarks import train_throughput
from multi_degradation_image_enhancement_tpu_torch.engine.model import Model
from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN
from multi_degradation_image_enhancement_tpu_torch.utils.config import load_config
from tests.torch_train_cli import write_tiny_config

HW = (32, 48)


def test_rows_write_their_json(tmp_path):
    out = tmp_path / "tt.json"
    rc = train_throughput.main(["--device", "cpu", "--rows", "b16,b16_fused", "--batch", "2",
                                "--hw", *map(str, HW), "--chunk", "2", "--iters", "1",
                                "--json-out", str(out)])
    assert rc == 0
    got = json.loads(out.read_text())
    assert got["device"] == "cpu"
    for name, fused in (("b16", False), ("b16_fused", True)):
        row = got[name]
        assert "error" not in row, row
        assert (row["batch"], row["fused_dense"], row["remat"]) == (2, fused, False)
        assert row["hw"] == list(HW) and row["chunk"] == 2 and row["precision"] == "fp32"
        assert row["step_ms"] > 0 and row["img_s"] > 0 and math.isfinite(row["last_loss"])
        assert row["growth_launches"] == {"fwd": 0, "bwd": 0}  # the CPU counts no launch


def test_a_failing_row_is_recorded_and_all_failing_exits_1(tmp_path, monkeypatch):
    def fail(*args, **kw):
        raise RuntimeError("out of memory (simulated)")

    monkeypatch.setattr(train_throughput, "measure", fail)
    out = tmp_path / "tt.json"
    assert train_throughput.main(["--device", "cpu", "--rows", "b64", "--json-out",
                                  str(out)]) == 1
    assert json.loads(out.read_text())["b64"]["error"] == "out of memory (simulated)"


def test_fused_step_loss_is_the_engines(tmp_path):
    """One fused step from the script's row against the engine's train step
    (``Model`` on the tiny noise config: Flax init from ``train.seed``,
    ``fused_dense``, fp32 on the CPU) on the same batch and dropout: the same
    loss, bit for bit."""
    config = load_config(str(write_tiny_config(tmp_path)), phase="train")
    engine = Model(network=CDAN(), config=config, dataloader=None)
    assert engine.network.fused_dense
    step, state, x, y, precision = train_throughput.build_row(2, True, False, HW,
                                                              torch.device("cpu"), engine.seed)
    assert precision == engine.precision == "fp32"
    got = step(state, x, y, torch.Generator().manual_seed(1))
    want = engine._train_step(engine.state, x, y, torch.Generator().manual_seed(1))
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), (k, float(got[k]), float(want[k]))
