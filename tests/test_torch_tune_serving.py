"""The port's serving tuner (``benchmarks/tune_serving.py``) on the CPU at
B=2·32², and the serving tuning the port reads: its own file, never the JAX
package's."""

import builtins
import json
import math
import re

import torch

from multi_degradation_image_enhancement_tpu_torch.benchmarks import tune_serving
from multi_degradation_image_enhancement_tpu_torch.models import cdan_fast
from tests.torch_train_cli import ROOT

PORT_DIR = ROOT / "multi_degradation_image_enhancement_tpu_torch"
KEYS = tune_serving.KEYS
ARGS = ["--device", "cpu", "--batch", "2", "--size", "32", "--iters", "1"]


def _variant(r) -> bool:
    return r["db_bf16_act"]


def test_writes_the_winner_and_every_variant(tmp_path):
    out = tmp_path / "tuning.json"
    assert tune_serving.main(ARGS + ["--out", str(out)]) == 0
    cfg = json.loads(out.read_text())
    prov = cfg["provenance"]["forward_variants"]
    results = prov["results"]
    assert [_variant(r) for r in results] == list(tune_serving.VARIANTS)
    assert all(r["sane"] and r["ms_per_step"] > 0 and len(r["ms_turns"]) == 2 for r in results)
    assert results[0]["maxdiff_vs_baseline_variant"] == 0.0
    best = min(results, key=lambda r: r["ms_per_step"])
    assert {k: cfg[k] for k in KEYS} == {k: best[k] for k in KEYS}
    assert prov["device"] == "cpu" and prov["batch"] == 2 and prov["size"] == 32
    assert all(r["db_k_stack_max_ci"] == tune_serving.K_STACK for r in results)


def test_keeps_keys_other_tuners_own(tmp_path):
    out = tmp_path / "tuning.json"
    out.write_text(json.dumps({"db_bf16_act": False, "fused_noise": True,
                               "provenance": {"fused_noise": {"script": "another tuner"}}}))
    assert tune_serving.main(ARGS + ["--out", str(out)]) == 0
    cfg = json.loads(out.read_text())
    assert cfg["fused_noise"] is True
    assert cfg["provenance"]["fused_noise"] == {"script": "another tuner"}
    assert "forward_variants" in cfg["provenance"] and set(KEYS) <= set(cfg)


def _patched_builder(monkeypatch, garbage):
    """``build_step`` whose steps record their variant when called, the
    variants ``garbage`` picks returning ``garbage(out)``; the CPU timer reads
    1 ms for a garbage variant and 2 ms for the rest, so garbage is fastest."""
    build, last = tune_serving.build_step, []

    def build_step(batch, size, dtype, device, variant):
        step, clean = build(batch, size, dtype, device, variant)
        bad = garbage(variant)

        def wrapped(c, gen):
            last.append(bad)
            out = step(c, gen)
            return bad(out) if bad else out
        return wrapped, clean

    def host_ms(fn, reps, warmup=1):
        fn()
        return 1.0 if last[-1] else 2.0

    monkeypatch.setattr(tune_serving, "build_step", build_step)
    monkeypatch.setattr("multi_degradation_image_enhancement_tpu_torch.benchmarks.host_ms", host_ms)


def test_a_garbage_variant_is_excluded(tmp_path, monkeypatch):
    garbage_of = True  # bf16 activations: not the baseline
    _patched_builder(monkeypatch, lambda v: (lambda out: out + 1.0)
                     if _variant(v) == garbage_of else None)
    out = tmp_path / "tuning.json"
    assert tune_serving.main(ARGS + ["--out", str(out)]) == 0
    results = json.loads(out.read_text())["provenance"]["forward_variants"]["results"]
    bad = next(r for r in results if _variant(r) == garbage_of)
    assert not bad["sane"] and bad["maxdiff_vs_baseline_variant"] >= 1.0 - 1e-6
    assert bad["ms_per_step"] == 1.0  # the fastest, and still not the winner
    cfg = json.loads(out.read_text())
    assert cfg["db_bf16_act"] is False  # the first sane at 2 ms
    assert all(r["sane"] for r in results if r is not bad)


def test_no_sane_variant_leaves_the_file_untouched(tmp_path, monkeypatch):
    _patched_builder(monkeypatch, lambda v: (lambda out: torch.full_like(out, math.nan)))
    out = tmp_path / "tuning.json"
    out.write_text('{"db_bf16_act": false}\n')
    before = out.read_bytes()
    assert tune_serving.main(ARGS + ["--out", str(out)]) == 1
    assert out.read_bytes() == before


def test_dry_run_writes_nothing(tmp_path):
    out = tmp_path / "tuning.json"
    assert tune_serving.main(ARGS + ["--out", str(out), "--dry-run"]) == 0
    assert not out.exists()


def test_loader_reads_the_ports_file_never_the_jax_one(monkeypatch):
    assert cdan_fast._TUNING_PATH == PORT_DIR / "config" / "serving_tuning.json"
    monkeypatch.delenv(cdan_fast.TUNING_ENV, raising=False)
    opened, real_open = [], builtins.open

    def recording_open(file, *args, **kw):
        opened.append(str(file))
        return real_open(file, *args, **kw)

    monkeypatch.setattr(builtins, "open", recording_open)
    tuning = cdan_fast.serving_tuning()
    assert opened == [str(cdan_fast._TUNING_PATH)]
    assert not any("multi_degradation_image_enhancement_tpu/" in p for p in opened)
    shipped = json.loads(cdan_fast._TUNING_PATH.read_text())
    assert tuning == {k: shipped[k] for k in KEYS}


def test_shipped_tuning_file_is_the_cards_or_says_not_measured():
    cfg = json.loads(cdan_fast._TUNING_PATH.read_text())
    assert set(cfg) == {*KEYS, "provenance"}
    assert isinstance(cfg["db_bf16_act"], bool)
    prov = cfg["provenance"]["forward_variants"]
    if isinstance(prov, str):
        assert prov == "not measured on a card"
        assert {k: cfg[k] for k in KEYS} == {"db_bf16_act": False, "db_k_stack_max_ci": 56}
        return
    assert "NVIDIA" in prov["device"] and re.fullmatch(r"\d+(\.\d+)? W", prov["power_limit"])
    assert prov["script"] == tune_serving.SCRIPT and prov["dtype"] == "bfloat16"
    results = prov["results"]
    # the sweep that wrote the file held every variant the tuner now sweeps
    assert set(tune_serving.VARIANTS) <= {_variant(r) for r in results}
    assert all(r["ms_per_step"] > 0 for r in results)
    best = min((r for r in results if r["sane"]), key=lambda r: r["ms_per_step"])
    assert {k: cfg[k] for k in KEYS} == {k: best[k] for k in KEYS}
