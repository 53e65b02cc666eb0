"""The routed cell on the CPU at its ``cpu_dry_run`` size (B=9·32×48):
traced and untraced, the last line keeps its shape and reads ``correct``,
the router's counters a batch in its log; each fault planted in the program
reads ``correct`` false (every row restored by the next expert, one row of
each answer passed through, and, on a skewed batch, routes that ignore the
capacity); ``control`` and ``control --program`` take the cell; and configurations
that share their source and their cuts, the mark by which a new
configuration is told from an old one renamed, are one model."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from h100bench import cell as cells
from h100bench import checks, drive_routed, run, weights_routed

ROOT = Path(__file__).resolve().parents[2]
CELL = "routed9.serve_b32"
CPU = torch.device("cpu")


def _result(capsys, seed=2**31 + 7, trace=0):
    rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds", "0.5",
                   "--trace", str(trace), "--device", "cpu"])
    out, err = capsys.readouterr()
    assert rc == 0, err[-2000:]
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("trace", [0, 1])
def test_the_dry_run_is_correct_and_well_formed(capsys, trace):
    res, err = _result(capsys, trace=trace)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "compared"
    assert res["correct"] is True and res["attempted"] > 0 and res["failed"] == 0
    assert set(res["compared"]) == {"route_miss", "mean_gap", "image_gap.vs_bf16", "prob_gap"}
    if trace:  # the span and device readers find nothing on the CPU
        assert set(res["metrics"]) == {"routed_mfu"}
    else:
        assert set(res["metrics"]) == {"serve_img_per_s", "serve_p95_ms", "setup_s"}
    assert ("the router's counters a batch {'expert_calls': 9.0, 'routed_rows': 9.0, "
            "'dropped_rows': 0.0, 'clean_rows': 0.0}") in err


def _wrong_expert(monkeypatch):
    from multi_degradation_image_enhancement_tpu_torch import run_pipeline

    load = run_pipeline.load_expert_bank

    def rotated(*args, **kwargs):  # expert e's rows restored by expert (e + 1) mod 9
        names, forwards = load(*args, **kwargs)
        return names, forwards[1:] + forwards[:1]

    monkeypatch.setattr(run_pipeline, "load_expert_bank", rotated)


def _one_unrestored(monkeypatch):
    from multi_degradation_image_enhancement_tpu_torch.pipeline import FullPipeline

    call = FullPipeline.__call__

    def last_row_passed_through(self, images01):
        out, probs = call(self, images01)
        out = out.clone()
        out[-1] = images01[-1]
        return out, probs

    monkeypatch.setattr(FullPipeline, "__call__", last_row_passed_through)


@pytest.mark.parametrize("plant", [_wrong_expert, _one_unrestored],
                         ids=["wrong_expert", "one_unrestored"])
def test_a_fault_planted_in_the_program_is_caught(capsys, monkeypatch, plant):
    plant(monkeypatch)
    res, _ = _result(capsys)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["compared"].values())


def test_routes_that_ignore_the_capacity_are_caught_on_a_skewed_batch(tmp_path, monkeypatch):
    """Every row of one family in a batch: the program's routes with the
    capacity ignored (every row to its argmax) against the reference's."""
    from multi_degradation_image_enhancement_tpu_torch.pipeline import RoutedRestorer
    from multi_degradation_image_enhancement_tpu_torch.run_pipeline import build_full_pipeline

    cell = cells.load(CELL, cpu_dry_run=True)
    s = drive_routed.prepare(cell, 2**31 + 5, CPU)
    own = torch.cat(s.pool)[s.family == 4]
    s.pool = [own[torch.arange(9) % own.shape[0]]]
    path = weights_routed.write_files(str(tmp_path), s.experts, s.names, s.classifier)
    monkeypatch.setattr(RoutedRestorer, "capacity", lambda self, batch: batch)
    pipe = build_full_pipeline(path, str(tmp_path), "top1", device="cpu")
    out, probs = pipe(s.pool[0])
    got = {0: (0, out, probs, pipe.router.route(probs, pipe.thresholds).tolist())}
    values = drive_routed.routed_numbers(s, got)["program"]
    assert values["route_miss"] == pytest.approx(7 / 9)  # capacity 2 of 9 rows
    failed = [c.name for c in checks.judge(values, cell.limits) if not c.ok]
    assert "route_miss" in failed


def _control(*extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-m", "h100bench.control", "--workload", CELL,
                          "--seeds", "1", "--device", "cpu", *extra], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_control_and_every_stand_in_fault_fail_a_limit():
    cell = cells.load(CELL, cpu_dry_run=True)
    got = _control()
    assert got["seed"] == 1 and set(got) - {"workload", "seed"} == {"control",
                                                                    *drive_routed.FAULTS}
    for kind in ("control", *drive_routed.FAULTS):
        assert [c.name for c in checks.judge(got[kind], cell.limits) if not c.ok], kind


def test_control_reads_the_programs_own_numbers():
    cell = cells.load(CELL, cpu_dry_run=True)
    got = _control("--program", "--seconds", "0.2")
    assert all(c.ok for c in checks.judge(got["program"], cell.limits))


def test_a_configuration_that_shares_a_source_and_cuts_is_the_same_model():
    """Configurations with the same ``source`` and ``reduced`` are one model
    (the same ``model`` in their files) under other recipes, as ``cdan_jpeg``
    is ``cdan_noise``'s CDAN under the jpeg recipe; a new model brings a
    source of its own (the routed pipeline's is the classifier's script)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    first = {}
    for c in bench["configs"]:
        model = json.loads((ROOT / c["file"]).read_text())["model"]
        mark = (c["source"], tuple(sorted(c["reduced"])))
        assert first.setdefault(mark, (c["name"], model))[1] == model, (c["name"], first[mark][0])
