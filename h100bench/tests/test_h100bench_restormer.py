"""The Restormer cell on the CPU at its ``cpu_dry_run`` size (B=2·32×48, the
network at its published widths): traced and untraced, the last line keeps
its shape and reads ``correct``, the served forward's counters a batch in
its log; each fault planted in the program (the input served, the attention
transposed, the gate swapped) reads ``correct`` false; ``control`` and
``control --program`` take the cell, and the control and every stand-in
fault fail a limit; the reference loads neither the port nor JAX."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from h100bench import cell as cells
from h100bench import checks, drive_restormer_serve, run

ROOT = Path(__file__).resolve().parents[2]
CELL = "restormer_noise.serve_vga_b4"


def _result(capsys, seed=2**31 + 11, trace=0):
    rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds", "0.3",
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
    assert set(res["compared"]) == {"mean_gap.vs_bf16", "image_gap.vs_bf16"}
    if trace:  # the span and device readers find nothing on the CPU
        assert set(res["metrics"]) == {"restormer_mfu.serve"}
    else:
        assert set(res["metrics"]) == {"serve_img_per_s", "serve_p95_ms", "setup_s"}
    assert "the served forward's counters a batch {'mdta_calls': 44.0, 'gdfn_calls': 44.0}" in err


def _unchanged(monkeypatch):
    from multi_degradation_image_enhancement_tpu_torch.models import restormer

    monkeypatch.setattr(restormer.ServingForward, "__call__", lambda self, x: x.float())


def _attention_transposed(monkeypatch):
    from multi_degradation_image_enhancement_tpu_torch.models import restormer

    attend = restormer.channel_attention
    monkeypatch.setattr(restormer, "channel_attention",
                        lambda q, k, v, t, heads: attend(k, q, v, t, heads))


def _gate_swapped(monkeypatch):
    from multi_degradation_image_enhancement_tpu_torch.models import restormer

    gate = restormer.gated_gelu
    monkeypatch.setattr(restormer, "gated_gelu", lambda a, g: gate(g, a))


@pytest.mark.parametrize("plant", [_unchanged, _attention_transposed, _gate_swapped],
                         ids=list(drive_restormer_serve.FAULTS))
def test_a_fault_planted_in_the_program_is_caught(capsys, monkeypatch, plant):
    plant(monkeypatch)
    res, _ = _result(capsys)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["compared"].values())


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
    kinds = ("control", *drive_restormer_serve.FAULTS)
    assert got["seed"] == 1 and set(got) - {"workload", "seed"} == set(kinds)
    for kind in kinds:
        assert [c.name for c in checks.judge(got[kind], cell.limits) if not c.ok], kind


def test_control_reads_the_programs_own_numbers():
    cell = cells.load(CELL, cpu_dry_run=True)
    got = _control("--program", "--seconds", "0.2")
    assert all(c.ok for c in checks.judge(got["program"], cell.limits))


def test_the_reference_loads_neither_the_port_nor_jax():
    code = ("import json, sys\nimport h100bench.reference.restormer\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "multi_degradation_image_enhancement_tpu",
                         "multi_degradation_image_enhancement_tpu_torch"}
