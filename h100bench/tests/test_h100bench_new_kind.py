"""A kind of cell the harness has not run before comes in as new files only.

In a copy of ``h100bench/`` and ``BENCHMARK.json`` a toy kind is added as
new files: a driver ``drive_toy.py`` whose program is one plain torch op (a
row-wise softmax of a product, float32) with a plain float64 NumPy
reference, its mix, its configuration (one cut written down in
``reduced``), its limits and a per-layer reader; entries are appended to the
copy's ``BENCHMARK.json``.  The copy's ``run`` (traced and untraced) and
``control`` take the toy cell, a fault planted in the toy program reads
``correct`` false, the copy's files test passes, and no file that was in the
copy before changed.  The files test refuses a kind with no driver, a cut of
a key the configuration does not hold, and a second four-chip cell among
fewer than eight."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from h100bench import drivers

ROOT = Path(__file__).resolve().parents[2]
CELL = "toy.toy"

DRIVER = '''"""The toy kind: the program is ``softmax(x @ w)`` over rows in float32,
the reference the same in float64 with NumPy, the control the reference in
bfloat16."""

import time

import numpy as np
import torch

from h100bench import checks
from h100bench.outcome import Outcome


def _inputs(cell, seed, device):
    gen = torch.Generator(device).manual_seed(seed)
    x = torch.randn(cell.mix["rows"], cell.mix["width"], generator=gen, device=device)
    w = torch.randn(cell.mix["width"], cell.config["features"], generator=gen, device=device)
    return x, w


def program(x, w):
    return torch.softmax(x @ w, dim=-1)


def reference(x, w):
    z = x.double().numpy() @ w.double().numpy()
    z = np.exp(z - z.max(axis=-1, keepdims=True))
    return z / z.sum(axis=-1, keepdims=True)


def numbers(have, x, w):
    return {"max_gap": float(np.abs(have.double().numpy() - reference(x, w)).max())}


def run(cell, seed, seconds, trace, device, t_start, log):
    x, w = _inputs(cell, seed, device)
    program(x, w)
    t0 = time.perf_counter()
    n, busy = 0, 0.0
    while True:
        ts = time.perf_counter()
        y = program(x, w)
        busy += time.perf_counter() - ts
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window = time.perf_counter() - t0
    o = Outcome(attempted=n, failed=0)
    o.e2e = {"serve_img_per_s": n * x.shape[0] / window, "setup_s": t0 - t_start}
    if trace:
        o.ctx["toy_share"] = 100.0 * busy / window
    o.readings = numbers(y, x, w)
    o.checks = checks.judge(o.readings, cell.limits)
    return o


def control_readings(cell, seed, device, witness=False):
    x, w = _inputs(cell, seed, device)
    low = torch.softmax((x.bfloat16() @ w.bfloat16()).float(), dim=-1)
    return {"control": numbers(low, x, w)}


def program_readings(cell, seed, device, seconds):
    out = run(cell, seed, seconds, False, device, time.perf_counter(), lambda msg: None)
    return {"program": out.readings}
'''

READER = '''"""toy_share: the window's share inside the toy program, in %."""


def read(ctx):
    return ctx.get("toy_share")
'''

MIX = {"kind": "toy", "rows": 1024, "width": 64, "trace_steps": 2,
       "cpu_dry_run": {"rows": 256}}
CONFIG = {"name": "toy", "source": "https://pytorch.org/docs/stable/generated/torch.softmax.html",
          "features": 32, "layers": 1, "reduced": ["layers"], "published": {"layers": 12},
          "deployment": "one layer of twelve here, the other eleven as pipeline stages elsewhere"}
LIMITS = {"numbers": {"max_gap": {"limit": 1e-4, "lower": 1e-7, "upper": 1e-3,
                                  "from": "float32 against float64; the bfloat16 control"}}}


def _add_toy(bench):
    """The toy cell's entries, appended to a copy of ``BENCHMARK.json``: its
    one cell on four chips, the one such cell three cells allow."""
    bench["configs"].append({"name": "toy", "source": CONFIG["source"],
                             "file": "h100bench/configs/toy.json", "reduced": ["layers"],
                             "why": "a row-wise softmax of a product"})
    bench["workloads"].append({"name": CELL, "config": "toy", "traffic": "toy", "chips": 4,
                               "why": "a kind of cell added as new files only"})
    next(m for m in bench["end_to_end"] if m["name"] == "serve_img_per_s")["workloads"].append(CELL)
    bench["per_layer"].append({"name": "toy_share", "unit": "%", "better": "lower",
                               "source": "program_counter", "layer": "toy",
                               "moves": "serve_img_per_s", "workloads": [CELL]})
    return bench


def _copy(dest: Path, driver=DRIVER, mix=MIX, config=CONFIG, edit=None):
    """``h100bench/`` and ``BENCHMARK.json`` copied to ``dest``, the hashes of
    the copied files, then the toy's new files and entries added."""
    shutil.copytree(ROOT / "h100bench", dest / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    hashes = {p: hashlib.sha256(p.read_bytes()).hexdigest()
              for p in (dest / "h100bench").rglob("*") if p.is_file()}
    here = dest / "h100bench"
    new = {here / "drive_toy.py": driver, here / "metrics" / "toy_share.py": READER,
           here / "traffic" / "toy.json": json.dumps(mix),
           here / "configs" / "toy.json": json.dumps(config),
           here / "workloads" / f"{CELL}.json": json.dumps(LIMITS)}
    for path, text in new.items():
        assert not path.exists()
        path.write_text(text)
    bench = _add_toy(json.loads((dest / "BENCHMARK.json").read_text()))
    if edit:
        edit(bench)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return hashes


def _py(cwd: Path, *args):
    env = dict(os.environ, PYTHONPATH=str(cwd))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=120)


def _run(cwd: Path, trace: int, seed=2**31 + 13):
    out = _py(cwd, "-m", "h100bench.run", "--workload", CELL, "--seed", str(seed),
              "--seconds", "0.3", "--trace", str(trace), "--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _files_test(cwd: Path):
    return _py(cwd, "-m", "pytest", "-q", "-p", "no:cacheprovider",
               "h100bench/tests/test_h100bench_files.py")


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    dest = tmp_path_factory.mktemp("with_toy")
    return dest, _copy(dest)


@pytest.mark.parametrize("trace", [0, 1])
def test_the_toy_kind_runs_through_run(toy, trace):
    res = _run(toy[0], trace)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert res["correct"] is True and res["attempted"] > 0 and res["failed"] == 0
    assert set(res["compared"]) == {"max_gap"}
    want = {"toy_share"} if trace else {"serve_img_per_s", "setup_s"}
    assert set(res["metrics"]) == want


def test_a_fault_planted_in_the_toy_program_is_caught(tmp_path):
    faulty = DRIVER.replace("torch.softmax(x @ w, dim=-1)", "torch.softmax(x @ w, dim=0)")
    assert faulty != DRIVER  # each answer altered where it is produced
    _copy(tmp_path, driver=faulty)
    res = _run(tmp_path, 0)
    assert res["correct"] is False
    assert res["compared"]["max_gap"]["value"] > res["compared"]["max_gap"]["limit"]


def test_the_toy_kind_runs_through_control(toy):
    for extra in ([], ["--program", "--seconds", "0.1"]):
        out = _py(toy[0], "-m", "h100bench.control", "--workload", CELL, "--seeds", "5,2147483659",
                  "--device", "cpu", *extra)
        assert out.returncode == 0, out.stderr[-2000:]
        lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
        assert [x["seed"] for x in lines] == [5, 2147483659]
        limit = LIMITS["numbers"]["max_gap"]["limit"]
        for x in lines:
            if extra:
                assert x["program"]["max_gap"] <= limit
            else:
                assert x["control"]["max_gap"] > limit


def test_the_copy_passes_its_files_test_and_no_old_file_changed(toy):
    dest, hashes = toy
    out = _files_test(dest)
    assert out.returncode == 0, out.stdout[-3000:]
    changed = [str(p) for p, h in hashes.items()
               if not p.is_file() or hashlib.sha256(p.read_bytes()).hexdigest() != h]
    assert not changed
    old = json.loads((ROOT / "BENCHMARK.json").read_text())
    new = json.loads((dest / "BENCHMARK.json").read_text())
    for group in ("configs", "workloads", "per_layer"):
        assert new[group][:len(old[group])] == old[group]


@pytest.mark.parametrize("kind", ["toy_missing", "../drive_serve", "Serve"])
def test_an_unknown_kind_stops_naming_the_drivers_found(kind):
    with pytest.raises(SystemExit, match=r"drive_serve\.py', 'drive_train\.py"):
        drivers.load(kind)


def _second_four_chip_cell(bench):
    bench["workloads"][0]["chips"] = 4


@pytest.mark.parametrize("fault,failing", [
    ("kind_without_driver", f"test_cell_loads_by_name[{CELL}]"),
    ("cut_of_a_key_not_held", f"test_cell_loads_by_name[{CELL}]"),
    ("second_four_chip_cell", "test_names_units_and_bounds")])
def test_the_files_test_refuses(fault, failing, tmp_path):
    if fault == "kind_without_driver":
        _copy(tmp_path, mix=dict(MIX, kind="toy_missing"))
    elif fault == "cut_of_a_key_not_held":
        _copy(tmp_path, config=dict(CONFIG, reduced=["heads"]),
              edit=lambda b: b["configs"][-1].update(reduced=["heads"]))
    else:
        _copy(tmp_path, edit=_second_four_chip_cell)
    out = _files_test(tmp_path)
    assert out.returncode == 1, out.stdout[-3000:]
    failed = [x for x in out.stdout.splitlines() if x.startswith("FAILED ")]
    assert len(failed) == 1 and f"::{failing} " in failed[0] + " ", out.stdout[-3000:]
