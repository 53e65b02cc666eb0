"""The port's headline bench (``multi_degradation_image_enhancement_tpu_torch.bench``)
on the CPU: one JSON line with the JAX bench's metric and unit, the CPU smoke
only when asked for, the error line without a card, the best-so-far line once
on SIGTERM, and the forward it reports following the serving tuning file."""

import json
import os
import signal
import subprocess
import sys

from tests.torch_train_cli import ROOT

MODULE = "multi_degradation_image_enhancement_tpu_torch.bench"
METRIC = "256px_images_per_sec_per_chip_degrade_restore"  # the root bench.py's


def _env(**extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1", **extra)
    if "MDIE_SERVING_TUNING" not in extra:
        env.pop("MDIE_SERVING_TUNING", None)
    return env


def _bench(*args, **env):
    proc = subprocess.run([sys.executable, "-m", MODULE, *args], capture_output=True, text=True,
                          timeout=240, cwd=ROOT, env=_env(**env))
    lines = proc.stdout.splitlines()
    assert len(lines) == 1, (proc.stdout, proc.stderr[-2000:])
    return proc.returncode, json.loads(lines[0]), proc.stderr


def test_cpu_smoke_prints_one_line():
    rc, line, err = _bench("--device", "cpu")
    assert rc == 0, err[-2000:]
    assert line["metric"] == METRIC and line["unit"] == "img/s/chip"
    assert line["value"] > 0 and line["timing_method"] == "host_loop"
    assert line["device"] == "cpu" and line["batch"] == 2 and line["size"] == 64
    assert "vs_baseline" not in line and "note" not in line


def test_without_a_card_it_fails_with_the_error():
    rc, line, _ = _bench()
    assert rc != 0
    assert line["metric"] == METRIC and line["value"] == 0
    assert "no CUDA device" in line["note"]


_SIGTERM_RUN = r"""
import sys, time
from multi_degradation_image_enhancement_tpu_torch import bench
record = bench.Result.record
def record_then_wait(self, rate, **kw):  # the first record, then work still in flight
    record(self, rate, **kw)
    print("recorded", file=sys.stderr, flush=True)
    time.sleep(120)
bench.Result.record = record_then_wait
sys.exit(bench.main(["--device", "cpu"]))
"""


def test_sigterm_prints_the_best_so_far_once():
    proc = subprocess.Popen([sys.executable, "-c", _SIGTERM_RUN], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT, env=_env())
    try:
        for err_line in proc.stderr:
            if err_line.strip() == "recorded":
                break
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        proc.kill()
    lines = out.splitlines()
    assert len(lines) == 1, (out, err)
    line = json.loads(lines[0])
    assert line["metric"] == METRIC and line["value"] > 0
    assert f"signal {int(signal.SIGTERM)}" in err
    assert proc.returncode == 0


def test_reported_forward_follows_the_tuning_file(tmp_path):
    tuning = tmp_path / "tuning.json"
    tuning.write_text(json.dumps({"db_bf16_act": True, "db_k_stack_max_ci": 40}))
    rc, line, err = _bench("--device", "cpu", MDIE_SERVING_TUNING=str(tuning))
    assert rc == 0, err[-2000:]
    assert (line["db_bf16_act"], line["db_k_stack_max_ci"]) == (True, 40)
    tuning.write_text(json.dumps({}))
    rc, line, err = _bench("--device", "cpu", MDIE_SERVING_TUNING=str(tuning))
    assert rc == 0, err[-2000:]
    assert (line["db_bf16_act"], line["db_k_stack_max_ci"]) == (False, 0)
