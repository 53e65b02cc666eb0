"""PyTorch port hygiene: it imports and runs a CPU serving step, the CPU
training and test CLI, the CPU serving pipeline CLI, the classifier trainer
and the two dataset generators with JAX blocked, refuses CUDA without a card, counts no launch on the plain path, refuses to
run its inference kernels under autograd, and its C entry points match the
CUDA sources."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from multi_degradation_image_enhancement_tpu_torch import run_pipeline, serving
from multi_degradation_image_enhancement_tpu_torch.benchmarks import exp_int8_reprobe
from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN
from multi_degradation_image_enhancement_tpu_torch.models.cdan_fast import build_fast_apply
from multi_degradation_image_enhancement_tpu_torch.ops.cuda import _build
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.conv_cm import (
    conv3x3,
    conv3x3_pool,
    pack_conv,
)
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.dense_block import (
    dense_block,
    pack_dense_block,
)
from multi_degradation_image_enhancement_tpu_torch.engine.model import resolve_device
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.growth_train import (
    growth_layer_bwd,
    growth_layer_fwd,
)
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.noise import noise_degrade_01
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.probe_matmul import probe_matmul
from multi_degradation_image_enhancement_tpu_torch.ops.cuda.probe_transpose import (
    m_dot_xt,
    transpose,
    xt_dot_m,
)
from tests.torch_pipeline_cli import cli_args, write_tiny_pipeline
from multi_degradation_image_enhancement_tpu_torch.classification import train as classifier_train
from multi_degradation_image_enhancement_tpu_torch.datasets_generation import (
    generate_classifier,
    generate_paired,
)
from tests.torch_train_cli import (
    check_tiny_run,
    check_tiny_test_run,
    write_clean_pngs,
    write_tiny_config,
)

ROOT = Path(__file__).resolve().parents[1]
PKG_DIR = ROOT / "multi_degradation_image_enhancement_tpu_torch"

_BLOCKED_RUN = r"""
import importlib, json, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "multi_degradation_image_enhancement_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
sys.path.insert(0, sys.argv[1])
import torch
import multi_degradation_image_enhancement_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
from multi_degradation_image_enhancement_tpu_torch import serving
step, clean = serving.build_pipeline(2, 16, torch.float32, "cpu")
out = step(clean, torch.Generator().manual_seed(0))
assert out.shape == (2, 16, 16, 3) and out.dtype == torch.float32
assert bool(torch.isfinite(out).all()) and 0.0 <= float(out.min()) and float(out.max()) <= 1.0
from multi_degradation_image_enhancement_tpu_torch import run, run_pipeline
from multi_degradation_image_enhancement_tpu_torch.utils.config import load_config
job = json.loads(sys.argv[2])
for path in job["configs"]:
    run.main(load_config(path, phase="train"))
    run.main(load_config(path, phase="test"))
for argv in job["pipeline"]:
    run_pipeline.main(argv)
from multi_degradation_image_enhancement_tpu_torch.classification import train
from multi_degradation_image_enhancement_tpu_torch.datasets_generation import (
    generate_classifier, generate_paired)
generate_classifier.main(job["generate_classifier"])
generate_paired.main(job["generate_paired"])
train.main(job["classifier"])
print("OK", len(mods))
"""


def test_port_imports_and_runs_with_jax_blocked(tmp_path):
    """Every module imports, a serving step runs, the CPU CLI trains and
    scores the tiny configs of tests/torch_train_cli.py (noise_synthetic, and
    jpeg_synthetic: the jpeg degradation, the VGG and LPIPS loss terms), and
    the serving pipeline CLI restores a directory in top1 and in
    severity-ordered sequential mode, the two dataset generators write their
    layouts from three PNGs and the classifier trainer runs its four stages
    on synthetic data, all with JAX blocked."""
    # One intra-op thread: the runs are tiny, and many threads stall when
    # other test workers hold the cores.
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    (tmp_path / "jpeg").mkdir()
    configs = [write_tiny_config(tmp_path), write_tiny_config(tmp_path / "jpeg", "jpeg_synthetic")]
    pipe = write_tiny_pipeline(tmp_path / "pipeline")
    outs = [tmp_path / "pipeline" / "top1", tmp_path / "pipeline" / "severity"]
    write_clean_pngs(tmp_path / "clean", [(30, 50), (40, 40), (36, 52)])
    gen = ["--clean-dir", str(tmp_path / "clean"), "--target-hw", "32", "48", "--device", "cpu"]
    job = {"configs": list(map(str, configs)),
           "pipeline": [cli_args(pipe, outs[0], "--save-probs"),
                        cli_args(pipe, outs[1], "--mode", "sequential", "--ordering", "severity")],
           "generate_classifier": gen + ["--out", str(tmp_path / "cls"), "--variants-per-image", "2"],
           "generate_paired": gen + ["--out", str(tmp_path / "paired"), "--generate", "noise",
                                     "pixelation_easy"],
           "classifier": ["--synthetic", "--device", "cpu", "--no_pretrained", "--synthetic_images",
                          "4", "--epochs", "1", "--batch_size", "4", "--input_hw", "32", "48",
                          "--th_steps", "3", "--run_dir", str(tmp_path / "clf")]}
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN, str(ROOT), json.dumps(job)],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env,
    )
    assert proc.returncode == 0, proc.stderr
    last = proc.stdout.splitlines()[-1].split()
    assert last[0] == "OK"
    assert int(last[1]) >= 52  # every module of the package was imported
    check_tiny_run(tmp_path)
    check_tiny_test_run(tmp_path)
    check_tiny_run(tmp_path / "jpeg", "jpeg_synthetic")
    check_tiny_test_run(tmp_path / "jpeg", "jpeg_synthetic")
    for out in outs:
        assert sorted(p.name for p in out.glob("*.png")) == ["im0.png", "im1.png", "im2.png"]
    rows = [json.loads(line) for line in (outs[0] / "probs.jsonl").read_text().splitlines()]
    assert [r["file"] for r in rows] == ["im0.png", "im1.png", "im2.png"]
    assert set(rows[0]["probs"]) == {"noise", "blur", "low_light"}  # only the loaded experts
    assert sum(1 for _ in (tmp_path / "cls").rglob("*.png")) == 6
    assert all(json.loads(line)["file"].endswith(".png") for split in ("train", "val", "test")
               for line in (tmp_path / "cls" / split / "labels.jsonl").read_text().splitlines())
    for item in ("noise", "pixelation_easy"):
        assert sum(1 for _ in (tmp_path / "paired" / item).rglob("*.png")) == 6
    for name in ("best_model.pt", "thresholds_val.json", "summary.json"):
        assert (tmp_path / "clf" / name).is_file(), name


def test_no_jax_import_in_port_sources():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|multi_degradation_image_enhancement_tpu)\b", re.M
    )
    offenders = [str(p) for p in PKG_DIR.rglob("*.py") if pattern.search(p.read_text())]
    assert offenders == []


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.build_pipeline(2, 16, torch.bfloat16, "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_fast_apply(CDAN().eval(), torch.bfloat16, "cuda")
    for name in ("cuda", "tpu"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(name)
    with pytest.raises(RuntimeError, match="no CUDA device"):  # --device defaults to cuda
        run_pipeline.main(["--images", "d", "--out", "o", "--classifier", "c.pt",
                           "--weights-dir", "w"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        exp_int8_reprobe.run()
    # the classifier trainer and the generators: --device defaults to cuda
    with pytest.raises(RuntimeError, match="no CUDA device"):
        classifier_train.main(["--synthetic", "--run_dir", "never_written"])
    for cli in (generate_classifier, generate_paired):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--clean-dir", "d", "--out", "o"])


def _launches():
    return (noise_degrade_01.launches, dense_block.launches, growth_layer_fwd.launches,
            growth_layer_bwd.launches, conv3x3.launches, conv3x3_pool.launches,
            probe_matmul.launches, m_dot_xt.launches, xt_dot_m.launches, transpose.launches)


def test_plain_path_counts_no_launch():
    n0 = _launches()
    noise_degrade_01(torch.full((1, 4, 4, 3), 100.0), torch.tensor([20.0]), 1)
    block = CDAN().encoder.dense1.eval()
    with torch.no_grad():
        out = dense_block(torch.rand(1, 64, 4, 4), pack_dense_block(block))
    assert out.shape == (1, 64, 4, 4)
    pack = pack_conv(torch.randn(8, 64, 3, 3), torch.zeros(8))
    assert conv3x3(out, pack).shape == (1, 8, 4, 4)
    assert conv3x3_pool(out, pack).shape == (1, 8, 2, 2)
    # a fused training DenseBlock, forward and backward, through the plain growth layer
    block.train()
    block.fused = True
    block(torch.rand(2, 64, 8, 8)).sum().backward()
    assert block.layers[0][2].weight.grad is not None
    # the probe kernels (#11-#14)
    a = torch.randint(-128, 128, (1, 16, 64), dtype=torch.int8)
    assert probe_matmul(a, a.transpose(1, 2).contiguous()).dtype == torch.int32
    x = torch.rand(1, 8, 64).to(torch.bfloat16)
    eye = torch.eye(64, dtype=torch.bfloat16)
    assert torch.equal(xt_dot_m(m_dot_xt(x, eye), eye), x)
    assert transpose(x).shape == (1, 64, 8)
    assert _launches() == n0


def test_inference_kernels_refuse_grad():
    """The serving DenseBlock and forward have no backward: with grad enabled
    and an input that requires grad they raise instead of silently training
    nothing; under no_grad they run."""
    model = CDAN().eval()
    pack = pack_dense_block(model.encoder.dense1)
    x = torch.rand(1, 64, 4, 4, requires_grad=True)
    with pytest.raises(RuntimeError, match="inference only"):
        dense_block(x, pack)
    with torch.no_grad():
        assert dense_block(x, pack).shape == x.shape
    forward = build_fast_apply(model, torch.float32, "cpu")
    img = torch.rand(1, 16, 16, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="inference only"):
        forward(img)
    assert forward(img.detach()).shape == img.shape


def test_c_entry_points_exist_in_sources():
    """Every function the loader declares is defined ``extern "C"`` in csrc/."""
    src = "\n".join(p.read_text() for p in sorted(_build.CSRC_DIR.glob("*.cu")))
    declared = re.findall(r'"(mdie_\w+)"', Path(_build.__file__).read_text())
    assert {"mdie_noise_degrade", "mdie_philox_bits", "mdie_db_entry",
            "mdie_db_growth", "mdie_db_transition", "mdie_growth_fwd", "mdie_growth_bwd",
            "mdie_growth_bwd_scratch", "mdie_conv3x3", "mdie_conv3x3_pool", "mdie_probe_matmul",
            "mdie_probe_transpose", "mdie_probe_rhsT", "mdie_probe_lhsT"} <= set(declared)
    for name in declared + ["mdie_error_string"]:
        assert re.search(rf"\b{name}\(", src), name
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert _build.library_path().parent.parent == ROOT / "build" / "torch_kernels"
