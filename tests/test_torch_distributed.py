"""PyTorch port: the multi-process bootstrap (``parallel.distributed``) and
the training CLI under ``torchrun`` with ``train.mesh`` (``gloo`` on the CPU).

The counterpart of ``tests/test_distributed.py``: two processes join a group
(``initialize``), agree on the primary and carry a collective; importing the
package starts no process group and creates no CUDA context.  Then
``run.main`` with ``train.mesh {"data": 2}`` on 2 processes trains the tiny
CPU config to the one-process run's weights and epoch rows, with its files
written once.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from multi_degradation_image_enhancement_tpu_torch.engine.checkpoint import load_weights
from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN
from multi_degradation_image_enhancement_tpu_torch.parallel import distributed
from tests.torch_dist_worker import ROOT, recalibrate, spawn
from tests.torch_train_cli import write_tiny_config

TORCHRUN_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def test_two_process_bootstrap(tmp_path):
    """``initialize`` (explicit arguments, ``file://`` rendezvous), then
    ``is_primary`` on rank 0 only and an all-reduce of 1 + 2; the package's
    import left no process group and no CUDA context behind."""
    ranks = spawn("bootstrap", 2, tmp_path, timeout=90.0)
    assert [r["primary"] for r in ranks] == [True, False]
    assert [r["total"] for r in ranks] == [3.0, 3.0] and [r["world"] for r in ranks] == [2, 2]
    assert all(r["clean_import"] for r in ranks)


def test_without_a_group_this_process_is_primary(monkeypatch):
    for key in TORCHRUN_ENV:
        monkeypatch.delenv(key, raising=False)
    assert distributed.is_primary() and distributed.world_size() == 1
    assert not distributed.launched_by_torchrun()
    distributed.barrier()  # nothing to wait for
    with pytest.raises(ValueError, match="world size and the rank"):
        distributed.initialize()
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    assert distributed.launched_by_torchrun()
    with pytest.raises(ValueError, match="rendezvous"):
        distributed.initialize()


def test_train_mesh_larger_than_the_world_raises(tmp_path, monkeypatch):
    """``train.mesh {"data": 2}`` in one process: nothing quietly trains on
    one device what the config asked to shard."""
    from multi_degradation_image_enhancement_tpu_torch import run
    from multi_degradation_image_enhancement_tpu_torch.utils.config import load_config

    for key in TORCHRUN_ENV:
        monkeypatch.delenv(key, raising=False)
    cfg = json.loads(write_tiny_config(tmp_path).read_text())
    cfg["train"]["mesh"] = {"data": 2}
    path = tmp_path / "mesh.json"
    path.write_text(json.dumps(cfg))
    # the registry wraps the engine's ValueError, as it wraps every construction error
    with pytest.raises(NotImplementedError, match="torchrun --nproc_per_node N, N = 2"):
        run.build_session(load_config(str(path), phase="train"))


def test_bn_recalibration_reads_the_checkpoint_on_the_primary_only(tmp_path):
    """``recalibrate_bn`` on 2 ranks (``{"data": 2}``) whose checkpoint
    directories are not shared: rank 0's holds the checkpoint, rank 1's is
    empty and stays so.  Both ranks end with the checkpoint's weights and
    the statistics of the one-process recalibration on the global batch
    (JAX's CDAN tolerances, rtol 5e-4 / atol 1e-5); rank 0 alone rewrote
    it and kept the original as ``.prerecal``."""
    torch.manual_seed(0)
    want = CDAN().state_dict()
    for d in ("weights0", "weights1", "single"):
        (tmp_path / d).mkdir()
    torch.save(want, tmp_path / "weights0" / "cdan.pt")
    torch.save(want, tmp_path / "single" / "cdan.pt")
    inputs = torch.rand((4, 16, 24, 3), generator=torch.Generator().manual_seed(5))
    torch.save(inputs, tmp_path / "recal.pt")
    ranks = spawn("recal", 2, tmp_path, timeout=120.0)
    single = recalibrate(inputs, tmp_path / "single" / "cdan.pt").state_dict()
    assert [r["files"] for r in ranks] == [["cdan.pt", "cdan.pt.prerecal"], []]
    rewritten = torch.load(tmp_path / "weights0" / "cdan.pt")
    for r, res in enumerate(ranks):
        for k, v in res["state"].items():
            if "running" in k or "num_batches_tracked" in k:  # the statistics, refreshed
                torch.testing.assert_close(v, single[k], rtol=5e-4, atol=1e-5, msg=f"{r} {k}")
                assert not torch.equal(v, want[k]), (r, k)
            else:
                assert torch.equal(v, want[k]), (r, k)  # the checkpoint's, broadcast
            assert torch.equal(v, ranks[0]["state"][k]), (r, k)
            assert torch.equal(rewritten[k], ranks[0]["state"][k]), k


def _train(tmp, mesh=None, nproc=0):
    cfg = json.loads(write_tiny_config(tmp).read_text())
    cfg["logging"].setdefault("train", {})["log_every_n_batches"] = 1
    if mesh:
        cfg["train"]["mesh"] = mesh
    path = tmp / "tiny_mesh.json"
    path.write_text(json.dumps(cfg))
    launch = (["-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc)]
              if nproc else [])
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_ENV}
    proc = subprocess.run([sys.executable, *launch, "-m",
                           "multi_degradation_image_enhancement_tpu_torch.run", "-c", str(path),
                           "-p", "train"], cwd=str(ROOT), capture_output=True, text=True,
                          timeout=240, env={**env, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def _rows(tmp):
    (path,) = (tmp / "runs").glob("noise_synthetic/*/train.jsonl")
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_cli_train_mesh_two_processes_matches_one(tmp_path):
    """``torchrun --nproc_per_node 2 -m …run -c tiny.json -p train`` with
    ``train.mesh {"data": 2}`` (one epoch of 4 images at batch 2, fused
    DenseBlocks on their plain version, BN recalibration through sync-BN)
    against the one-process run: the first step's losses to 1e-4 relative
    (the sharded step is the single step, tests/test_torch_parallel.py);
    the epoch's to 1e-3 and the checkpoints' restored images to 2e-3.  Adam
    amplifies the sharded sums' rounding where a gradient sits near its eps
    (and moves the BatchNorm-fed conv biases, whose gradient is rounding
    dust, by up to lr with either sign), so after one update the weights
    themselves agree only in what they compute.  One run directory, one
    epoch row counting the 4 global images, the checkpoint and its
    pre-recalibration copy, all written by rank 0."""
    from multi_degradation_image_enhancement_tpu_torch.models.cdan import eval_forward

    one, two = tmp_path / "one", tmp_path / "two"
    one.mkdir()
    two.mkdir()
    _train(one)
    out = _train(two, {"data": 2}, nproc=2)
    assert out.count("[ENGINE] train step sharded over {'data': 2}") == 2
    assert out.count("[LOGGER] Run dir:") == 1
    assert len(list((two / "runs" / "noise_synthetic").iterdir())) == 1
    ra, rb = _rows(one), _rows(two)
    assert [r["type"] for r in rb] == ["batch", "batch", "epoch"]
    for i, rel in ((0, 1e-4), (2, 1e-3)):  # the first step; the epoch, after an Adam step
        for k in ra[i]:
            if k.startswith("loss_"):
                assert float(rb[i][k]) == pytest.approx(float(ra[i][k]), rel=rel), (i, k)
    assert rb[2]["epoch"] == 1
    # images_per_sec = 4 global images / epoch time, whatever the ranks
    assert rb[2]["images_per_sec"] * rb[2]["epoch_time_sec"] == pytest.approx(4.0, rel=1e-6)
    ckpt = "weights/CDAN_noise_synthetic.pt"
    assert (two / f"{ckpt}.prerecal").is_file()
    x = torch.rand((2, 32, 48, 3), generator=torch.Generator().manual_seed(3))
    restored = [eval_forward(load_weights(str(d / ckpt), CDAN()).eval(), torch.float32)(x)
                for d in (one, two)]
    assert float((restored[0] - restored[1]).abs().max()) <= 2e-3
