"""PyTorch port: ``train.scan_chunk`` (``engine/model.py``), the counterpart
of the JAX engine's chained scan (``model.py:398-460``; its own tests:
``tests/test_engine.py:257`` and ``:382``).  K > 1 stacks K batches, runs
their steps back to back and reads their losses back once; each step draws
its dropout as the plain loop does, so the trained state, Adam's moments and
the batch log rows are the ``scan_chunk: 0`` run's bit for bit: in one
process over 5 steps (K = 2 and 3 end on a partial chunk), and on two
``gloo`` ranks under ``train.mesh {"data": 2}``.

The sharded case runs this module as its ranks' entry:

    python -m tests.test_torch_scan_chunk <rank> <world> <workdir>
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from multi_degradation_image_enhancement_tpu_torch import run
from multi_degradation_image_enhancement_tpu_torch.utils.config import load_config
from tests.torch_train_cli import write_tiny_config

ROOT = Path(__file__).resolve().parents[1]


def _config(tmp: Path, k: int, n_images: int, mesh=None) -> Path:
    """The tiny CPU config (32×48, batch 2, fp32) with ``n_images`` training
    images, a log row every batch, ``scan_chunk: k``, no BN recalibration
    (it runs after the loop, the same whatever k)."""
    tmp.mkdir(parents=True, exist_ok=True)
    cfg = json.loads(write_tiny_config(tmp).read_text())
    cfg["train"]["dataset"]["args"]["n_images"] = n_images
    cfg["train"].update(scan_chunk=k, bn_recalibration=None)
    if mesh:
        cfg["train"]["mesh"] = mesh
    cfg["logging"].setdefault("train", {})["log_every_n_batches"] = 1
    path = tmp / f"scan{k}.json"
    path.write_text(json.dumps(cfg))
    return path


def _train(path: Path) -> dict:
    engine = run.main(load_config(str(path), phase="train"))
    rows = []
    root = Path(json.loads(path.read_text())["logging"]["root_dir"])
    for jsonl in root.glob("noise_synthetic/*/train.jsonl"):
        rows = [json.loads(line) for line in jsonl.read_text().splitlines()]
    return {"model": engine.state.model.state_dict(),
            "adam": engine.state.optimizer.state_dict()["state"],
            "rows": [{k: v for k, v in r.items() if k.startswith(("loss_", "step", "type"))}
                     for r in rows]}


def _assert_same(a: dict, b: dict, what: str) -> None:
    assert a["model"].keys() == b["model"].keys()
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), f"{what}: {k}"
    for i, s in a["adam"].items():
        for k, v in s.items():
            assert torch.equal(v, b["adam"][i][k]), f"{what}: adam {i} {k}"
    assert a["rows"] == b["rows"], what


@pytest.fixture(scope="module")
def plain(tmp_path_factory):
    return _train(_config(tmp_path_factory.mktemp("scan0"), 0, 10))


@pytest.mark.parametrize("k", [2, 3])
def test_scan_chunk_is_the_plain_loop_bitwise(plain, tmp_path, k):
    got = _train(_config(tmp_path, k, 10))
    assert [r["type"] for r in got["rows"]] == ["batch"] * 5 + ["epoch"]
    assert [r["step"] for r in got["rows"][:5]] == [1, 2, 3, 4, 5]
    _assert_same(got, plain, f"scan_chunk {k}")


def test_scan_chunk_under_a_two_rank_data_mesh_is_bitwise_the_plain_loop(tmp_path):
    """Two gloo ranks, ``train.mesh {"data": 2}``, 3 steps of the global
    batch 2: ``scan_chunk: 2`` (a chunk of 2, then one of 1) against
    ``scan_chunk: 0`` in the same ranks; both ranks hold the same state."""
    for k in (0, 2):
        _config(tmp_path / f"k{k}", k, 6, mesh={"data": 2})
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    procs = [subprocess.Popen([sys.executable, "-m", "tests.test_torch_scan_chunk", str(r), "2",
                               str(tmp_path)], cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    deadline = time.monotonic() + 240.0
    try:
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
        assert out.count("[ENGINE] train step sharded over {'data': 2}") == 2, out[-3000:]
    res = {(r, k): torch.load(tmp_path / f"rank{r}_k{k}.pt") for r in range(2) for k in (0, 2)}
    assert [row["type"] for row in res[0, 2]["rows"]] == ["batch"] * 3 + ["epoch"]
    _assert_same(res[0, 2], res[0, 0], "mesh scan_chunk 2, rank 0")
    for k in (0, 2):
        _assert_same({**res[1, k], "rows": []}, {**res[0, k], "rows": []}, f"rank 1, k {k}")


def _main(argv) -> None:
    rank, world, workdir = int(argv[0]), int(argv[1]), Path(argv[2])
    torch.set_num_threads(1)
    import torch.distributed as dist

    from multi_degradation_image_enhancement_tpu_torch.parallel import distributed

    distributed.initialize(f"file://{workdir / 'rendezvous'}", world, rank, backend="gloo")
    for k in (0, 2):
        torch.save(_train(workdir / f"k{k}" / f"scan{k}.json"), workdir / f"rank{rank}_k{k}.pt")
    distributed.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1:])
