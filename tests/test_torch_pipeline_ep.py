"""PyTorch port: the expert-parallel routed server (``pipeline.RoutedRestorer``
with an ``expert`` mesh axis, ``run_pipeline --expert-mesh``) against the
unsharded router and the one-process CLI.

The router cases run in one spawn of 4 ``gloo`` ranks on the CPU
(``tests/torch_dist_worker.py``), with the twin of ``tests/tiny_net.py`` as
experts; the unsharded router runs here on the same experts.  The cases
cover an ``expert`` × ``data`` mesh, a bank padded to the axis (``n_pad``,
as ``tests/test_pipeline.py:84-106``), a rank that holds only a dummy
expert, clean and dropped rows, and sequential mode in both orders.
"""

import json

import numpy as np
import pytest
import torch

from multi_degradation_image_enhancement_tpu_torch import run_pipeline
from multi_degradation_image_enhancement_tpu_torch.pipeline import RoutedRestorer, expert_block
from multi_degradation_image_enhancement_tpu_torch.parallel.mesh import Mesh
from tests.torch_dist_worker import ROOT, TinyTwin, spawn
from tests.torch_pipeline_cli import cli_args, write_tiny_pipeline

# name: (mesh, experts, mode, ordering, batch)
ROUTER = {
    "top1-expert2-data2": ({"expert": 2, "data": 2}, 4, "top1", "fixed", 8),
    "top1-pad-data2-expert2": ({"data": 2, "expert": 2}, 3, "top1", "fixed", 6),
    "top1-pad-expert4": ({"expert": 4}, 3, "top1", "fixed", 7),
    "sequential-severity-expert4": ({"expert": 4}, 4, "sequential", "severity", 6),
    "sequential-fixed-expert2-data2": ({"expert": 2, "data": 2}, 4, "sequential", "fixed", 5),
}


def _experts(n, seed):
    torch.manual_seed(seed)
    nets = []
    for _ in range(n):
        net = TinyTwin().eval()
        with torch.no_grad():
            net.bn.running_mean.uniform_(-0.2, 0.2)
            net.bn.running_var.uniform_(0.5, 1.5)
        nets.append(net)
    return nets


def _probs(rng, b, e):
    """Routes of every kind: a clear argmax, a clean row (nothing clears its
    threshold) and, with 7 rows on 3 experts, a full bucket."""
    probs = rng.uniform(0.0, 0.4, (b, e)).astype(np.float32)
    for i in range(b):
        probs[i, (i * 2) % e if b != 7 else 0] = 0.9
    probs[1] = 0.1  # clean
    return torch.from_numpy(probs)


@pytest.fixture(scope="module")
def routed(tmp_path_factory):
    work = tmp_path_factory.mktemp("router")
    rng = np.random.RandomState(1)
    entries, data = [], {}
    for i, (name, (mesh, n, mode, ordering, b)) in enumerate(ROUTER.items()):
        experts = _experts(n, i)
        data[name] = {"images": torch.from_numpy(rng.rand(b, 16, 24, 3).astype(np.float32)),
                      "probs": _probs(rng, b, n), "thresholds": [0.5] * n,
                      "severities": torch.from_numpy(rng.rand(b, n).astype(np.float32)),
                      "experts": [e.state_dict() for e in experts]}
        torch.save(data[name], work / f"{name}.pt")
        entries.append({"name": name, "mesh": mesh, "names": [f"e{k}" for k in range(n)],
                        "mode": mode, "ordering": ordering, "data": str(work / f"{name}.pt")})
    (work / "router.json").write_text(json.dumps(entries))
    ranks = spawn("router", 4, work, timeout=180.0)
    want = {}
    for name, (mesh, n, mode, ordering, b) in ROUTER.items():
        d = data[name]
        experts = [torch.no_grad()(net) for net in _experts(n, list(ROUTER).index(name))]
        router = RoutedRestorer(experts, [f"e{k}" for k in range(n)], mode=mode,
                                ordering=ordering)
        with torch.no_grad():
            want[name] = router(d["images"], d["probs"], d["thresholds"],
                                severities=d["severities"])
    return ranks, want, data


@pytest.mark.parametrize("name", list(ROUTER))
def test_expert_parallel_router_matches_unsharded(routed, name):
    """Every rank returns the whole batch, equal to the unsharded router's
    (each row restored by one rank; clean and dropped rows pass through)."""
    ranks, want, data = routed
    for r, res in enumerate(ranks):
        torch.testing.assert_close(res[name]["out"], want[name], rtol=0, atol=1e-5,
                                   msg=f"rank {r}")
    images = data[name]["images"]
    assert torch.equal(want[name][1], images[1])  # the clean row passes through
    if name == "top1-pad-expert4":  # 7 rows to expert 0, capacity ceil(7/3·2) = 5
        assert torch.equal(want[name][6], images[6])


@pytest.mark.parametrize("name,n_pad,blocks", [
    ("top1-expert2-data2", 0, [[0, 1], [0, 1], [2, 3], [2, 3]]),  # row-major: expert outer
    ("top1-pad-data2-expert2", 1, [[0, 1], [2], [0, 1], [2]]),
    ("top1-pad-expert4", 1, [[0], [1], [2], []]),
])
def test_each_rank_holds_its_block_of_the_padded_bank(routed, name, n_pad, blocks):
    """The bank pads to a multiple of the expert axis; each rank keeps the
    contiguous block of JAX's ``P(EXPERT_AXIS)`` layout (a dummy expert's
    rank holds nothing to run)."""
    ranks, _, _ = routed
    assert [r[name]["n_pad"] for r in ranks] == [n_pad] * 4
    assert [r[name]["held"] for r in ranks] == blocks
    assert [r[name]["owned"] for r in ranks] == blocks


def test_expert_block_layout():
    assert [list(expert_block(9, Mesh({"expert": 3}, range(3), r, {}))) for r in range(3)] == [
        [0, 1, 2], [3, 4, 5], [6, 7, 8]]
    assert list(expert_block(9, None)) == list(range(9))
    mesh = Mesh({"expert": 2}, range(2), 1, {})
    router = RoutedRestorer([None, None, abs], ["a", "b", "c"], mesh=mesh)
    assert router.n_pad == 1 and list(router.owned) == [2]
    with pytest.raises(ValueError, match="missing for this rank's experts"):
        RoutedRestorer([abs, abs, None], ["a", "b", "c"], mesh=mesh)


def test_expert_mesh_refuses_an_axis_that_does_not_divide_the_bank(tmp_path):
    """The JAX CLI's refusal (``run_pipeline.py:162-166``), before any
    process group is joined."""
    paths = write_tiny_pipeline(tmp_path)
    with pytest.raises(ValueError, match="--expert-mesh 2 does not divide the 3 loaded experts"):
        run_pipeline.main(cli_args(paths, tmp_path / "out", "--expert-mesh", "2"))


@pytest.mark.parametrize("mode", ["top1", "severity"])
def test_cli_expert_mesh_matches_one_process(tmp_path, mode):
    """``torchrun --nproc_per_node 3 … run_pipeline --expert-mesh 3`` (gloo,
    CPU): the PNGs and ``probs.jsonl`` equal the one-process CLI's, written
    once, by rank 0."""
    import subprocess
    import sys

    paths = write_tiny_pipeline(tmp_path)
    extra = ["--save-probs"] + (["--mode", "sequential", "--ordering", "severity"]
                                if mode == "severity" else [])
    run_pipeline.main(cli_args(paths, tmp_path / "one", *extra))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "3",
           "-m", "multi_degradation_image_enhancement_tpu_torch.run_pipeline",
           *cli_args(paths, tmp_path / "ep", *extra, "--expert-mesh", "3")]
    proc = subprocess.run(cmd, cwd=str(ROOT), capture_output=True, text=True, timeout=180,
                          env={**__import__("os").environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count("[OK] restored 3 images") == 1
    from PIL import Image

    one = sorted(p.name for p in (tmp_path / "one").iterdir())
    assert sorted(p.name for p in (tmp_path / "ep").iterdir()) == one
    for f in one:
        if f.endswith(".png"):
            a = np.asarray(Image.open(tmp_path / "one" / f), dtype=np.int16)
            b = np.asarray(Image.open(tmp_path / "ep" / f), dtype=np.int16)
            assert np.abs(a - b).max() <= 1, f
    assert (tmp_path / "one" / "probs.jsonl").read_text() == (
        tmp_path / "ep" / "probs.jsonl").read_text()
