"""Multi-process workers of the PyTorch port's scale-out tests (``gloo`` on
the CPU).  A worker imports torch and the port only (never JAX), joins a
process group through a ``file://`` rendezvous in the test's temporary
directory, runs one case and saves its results as ``rank<r>.pt``.

    python -m tests.torch_dist_worker <case> <rank> <world> <workdir>

:func:`spawn` starts the ranks, joins them under one timeout and kills them
on expiry, so a hang fails the test instead of the suite.  The cases read
their inputs (weights, batches) from files the test wrote into ``workdir``.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List

import torch
from torch import nn

ROOT = Path(__file__).resolve().parents[1]


# ------------------------------------------------------------------ models


class TinyTwin(nn.Module):
    """The port's twin of ``tests/tiny_net.py``'s ``TinyNet``: conv 3×3 → BN
    (Flax momentum 0.9) → ReLU → Dropout(0.1) → conv 3×3 → sigmoid(h + x),
    NHWC in and out, with the spatial operators of ``models.halo``."""

    rate = 0.1

    def __init__(self, features: int = 8):
        super().__init__()
        from multi_degradation_image_enhancement_tpu_torch.models.norm import BatchNorm2d

        self.conv1 = nn.Conv2d(3, features, 3, padding=1)
        self.bn = BatchNorm2d(features)
        self.conv2 = nn.Conv2d(features, 3, 3, padding=1)

    def forward(self, x_nhwc, dropout=None):
        from multi_degradation_image_enhancement_tpu_torch.models.halo import conv_same
        from multi_degradation_image_enhancement_tpu_torch.parallel import collectives

        x = x_nhwc.permute(0, 3, 1, 2)
        h = torch.relu(self.bn(conv_same(self.conv1, x)))
        if self.training:
            if dropout is None or isinstance(dropout, torch.Generator):
                shape = collectives.global_shape(h.shape, 2)
                keep = torch.rand(shape, generator=dropout) < 1.0 - self.rate
            else:
                keep = dropout[0]
            keep = collectives.local_slice(keep, 2)
            h = torch.where(keep, h / (1.0 - self.rate), torch.zeros((), dtype=h.dtype))
        return torch.sigmoid(conv_same(self.conv2, h) + x).permute(0, 2, 3, 1).float()


def tiny_twin_state_dict(variables) -> Dict[str, torch.Tensor]:
    """A Flax ``TinyNet`` ``{params, batch_stats}`` (numpy leaves) as the
    twin's ``state_dict``."""
    p, s = variables["params"], variables["batch_stats"]

    def t(a):
        return torch.from_numpy(a.copy() if hasattr(a, "copy") else a)

    return {
        "conv1.weight": t(p["Conv_0"]["kernel"].transpose(3, 2, 0, 1)),
        "conv1.bias": t(p["Conv_0"]["bias"]),
        "bn.weight": t(p["BatchNorm_0"]["scale"]), "bn.bias": t(p["BatchNorm_0"]["bias"]),
        "bn.running_mean": t(s["BatchNorm_0"]["mean"]),
        "bn.running_var": t(s["BatchNorm_0"]["var"]),
        "bn.num_batches_tracked": torch.tensor(0),
        "conv2.weight": t(p["Conv_1"]["kernel"].transpose(3, 2, 0, 1)),
        "conv2.bias": t(p["Conv_1"]["bias"]),
    }


def build_model(spec: dict) -> nn.Module:
    """``spec``: ``{"model": "tiny"|"cdan", "state": path, "fused": bool,
    "remat": bool}``."""
    if spec["model"] == "tiny":
        model = TinyTwin()
    else:
        from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN

        model = CDAN()
        model.fused_dense = bool(spec.get("fused"))
        model.remat = bool(spec.get("remat"))
    model.load_state_dict(torch.load(spec["state"]), strict=True)
    return model


# ------------------------------------------------------------------ steps


def run_step(spec: dict, batch: dict, mesh=None) -> dict:
    """One ``make_train_step`` (fp32, SGD-free: the gradients and running
    statistics are read after the update) on the global ``batch`` (dict of
    ``inputs``, ``targets``, ``mask``, ``keep``: the keep masks at the global
    shape), sharded over ``mesh`` when given."""
    from multi_degradation_image_enhancement_tpu_torch.engine.model import make_train_step
    from multi_degradation_image_enhancement_tpu_torch.engine.state import TrainState
    from multi_degradation_image_enhancement_tpu_torch.ops.losses import build_loss_pipeline
    from multi_degradation_image_enhancement_tpu_torch.parallel.mesh import (
        replicate,
        shard_batch,
        shard_train_step,
    )

    model = build_model(spec)
    state = TrainState.create(model, 1e-3, grad_clip=spec.get("grad_clip"))
    step = make_train_step(build_loss_pipeline(spec["loss"], "cpu"), "fp32")
    inputs, targets, mask = batch["inputs"], batch["targets"], batch.get("mask")
    if mesh is not None:
        replicate(state, mesh)
        step = shard_train_step(step, mesh)
        inputs, targets, mask = shard_batch((inputs, targets, mask), mesh)
    loss = step(state, inputs, targets, batch["keep"], mask)
    return {"loss": {k: v.clone() for k, v in loss.items()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "buffers": {n: b.clone() for n, b in model.named_buffers()}}


def case_steps(workdir: Path) -> dict:
    """Every entry of ``steps.json`` (``[{"name", "mesh", "spec", "batch"}]``)
    sharded over its mesh."""
    from multi_degradation_image_enhancement_tpu_torch.parallel.mesh import create_mesh

    out = {"growth": {}, "eval": {}}
    for axes in ({"spatial": 4}, {"data": 2, "spatial": 2}):
        mesh = create_mesh(axes)
        out["growth"][json.dumps(axes)] = growth_grads(torch.load(workdir / "growth.pt"), mesh)
        out["eval"][json.dumps(axes)] = eval_outputs(workdir, mesh)
    for entry in json.loads((workdir / "steps.json").read_text()):
        mesh = create_mesh(entry["mesh"])
        t0 = time.perf_counter()
        out[entry["name"]] = run_step(entry["spec"], torch.load(entry["batch"]), mesh)
        out[entry["name"]]["seconds"] = time.perf_counter() - t0
        out[entry["name"]]["coords"] = dict(mesh.coords)
    return out


def growth_grads(data: dict, mesh=None) -> dict:
    """``growth_layer_sharded`` over the growth layer's plain version on the
    whole ``x`` of ``data`` or, under ``mesh``, on this rank's H shard: the
    output rows and the gradients of ``Σ y·r`` (x's own rows; a, b, w and
    the bias summed over the ranks, as the gradient all-reduce sums them)."""
    import torch.distributed as dist

    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.growth_train import (
        growth_layer_plain,
        growth_layer_sharded,
    )
    from multi_degradation_image_enhancement_tpu_torch.parallel import collectives

    with collectives.use_mesh(mesh):
        x = collectives.local_slice(data["x"], 2).clone().requires_grad_(True)
        params = [data[k].clone().requires_grad_(True) for k in ("a", "b", "w", "bias")]
        y = growth_layer_sharded(growth_layer_plain, x, *params)
        (y * collectives.local_slice(data["r"], 2)).sum().backward()
    out = {"y": y.detach(), "x": x.grad}
    for k, p in zip(("a", "b", "w", "bias"), params):
        if mesh is not None:
            dist.all_reduce(p.grad)
        out[k] = p.grad
    return out


def eval_outputs(workdir: Path, mesh=None) -> torch.Tensor:
    """CDAN's f32 eval forward (``cdan.pt``, running statistics) on
    ``eval.pt``'s images, or under ``mesh`` on this rank's shard through
    ``shard_eval_step``: its output rows."""
    from multi_degradation_image_enhancement_tpu_torch.models.cdan import eval_forward
    from multi_degradation_image_enhancement_tpu_torch.parallel.mesh import (
        shard_batch,
        shard_eval_step,
    )

    forward = eval_forward(build_model({"model": "cdan", "state": workdir / "cdan.pt"}).eval(),
                           torch.float32)
    x = torch.load(workdir / "eval.pt")
    if mesh is None:
        return forward(x)
    return shard_eval_step(forward, mesh)(shard_batch(x, mesh))


def case_bootstrap(workdir: Path) -> dict:
    """Importing the package started no process group (checked before the
    worker's ``initialize``, see :func:`main`); after it, ``is_primary`` and
    an all-reduce of the ranks' numbers."""
    import torch.distributed as dist

    from multi_degradation_image_enhancement_tpu_torch.parallel import distributed

    t = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(t)
    distributed.initialize()  # idempotent
    return {"primary": distributed.is_primary(), "total": float(t), "world": dist.get_world_size()}


def case_router(workdir: Path) -> dict:
    """Expert-parallel ``RoutedRestorer`` cases of ``router.json``: tiny nets
    as experts, each case's mesh, the outputs of every case."""
    from multi_degradation_image_enhancement_tpu_torch.parallel.mesh import create_mesh
    from multi_degradation_image_enhancement_tpu_torch.pipeline import RoutedRestorer

    out = {}
    for entry in json.loads((workdir / "router.json").read_text()):
        data = torch.load(entry["data"])
        experts = []
        for state in data["experts"]:
            net = TinyTwin().eval()
            net.load_state_dict(state)
            experts.append(torch.no_grad()(net))
        mesh = create_mesh(entry["mesh"])
        router = RoutedRestorer(experts, entry["names"], mode=entry["mode"],
                                ordering=entry.get("ordering", "fixed"), mesh=mesh)
        with torch.no_grad():
            got = router(data["images"], data["probs"], data["thresholds"],
                         severities=data.get("severities"))
        out[entry["name"]] = {"out": got, "n_pad": router.n_pad, "owned": list(router.owned),
                              "held": [e for e, f in enumerate(router.expert_forwards)
                                       if f is not None]}
    return out


def recalibrate(inputs: torch.Tensor, path: Path, mesh=None, seed: int = 0) -> nn.Module:
    """``Model.recalibrate_bn`` (two passes over the one batch ``inputs``)
    on a CDAN initialised from ``seed``, for the checkpoint at ``path``;
    the engine's other state is what the method reads of it."""
    from types import SimpleNamespace

    from multi_degradation_image_enhancement_tpu_torch.engine.model import Model
    from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN

    torch.manual_seed(seed)
    model = CDAN()
    engine = SimpleNamespace(checkpoint_path=lambda: str(path), device=torch.device("cpu"),
                             mesh=mesh, network=model, dataloader=[(inputs, None, None)],
                             precision="fp32", _copy_best_to_run_dir=lambda: None,
                             _log=lambda: False)
    Model.recalibrate_bn(engine, passes=2)
    return model


def case_recal(workdir: Path) -> dict:
    """BN recalibration on ``{"data": 2}`` where rank 0's checkpoint
    directory alone holds the checkpoint (ranks without a shared
    filesystem); each rank starts from other weights."""
    import torch.distributed as dist

    from multi_degradation_image_enhancement_tpu_torch.parallel.mesh import create_mesh

    rank = dist.get_rank()
    ckpt_dir = workdir / f"weights{rank}"
    model = recalibrate(torch.load(workdir / "recal.pt"), ckpt_dir / "cdan.pt",
                        create_mesh({"data": 2}), seed=100 + rank)
    return {"state": {k: v.clone() for k, v in model.state_dict().items()},
            "files": sorted(os.listdir(ckpt_dir))}


CASES = {"steps": case_steps, "bootstrap": case_bootstrap, "router": case_router,
         "recal": case_recal}


def main(argv: List[str]) -> None:
    case, rank, world, workdir = argv[0], int(argv[1]), int(argv[2]), Path(argv[3])
    torch.set_num_threads(1)
    import torch.distributed as dist

    import multi_degradation_image_enhancement_tpu_torch  # noqa: F401
    from multi_degradation_image_enhancement_tpu_torch import parallel  # noqa: F401
    from multi_degradation_image_enhancement_tpu_torch.parallel import distributed

    clean_import = not dist.is_initialized() and not torch.cuda.is_initialized()
    distributed.initialize(f"file://{workdir / 'rendezvous'}", world, rank, backend="gloo")
    result = CASES[case](workdir)
    result["clean_import"] = clean_import
    torch.save(result, workdir / f"rank{rank}.pt")
    distributed.barrier()
    dist.destroy_process_group()


def spawn(case: str, world: int, workdir: Path, timeout: float = 120.0) -> List[dict]:
    """Run ``case`` on ``world`` gloo ranks; their results in rank order.
    Every rank is killed if they have not all finished after ``timeout``
    seconds, and the test fails with each rank's output."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_dist_worker", case, str(r),
                               str(world), str(workdir)], cwd=str(ROOT), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"{case}: {world} ranks still running after {timeout} s")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{case}: rank {r} failed:\n{out[-4000:]}"
    return [torch.load(workdir / f"rank{r}.pt") for r in range(world)]


def single_step(spec: dict, batch_path) -> dict:
    """The same step in this process, unsharded: the reference."""
    return run_step(copy.deepcopy(spec), torch.load(batch_path))


if __name__ == "__main__":
    main(sys.argv[1:])
