"""PyTorch port: CBAM's channel-gate pools (``avg``, ``max``, ``lp``,
``lse``) and ``no_spatial`` (``models/cbam.py``) against the JAX package's
CBAM, with the same weights through the bridge (``utils/jax_port.py``), and
the ``lp`` / ``lse`` pools on an H shard of two ``gloo`` ranks against the
whole image in one process.

The sharded case runs this module as its ranks' entry:

    python -m tests.test_torch_cbam <rank> <world> <workdir>
"""

import itertools
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_degradation_image_enhancement_tpu_torch.models.cbam import CBAM
from multi_degradation_image_enhancement_tpu_torch.utils.jax_port import cbam_state_dict

ROOT = Path(__file__).resolve().parents[1]
C, H, W = 32, 8, 12
POOLS = ("avg", "max", "lp", "lse")
SUBSETS = [s for r in range(1, 5) for s in itertools.combinations(POOLS, r)]


def _jax_cbam(pools, no_spatial, seed=0):
    """A JAX CBAM with live statistics, its variables as NumPy, and an input."""
    from multi_degradation_image_enhancement_tpu.models.cbam import CBAM as JaxCBAM

    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, (2, H, W, C)).astype(np.float32)
    m = JaxCBAM(C, pool_types=pools, no_spatial=no_spatial)
    v = jax.jit(lambda k, z: m.init({"params": k}, z, train=False))(jax.random.key(seed), x)
    stats = jax.tree.map(lambda t: rng.uniform(0.5, 1.5, t.shape).astype(np.float32),
                         jax.tree.map(np.asarray, v.get("batch_stats", {})))
    variables = {"params": jax.tree.map(np.asarray, v["params"])}
    if stats:
        variables["batch_stats"] = stats
    return m, variables, x


def _port_cbam(variables, pools, no_spatial):
    cbam = CBAM(C, pool_types=pools, no_spatial=no_spatial)
    cbam.load_state_dict(cbam_state_dict(variables, no_spatial), strict=True)
    return cbam.eval()


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("pools", SUBSETS, ids="+".join)
def test_cbam_pools_match_jax(pools):
    """Eval forward at every subset of the four pools, in order, spatial
    gate on: f32 against f32, sum order only."""
    m, variables, x = _jax_cbam(pools, False)
    want = np.asarray(jax.jit(lambda v, z: m.apply(v, z, train=False))(variables, x))
    with torch.no_grad():
        got = _port_cbam(variables, pools, False)(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pools", [("avg", "max"), ("lp",), ("lse", "avg")], ids="+".join)
def test_no_spatial_matches_jax_and_has_no_spatial_keys(pools):
    """``no_spatial``: the channel gate alone, and neither side has a spatial
    gate's weights; its input gradient too (the pools' backward)."""
    m, variables, x = _jax_cbam(pools, True)
    assert "SpatialGate_0" not in variables["params"] and "batch_stats" not in variables
    cbam = _port_cbam(variables, pools, True)
    assert not any(k.startswith("SpatialGate") for k in cbam.state_dict())
    w = np.random.RandomState(1).normal(0, 1, x.shape).astype(np.float32)

    def loss(z):
        out = m.apply(variables, z, train=False)
        return jnp.sum(out * w), out

    (_, want), want_dx = jax.jit(jax.value_and_grad(loss, has_aux=True))(x)
    xt = _nchw(x).requires_grad_(True)
    got = cbam(xt)
    (got * _nchw(w)).sum().backward()
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want_dx),
                               rtol=1e-4, atol=1e-5)


def test_unknown_pool_type_raises_with_the_jax_wording():
    with pytest.raises(ValueError, match="Unknown pool type: 'gem'|Unknown pool type: gem"):
        CBAM(C, pool_types=("avg", "gem"))


def _sharded_case(workdir: Path) -> dict:
    """Output, input gradient and summed weight gradients of this rank's
    H shard under ``{"spatial": 2}``, every pool on, spatial gate on."""
    from multi_degradation_image_enhancement_tpu_torch.parallel import collectives
    from multi_degradation_image_enhancement_tpu_torch.parallel.mesh import create_mesh

    import torch.distributed as dist

    data = torch.load(workdir / "inputs.pt")
    cbam = CBAM(C, pool_types=POOLS)
    cbam.load_state_dict(data["state"])
    cbam.eval()
    mesh = create_mesh({"spatial": 2})
    rows = H // 2
    r0 = mesh.rank * rows
    x = data["x"][:, :, r0:r0 + rows].clone().requires_grad_(True)
    with collectives.use_mesh(mesh):
        out = cbam(x)
        (out * data["w"][:, :, r0:r0 + rows]).sum().backward()
    grads = {}
    for name, p in cbam.named_parameters():
        g = p.grad.clone()
        dist.all_reduce(g)  # each rank's loss is its share of the whole image's
        grads[name] = g
    return {"out": out.detach(), "dx": x.grad, "grads": grads}


def _whole(data: dict) -> dict:
    cbam = CBAM(C, pool_types=POOLS)
    cbam.load_state_dict(data["state"])
    cbam.eval()
    x = data["x"].clone().requires_grad_(True)
    out = cbam(x)
    (out * data["w"]).sum().backward()
    return {"out": out.detach(), "dx": x.grad,
            "grads": {n: p.grad for n, p in cbam.named_parameters()}}


def test_lp_and_lse_pools_are_global_on_an_h_shard(tmp_path):
    """Two gloo ranks, each H/2 rows: the whole image's pools (``lp`` the
    root of the all-reduced sum of squares, ``lse`` about the global max),
    so the shards' outputs and input gradients are the one-process ones and
    the weight gradients sum to them (f32; other sum orders only)."""
    gen = torch.Generator().manual_seed(3)
    cbam = CBAM(C, pool_types=POOLS)
    with torch.no_grad():
        for t in cbam.parameters():
            t.copy_(torch.randn(t.shape, generator=gen) * 0.3)
        bn = cbam.SpatialGate.spatial.bn
        bn.running_mean.uniform_(-0.1, 0.1, generator=gen)
        bn.running_var.uniform_(0.5, 1.5, generator=gen)
    data = {"state": cbam.state_dict(),
            "x": torch.randn((2, C, H, W), generator=gen) * 2.0,
            "w": torch.randn((2, C, H, W), generator=gen)}
    torch.save(data, tmp_path / "inputs.pt")
    procs = [subprocess.Popen([sys.executable, "-m", "tests.test_torch_cbam", str(r), "2",
                               str(tmp_path)], cwd=str(ROOT), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env={**__import__("os").environ, "OMP_NUM_THREADS": "1"})
             for r in range(2)]
    deadline = time.monotonic() + 120.0
    try:
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    whole = _whole(data)
    for key in ("out", "dx"):
        got = torch.cat([r[key] for r in ranks], dim=2)
        torch.testing.assert_close(got, whole[key], rtol=1e-5, atol=1e-6, msg=key)
    for name, g in whole["grads"].items():
        for r in ranks:
            torch.testing.assert_close(r["grads"][name], g, rtol=1e-4, atol=1e-6, msg=name)


def _main(argv) -> None:
    rank, world, workdir = int(argv[0]), int(argv[1]), Path(argv[2])
    torch.set_num_threads(1)
    import torch.distributed as dist

    from multi_degradation_image_enhancement_tpu_torch.parallel import distributed

    distributed.initialize(f"file://{workdir / 'rendezvous'}", world, rank, backend="gloo")
    torch.save(_sharded_case(workdir), workdir / f"rank{rank}.pt")
    distributed.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1:])
