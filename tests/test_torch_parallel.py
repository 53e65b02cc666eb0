"""PyTorch port: the scale-out layer (``parallel.mesh``, ``parallel.
collectives``, sync-BN, the spatial operators) against the port's own
single-process step and against the JAX package.

The invariant is JAX's (``tests/test_parallel.py``): a sharded step is the
single-device step on the global batch: loss, every gradient and the running
statistics, for a tiny net and for CDAN (plain and fused DenseBlocks, with
``remat``), on ``data``, ``data`` × ``spatial`` and 4-way ``spatial`` meshes
(one row a rank at CDAN's bottleneck).  The sharded steps run in one spawn
of 4 ``gloo`` ranks on the CPU (``tests/torch_dist_worker.py``); the
references run here.  Gradients are compared directly (not after Adam,
whose first step amplifies near-zero gradients), at JAX's tolerances:
rtol 2e-4 / atol 2e-6 for the tiny net, 5e-4 / 1e-5 for CDAN, the loss to
1e-5 / 1e-4 relative.
"""

import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multi_degradation_image_enhancement_tpu.engine.model import make_train_step as jax_make_step
from multi_degradation_image_enhancement_tpu.engine.state import TrainState as JaxState
from multi_degradation_image_enhancement_tpu.models.cdan import CDAN as JaxCDAN
from multi_degradation_image_enhancement_tpu.ops.losses import build_loss_pipeline as jax_losses
from multi_degradation_image_enhancement_tpu.parallel import mesh as jmesh
from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN
from multi_degradation_image_enhancement_tpu_torch.models.torch_init import flax_default_init_
from multi_degradation_image_enhancement_tpu_torch.parallel import collectives
from multi_degradation_image_enhancement_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    batch_spec,
    create_mesh,
    shard_batch,
)
from multi_degradation_image_enhancement_tpu_torch.utils.jax_port import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from tests.tiny_net import TinyNet
from tests.torch_dist_worker import single_step, spawn, tiny_twin_state_dict

MSE = {"enabled": True, "terms": [{"name": "mse", "weight": 1.0}]}
NOISE_LOSS = {"enabled": True, "terms": [{"name": "charbonnier", "weight": 1.0,
                                          "args": {"eps": 1e-3}},
                                         {"name": "ssim", "weight": 0.5}]}
WORST = {"enabled": True, "terms": [{"name": "l1", "weight": 1.0}, {"name": "ssim", "weight": 0.5}],
         "worst_case": {"fraction": 0.25, "scale": 3.0}}
DROP_SITES = [(64, 2), (128, 4), (256, 8), (512, 8)]  # CDAN's four dropout sites
TOL = {"tiny": (2e-4, 2e-6, 1e-5), "cdan": (5e-4, 1e-5, 1e-4)}  # rtol, atol, loss rel


def _cdan_state(seed: int) -> dict:
    model = flax_default_init_(CDAN(), torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.uniform_(-0.5, 0.5, generator=gen)
            m.running_var.uniform_(0.5, 1.5, generator=gen)
    return model.state_dict()


def _batch(rng, b, h, w, model, mask=None, ties=False):
    inputs = rng.rand(b, h, w, 3).astype(np.float32)
    targets = np.clip(inputs + 0.1 * rng.randn(b, h, w, 3), 0, 1).astype(np.float32)
    if ties:  # images 1 and 2 tie at the top of the worst-case ranking
        targets[2], inputs[2] = targets[1], inputs[1]
    if model == "tiny":
        keep = [rng.rand(b, 8, h, w) < 0.9]
    else:
        keep = [rng.rand(b, c, h // p, w // p) < 0.8 for c, p in DROP_SITES]
    return {"inputs": torch.from_numpy(inputs), "targets": torch.from_numpy(targets),
            "mask": None if mask is None else torch.tensor(mask, dtype=torch.float32),
            "keep": [torch.from_numpy(k) for k in keep]}


# name: (model, mesh, (B, H, W), loss, options)
STEPS = {
    "tiny-data4": ("tiny", {"data": 4}, (4, 16, 24), MSE, {}),
    "tiny-data2-spatial2": ("tiny", {"data": 2, "spatial": 2}, (4, 32, 24), MSE, {}),
    "cdan-data4": ("cdan", {"data": 4}, (4, 16, 24), NOISE_LOSS, {}),
    "cdan-data2-spatial2": ("cdan", {"data": 2, "spatial": 2}, (4, 32, 24), NOISE_LOSS, {}),
    "cdan-spatial4": ("cdan", {"spatial": 4}, (2, 32, 24), NOISE_LOSS, {}),
    "cdan-spatial4-fused": ("cdan", {"spatial": 4}, (2, 32, 24), NOISE_LOSS, {"fused": True}),
    "cdan-data2-spatial2-fused-remat": ("cdan", {"data": 2, "spatial": 2}, (4, 32, 24), NOISE_LOSS,
                                        {"fused": True, "remat": True}),
    "cdan-data4-uneven-mask": ("cdan", {"data": 4}, (4, 16, 24), NOISE_LOSS,
                               {"mask": [1.0, 1.0, 1.0, 0.0]}),
    "tiny-data4-worst-case-ties": ("tiny", {"data": 4}, (4, 16, 24), WORST,
                                   {"mask": [1.0, 1.0, 1.0, 0.0], "ties": True}),
    "cdan-data2-spatial2-clip": ("cdan", {"data": 2, "spatial": 2}, (4, 32, 24), NOISE_LOSS,
                                 {"grad_clip": 1e-3}),
    # Flax's weights, for the test against the JAX single-device step
    "cdan-jax-data2-spatial2": ("cdan_jax", {"data": 2, "spatial": 2}, (2, 16, 24), NOISE_LOSS, {}),
}


def _jax_tiny():
    v = TinyNet().init({"params": jax.random.key(0), "dropout": jax.random.key(1)},
                       jnp.zeros((1, 16, 24, 3)), train=True)
    return jax.tree.map(np.asarray, {"params": v["params"], "batch_stats": v["batch_stats"]})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case of :data:`STEPS` sharded over 4 ranks (one spawn), and the
    single-process step of each here."""
    work = tmp_path_factory.mktemp("steps")
    rng = np.random.RandomState(0)
    torch.save(_cdan_state(3), work / "cdan.pt")
    torch.save(tiny_twin_state_dict(_jax_tiny()), work / "tiny.pt")
    v = jax.jit(lambda k: JaxCDAN().init({"params": k}, jnp.zeros((1, 16, 24, 3)), train=True))(
        jax.random.key(0))
    jax_cdan = {"params": jax.tree.map(np.asarray, v["params"]),
                "batch_stats": jax.tree.map(lambda t: rng.uniform(0.5, 1.5, t.shape).astype(
                    np.float32), v["batch_stats"])}
    torch.save(flax_to_state_dict(jax_cdan), work / "cdan_jax.pt")
    entries = []
    for name, (model, mesh, (b, h, w), loss, opt) in STEPS.items():
        batch = _batch(rng, b, h, w, "tiny" if model == "tiny" else "cdan", opt.get("mask"),
                       opt.get("ties", False))
        torch.save(batch, work / f"{name}.batch.pt")
        spec = {"model": "tiny" if model == "tiny" else "cdan",
                "state": str(work / f"{model}.pt"), "loss": loss,
                "fused": opt.get("fused", False), "remat": opt.get("remat", False),
                "grad_clip": opt.get("grad_clip")}
        entries.append({"name": name, "mesh": mesh, "spec": spec,
                        "batch": str(work / f"{name}.batch.pt")})
    (work / "steps.json").write_text(json.dumps(entries))
    g = torch.Generator().manual_seed(5)
    torch.save({"x": torch.randn(2, 19, 8, 5, generator=g), "a": torch.rand(19, generator=g) + 0.5,
                "b": torch.randn(19, generator=g) * 0.5, "w": torch.randn(16, 19, 3, 3, generator=g),
                "bias": torch.randn(16, generator=g), "r": torch.randn(2, 16, 8, 5, generator=g)},
               work / "growth.pt")
    torch.save(torch.rand(2, 32, 24, 3, generator=g), work / "eval.pt")
    ranks = spawn("steps", 4, work, timeout=240.0)
    single = {e["name"]: single_step(e["spec"], e["batch"]) for e in entries}
    canonical = {e["name"]: single_step({**e["spec"], "fused": False}, e["batch"])
                 for e in entries if e["spec"]["fused"]}
    return {"ranks": ranks, "single": single, "canonical": canonical, "work": work,
            "jax_cdan": jax_cdan}


def _worst_rel(got, want):
    """Worst per-leaf ``max|got − want| / max|want|`` over the leaves whose
    gradient scale is at least 1e-5 (``tests/test_torch_train.py``'s cut)."""
    return max(((got[n] - g).abs().max().item() / g.abs().max().item(), n)
               for n, g in want.items() if g.abs().max().item() >= 1e-5)


@pytest.mark.parametrize("name", list(STEPS))
def test_sharded_step_matches_single_process(runs, name):
    """Loss, every gradient leaf (after the step's all-reduce, equal on every
    rank) and every running statistic (sync-BN) of the sharded step against
    the one-process step on the global batch."""
    ranks, single = runs["ranks"], runs["single"]
    rtol, atol, loss_rel = TOL["tiny" if STEPS[name][0] == "tiny" else "cdan"]
    want = single[name]
    for r, res in enumerate(ranks):
        got = res[name]
        for k, v in want["loss"].items():
            assert abs(float(got["loss"][k]) - float(v)) <= loss_rel * abs(float(v)), (r, k)
        for n, g in want["grads"].items():
            assert torch.equal(got["grads"][n], ranks[0][name]["grads"][n]), (r, n)
            if name not in runs["canonical"]:
                torch.testing.assert_close(got["grads"][n], g, rtol=rtol, atol=atol,
                                           msg=f"{r} {n}")
        if name in runs["canonical"]:
            # The fused growth layers round their operands to bf16: the
            # sharded forward's ~1e-7 differences (sums taken in another
            # order) flip roundings that BatchNorm over a few pixels
            # amplifies, as between the JAX package's fused and canonical
            # steps.  So, as tests/test_torch_train.py holds the fused step,
            # each leaf within max(2·floor, 0.05) of its scale, the floor
            # being the fused step's own distance from the canonical one.
            floor = _worst_rel(want["grads"], runs["canonical"][name]["grads"])[0]
            err, leaf = _worst_rel(got["grads"], want["grads"])
            assert err <= max(2.0 * floor, 0.05), (err, leaf, floor)
        for n, b in want["buffers"].items():
            torch.testing.assert_close(got["buffers"][n].double(), b.double(), rtol=rtol,
                                       atol=atol, msg=f"{r} {n}")


@pytest.mark.parametrize("axes", ['{"spatial": 4}', '{"data": 2, "spatial": 2}'])
def test_sharded_growth_layer_matches_whole_layer(runs, axes):
    """The growth layer on H shards (halo rows of raw x, none past the image
    edges, the halo's output rows cropped) equals the whole layer: its rows
    of the output, x's gradient, and a, b, w and the bias's gradients once
    the ranks' partial sums over the halo positions are added (the gradient
    all-reduce).  Same operands, so the same bf16 roundings: held to 1e-5."""
    from tests.torch_dist_worker import growth_grads

    want = growth_grads(torch.load(runs["work"] / "growth.pt"))
    spatial = json.loads(axes)["spatial"]
    images, rows = 2 // (4 // spatial), 8 // spatial  # a rank's images and rows
    for r, res in enumerate(runs["ranks"]):
        got = res["growth"][axes]
        d, s = divmod(r, spatial)
        for k in ("y", "x"):
            torch.testing.assert_close(
                got[k], want[k][d * images:(d + 1) * images, :, s * rows:(s + 1) * rows],
                rtol=1e-5, atol=1e-5, msg=f"{r} {k}")
        for k in ("a", "b", "w", "bias"):
            torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5, msg=f"{r} {k}")


@pytest.mark.parametrize("axes", ['{"spatial": 4}', '{"data": 2, "spatial": 2}'])
def test_sharded_eval_forward_matches_whole_forward(runs, axes):
    """``shard_eval_step`` over CDAN's f32 eval forward (running statistics,
    no collective but the halo rows): each rank's output rows are the whole
    forward's, to 1e-5."""
    from tests.torch_dist_worker import eval_outputs

    want = eval_outputs(runs["work"])
    spatial = json.loads(axes)["spatial"]
    images, rows = 2 // (4 // spatial), 32 // spatial
    for r, res in enumerate(runs["ranks"]):
        d, s = divmod(r, spatial)
        torch.testing.assert_close(
            res["eval"][axes], want[d * images:(d + 1) * images, s * rows:(s + 1) * rows],
            rtol=1e-5, atol=1e-5, msg=f"rank {r}")


def test_spatial4_holds_one_row_per_rank_at_the_bottleneck(runs):
    """At 4-way ``spatial`` and H=32 each rank holds 8 rows, one after CDAN's
    three pools; the 7×7 gate of the bottleneck's CBAM reads rows from three
    ranks away."""
    ranks = runs["ranks"]
    assert [r["cdan-spatial4"]["coords"] for r in ranks] == [{"spatial": i} for i in range(4)]
    assert 32 // 4 // 8 == 1
    top, bottom = collectives._halo_rows(3, 1, 4, 1, "zeros")
    assert top == [None, None, (0, 0, 0)] and bottom == [(2, 0, 0), (3, 0, 0), None]


def test_package_import_starts_no_process_group(runs):
    assert all(r["clean_import"] for r in runs["ranks"])


# ------------------------------------------------------------- mesh rules


def test_create_mesh_shapes_and_errors():
    """JAX's rules (``tests/test_parallel.py:19-30``) over 8 ranks."""
    ranks = list(range(8))
    assert create_mesh({"data": -1}, ranks).shape == {"data": 8}
    assert create_mesh({"data": 4, "spatial": 2}, ranks).shape == {"data": 4, "spatial": 2}
    with pytest.raises(ValueError):
        create_mesh({"data": 3}, ranks)
    with pytest.raises(ValueError):
        create_mesh({"data": -1, "spatial": -1}, ranks)
    one = create_mesh({"data": -1})  # one process, no process group: the plain step
    assert one.shape == {"data": 1} and one.group_of(("data",)) is None


@pytest.mark.parametrize("rank,rows,hs", [(0, (0, 2), (0, 16)), (1, (0, 2), (16, 32)),
                                          (2, (2, 4), (0, 16)), (3, (2, 4), (16, 32))])
def test_batch_sharding_row_major(rank, rows, hs):
    """Ranks fill ``{"data": 2, "spatial": 2}`` row-major, as JAX reshapes its devices."""
    mesh = Mesh({"data": 2, "spatial": 2}, range(4), rank, {})
    assert batch_spec(mesh) == ("data", "spatial")
    r, h = batch_sharding(mesh, 4, 32)
    assert (r.start, r.stop) == rows and (h.start, h.stop) == hs
    x = torch.arange(4 * 32 * 2 * 3, dtype=torch.float32).reshape(4, 32, 2, 3)
    m = torch.arange(4.0)
    xs, ms = shard_batch((x, m), mesh)
    assert torch.equal(xs, x[rows[0]:rows[1], hs[0]:hs[1]]) and torch.equal(ms, m[rows[0]:rows[1]])
    with pytest.raises(ValueError):
        batch_sharding(mesh, 3, 32)


@pytest.mark.parametrize("mode", ["zeros", "edge", "none"])
@pytest.mark.parametrize("depth,h", [(1, 4), (3, 1), (3, 2), (2, 8)])
def test_halo_rows_cover_the_global_image(mode, depth, h):
    """Each rank's halo rows are the global image's rows around its shard,
    past the edges zeros, the edge row, or nothing, from as many ranks away
    as ``depth`` reaches."""
    size = 4
    image = np.arange(size * h)
    edges = {(q, s): image[q * h:(q + 1) * h][:min(depth, h)] if s == 0
             else image[q * h:(q + 1) * h][h - min(depth, h):] for q in range(size) for s in (0, 1)}
    for index in range(size):
        top, bottom = collectives._halo_rows(depth, h, size, index, mode)
        got = [None if s is None else int(edges[s[0], s[1]][s[2]]) for s in top + bottom]
        rows = list(range(index * h - depth, index * h)) + list(
            range((index + 1) * h, (index + 1) * h + depth))
        want = []
        for g in rows:
            if 0 <= g < size * h:
                want.append(g)
            elif mode == "edge":
                want.append(min(max(g, 0), size * h - 1))
            elif mode == "zeros":
                want.append(None)
        assert got == want, (index, top, bottom)


def test_mesh_config_must_span_the_world():
    """``train.mesh`` asking for more processes than the run has raises, and
    names torchrun; ``{"data": -1}`` on one process is the plain step."""
    from multi_degradation_image_enhancement_tpu_torch.parallel.mesh import mesh_from_config

    with pytest.raises(ValueError, match="torchrun --nproc_per_node"):
        mesh_from_config({"data": 2})
    assert mesh_from_config({"data": -1}) is None and mesh_from_config(None) is None


def test_local_height_must_divide_by_8():
    model = CDAN().train()
    mesh = Mesh({"spatial": 2}, range(2), 0, {})
    with collectives.use_mesh(mesh), pytest.raises(ValueError, match="divide by 8"):
        model(torch.zeros(1, 12, 16, 3))


# ---------------------------------------------------------------- vs JAX


def _interceptor(keep):
    masks = iter(keep)

    def intercept(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
            x, k = args[0], next(masks)
            return jnp.where(k, x / (1.0 - context.module.rate), jnp.zeros_like(x))
        return next_fun(*args, **kwargs)

    return intercept


def _nhwc(keep):
    return [jnp.asarray(k.numpy().transpose(0, 2, 3, 1)) for k in keep]


def test_tiny_sharded_step_matches_jax_sharded_step(runs):
    """The port's ``{"data": 2, "spatial": 2}`` tiny-net step against JAX's
    sharded step over 4 virtual CPU devices, from the same Flax weights and
    dropout masks: the parameters after SGD(0.1), the running statistics and
    the loss, at ``tests/test_parallel.py``'s tolerances."""
    name = "tiny-data2-spatial2"
    _, mesh_axes, _, loss_cfg, _ = STEPS[name]
    got = runs["ranks"][0][name]
    data = torch.load(runs["work"] / f"{name}.batch.pt")
    variables = _jax_tiny()
    step = jax_make_step(TinyNet(), jax_losses(loss_cfg))
    state = JaxState.create(params=variables["params"], batch_stats=variables["batch_stats"],
                            tx=optax.sgd(0.1))
    m = jmesh.create_mesh(mesh_axes, jax.devices()[:4])
    inp, tgt = jmesh.shard_batch((jnp.asarray(data["inputs"].numpy()),
                                  jnp.asarray(data["targets"].numpy())), m)
    with fnn.intercept_methods(_interceptor(_nhwc(data["keep"]))):
        new, loss = jmesh.shard_train_step(step, m)(jmesh.replicate(state, m), inp, tgt,
                                                    jax.random.key(0))
    assert float(got["loss"]["total"]) == pytest.approx(float(loss["total"]), rel=1e-5)
    sd = tiny_twin_state_dict(variables)
    want = tiny_twin_state_dict(jax.tree.map(np.asarray, {"params": new.params,
                                                          "batch_stats": new.batch_stats}))
    for n, g in got["grads"].items():
        np.testing.assert_allclose((sd[n] - 0.1 * g).numpy(), want[n].numpy(), rtol=2e-4,
                                   atol=2e-6, err_msg=n)
    for n in ("bn.running_mean", "bn.running_var"):
        np.testing.assert_allclose(got["buffers"][n].numpy(), want[n].numpy(), rtol=2e-4,
                                   atol=2e-6, err_msg=n)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_cdan_sharded_step_matches_jax_single_device_step(runs):
    """The port's ``{"data": 2, "spatial": 2}`` CDAN step (Flax weights,
    charbonnier + SSIM, the same keep masks) against the JAX single-device
    step, by ``tests/test_torch_train.py``'s canonical criteria: the loss to
    1e-4 relative, the running statistics to 1e-3, each gradient leaf of
    scale >= 1e-4 to 1e-3 of its scale (JAX's gradient read from Adam's
    first moment, 0.1·g).  ``tests/test_parallel.py`` holds JAX's sharded
    step equal to its single-device step."""
    name = "cdan-jax-data2-spatial2"
    got = runs["ranks"][0][name]
    data = torch.load(runs["work"] / f"{name}.batch.pt")
    variables = runs["jax_cdan"]
    step = jax_make_step(JaxCDAN(), jax_losses(NOISE_LOSS))
    state = JaxState.create(params=variables["params"], batch_stats=variables["batch_stats"],
                            tx=optax.adam(1e-3))

    @jax.jit
    def run(st, x, t, keep):
        with fnn.intercept_methods(_interceptor(keep)):
            return step(st, x, t, jax.random.key(0), None)

    new, loss = run(state, jnp.asarray(data["inputs"].numpy()),
                    jnp.asarray(data["targets"].numpy()), _nhwc(data["keep"]))
    for k in ("total", "charbonnier", "ssim"):
        assert abs(float(got["loss"][k]) - float(loss[k])) <= 1e-4 * abs(float(loss[k])), k
    tree = state_dict_to_flax({**flax_to_state_dict(variables), **got["buffers"]})
    stats_got, stats_want = _leaves(tree["batch_stats"]), _leaves(new.batch_stats)
    assert max(float(np.abs(stats_got[k] - v).max()) for k, v in stats_want.items()) <= 1e-3
    grads = _leaves(state_dict_to_flax({**flax_to_state_dict(variables),
                                        **{n: 0.1 * g for n, g in got["grads"].items()}})["params"])
    mu = _leaves(new.opt_state[0].mu)
    worst = max((float(np.abs(grads[k] - v).max()) / float(np.abs(v).max()), k)
                for k, v in mu.items() if float(np.abs(v).max()) >= 1e-5)
    assert worst[0] <= 1e-3, worst
