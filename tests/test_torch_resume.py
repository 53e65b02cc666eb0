"""PyTorch port: full-state checkpoints and ``train.resume``, the epoch
checkpoints and loss plots of a CLI run, and ``recalibrate_bn``.

The port's full state is its own format (``engine/checkpoint.py``); what
is held against the JAX package is Adam's state (optax's ``mu`` / ``nu``)
and the CLI's artifacts (``tests/test_engine.py:104-126,151-162``,
``tests/test_bn_recalibration.py:61-140``).
"""

import copy
import json
import shutil

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multi_degradation_image_enhancement_tpu_torch import recalibrate_bn, run
from multi_degradation_image_enhancement_tpu_torch.engine import checkpoint as ckpt
from multi_degradation_image_enhancement_tpu_torch.engine.model import make_train_step
from multi_degradation_image_enhancement_tpu_torch.engine.state import TrainState, build_schedule
from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN
from multi_degradation_image_enhancement_tpu_torch.models.torch_init import flax_default_init_
from multi_degradation_image_enhancement_tpu_torch.ops.losses import build_loss_pipeline
from multi_degradation_image_enhancement_tpu_torch.utils.config import load_config
from tests.test_torch_train import DROP_SITES, _loss_cfg
from tests.torch_train_cli import write_tiny_config

torch.set_num_threads(1)  # tiny CPU runs stall under many threads per xdist worker

B, H, W = 2, 16, 24


def _batch(seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((B, H, W, 3), generator=g)
    t = torch.clamp(x + 0.1 * torch.randn(x.shape, generator=g), 0.0, 1.0)
    masks = [torch.rand((B, c, H // p, W // p), generator=g) < 0.8 for c, p in DROP_SITES]
    return x, t, masks


def _state(seed):
    model = flax_default_init_(CDAN(), torch.Generator().manual_seed(seed))
    schedule = build_schedule({"name": "cosine", "args": {"decay_steps": 4}}, 1e-3, 99)
    return TrainState.create(model, 1e-3, schedule, grad_clip=0.5)


def test_restore_then_step_bit_equals_the_continued_step(tmp_path):
    """fp32 on the CPU under a cosine schedule and clipping: one step, a
    save, a second step; a fresh state of other weights restored from the
    save and stepped on the same batch ends bit for bit where the first
    one did (weights, BatchNorm statistics, Adam's moments and step), at the
    schedule's count 1."""
    step = make_train_step(build_loss_pipeline(_loss_cfg(), "cpu"), "fp32")
    state = _state(0)
    step(state, *_batch(1))
    ckpt.save_train_state(str(tmp_path / "state_001"), state)
    assert sorted(p.name for p in (tmp_path / "state_001").iterdir()) == ["state.pt"]
    loss = step(state, *_batch(2))

    other = _state(7)
    assert not torch.equal(other.model.encoder.conv1.conv.weight,
                           state.model.encoder.conv1.conv.weight)
    ckpt.restore_train_state(str(tmp_path / "state_001"), other)
    assert other.step == 1
    loss2 = step(other, *_batch(2))
    assert torch.equal(loss["total"], loss2["total"])
    assert other.step == state.step == 2
    for (name, a), (_, b) in zip(state.model.state_dict().items(),
                                 other.model.state_dict().items()):
        assert torch.equal(a, b), name
    for pa, pb in zip(state.model.parameters(), other.model.parameters()):
        sa, sb = state.optimizer.state[pa], other.optimizer.state[pb]
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[key], sb[key]), key
    want_lr = state.schedule(1)
    assert state.optimizer.param_groups[0]["lr"] == other.optimizer.param_groups[0]["lr"] == want_lr


def test_adam_state_matches_optax_and_round_trips(tmp_path):
    """Two fed gradients: Adam's ``exp_avg`` / ``exp_avg_sq`` equal optax's
    ``mu`` / ``nu`` to 1e-6 of each leaf's largest and its ``step`` optax's
    ``count``; the parameters agree to 4 f32 ulps of their value (two
    additions a side, each rounded) plus 1e-4 of lr (PyTorch's and optax's
    Adam place eps and the bias corrections differently, which moves an
    update's f32 rounding); a save and restore keeps them bit for bit."""
    rng = np.random.RandomState(0)
    shapes = [(16, 8, 3, 3), (16,), (32, 16)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) * 0.1 for s in shapes] for _ in range(2)]
    model = torch.nn.ParameterList([torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params])
    state = TrainState.create(model, 1e-3)
    tx = optax.adam(1e-3)
    jparams = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jparams)
    for g in grads:
        for p, gi in zip(model, g):
            p.grad = torch.from_numpy(gi.copy())
        state.apply_gradients()
        updates, opt_state = tx.update([jnp.asarray(gi) for gi in g], opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    adam = opt_state[0]
    assert int(adam.count) == state.step == 2
    for i, p in enumerate(model):
        st = state.optimizer.state[p]
        assert float(st["step"]) == 2.0
        for mine, theirs in ((st["exp_avg"], adam.mu[i]), (st["exp_avg_sq"], adam.nu[i])):
            want = np.asarray(theirs)
            assert np.abs(mine.numpy() - want).max() <= 1e-6 * np.abs(want).max(), i
        want = np.asarray(jparams[i])
        excess = np.abs(p.detach().numpy() - want) - 4.0 * np.spacing(np.abs(want))
        assert float(excess.max()) <= 1e-4 * 1e-3, i  # measured 1.6e-5 of lr

    ckpt.save_train_state(str(tmp_path / "s"), state)
    fresh = TrainState.create(copy.deepcopy(model), 1e-3)
    ckpt.restore_train_state(str(tmp_path / "s"), fresh)
    assert fresh.step == 2
    for p, q in zip(model, fresh.model):
        assert torch.equal(p, q)
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(state.optimizer.state[p][key], fresh.optimizer.state[q][key])


def _two_epoch_config(tmp_path):
    cfg = json.loads(write_tiny_config(tmp_path).read_text())
    cfg["train"]["n_epoch"] = 2
    cfg["train"]["lr_schedule"] = "cosine"
    cfg["logging"]["checkpoints"] = {"enabled": True, "every_n_epochs": 1}
    return cfg


def test_cli_writes_epoch_states_and_plots_then_resumes(tmp_path, capsys):
    """Two CPU epochs with checkpoints every epoch: ``checkpoints/
    epoch_00{1,2}.pt`` (strict weight files) each with its full state
    ``state_00{1,2}/``, ``plots/loss_total.png`` and two epoch rows (the JAX
    engine's artifacts, tests/test_engine.py).  A one-epoch run resumed from
    ``state_001`` starts at step 2 and ends at step 4."""
    cfg = _two_epoch_config(tmp_path)
    path = tmp_path / "two.json"
    path.write_text(json.dumps(cfg))
    engine = run.main(load_config(str(path), phase="train"))
    assert engine.state.step == 4
    (run_dir,) = (tmp_path / "runs" / "noise_synthetic").iterdir()
    ckpts = run_dir / "checkpoints"
    assert sorted(p.name for p in ckpts.iterdir()) == [
        "epoch_001.pt", "epoch_002.pt", "state_001", "state_002"]
    for name in ("epoch_001.pt", "epoch_002.pt"):
        ckpt.load_weights(str(ckpts / name), CDAN())
    assert (run_dir / "plots" / "loss_total.png").is_file()
    rows = [json.loads(line) for line in (run_dir / "train.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows if r["type"] == "epoch"] == [1, 2]
    assert json.loads((run_dir / "summary.json").read_text())["epochs_completed"] == 2

    capsys.readouterr()
    cfg["train"].update(n_epoch=1, resume=str(ckpts / "state_001"),
                        model_path=str(tmp_path / "weights_resumed"))
    cfg["logging"]["root_dir"] = str(tmp_path / "runs_resumed")
    path.write_text(json.dumps(cfg))
    resumed = run.main(load_config(str(path), phase="train"))
    out = capsys.readouterr().out
    assert f"[CKPT] Resumed from {ckpts / 'state_001'} at step 2" in out
    assert resumed.state.step == 4
    # T of the resumed run is its own config's: 1 epoch x 2 steps, so counts 2-3 sit at alpha
    assert resumed.state.optimizer.param_groups[0]["lr"] == pytest.approx(cfg["train"]["lr"] * 0.01)
    ckpt.load_weights(str(tmp_path / "weights_resumed" / cfg["train"]["model_name"]), CDAN())


def test_recalibrate_bn_cli_rewrites_the_checkpoint(tmp_path, capsys):
    """``python -m …_torch.recalibrate_bn -c cfg --passes 2`` on a trained
    checkpoint: the original kept as ``.prerecal``, the parameters
    untouched, the BatchNorm statistics re-estimated, the passes in the
    summary (``tools/recalibrate_bn.py``, tests/test_bn_recalibration.py)."""
    cfg = json.loads(write_tiny_config(tmp_path).read_text())
    cfg["train"]["bn_recalibration"] = False
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    run.main(load_config(str(path), phase="train"))
    weights = tmp_path / "weights" / cfg["train"]["model_name"]
    trained = torch.load(weights, weights_only=True)
    assert not (tmp_path / "weights" / f"{weights.name}.prerecal").exists()
    shutil.rmtree(tmp_path / "runs")

    recalibrate_bn.main(["-c", str(path), "--passes", "2"])
    assert "[BN-RECAL] checkpoint stats re-estimated (2 passes)" in capsys.readouterr().out
    backup = torch.load(f"{weights}.prerecal", weights_only=True)
    new = torch.load(weights, weights_only=True)
    moved = 0
    for k, v in trained.items():
        assert torch.equal(backup[k], v), k
        if k.endswith(("running_mean", "running_var")):
            moved += int(not torch.equal(new[k], v))
        elif not k.endswith("num_batches_tracked"):
            assert torch.equal(new[k], v), k
    assert moved >= 30  # of 64 statistics
    (run_dir,) = (tmp_path / "runs" / "noise_synthetic").iterdir()
    assert json.loads((run_dir / "summary.json").read_text())["bn_recalibration_passes"] == 2
