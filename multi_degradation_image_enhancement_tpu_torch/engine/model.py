"""The restoration engine, train path (counterpart of
``multi_degradation_image_enhancement_tpu/engine/model.py``).

Same constructor contract (``Model(network, config=…, dataloader=…,
logger=…)``) and config keys as the JAX engine:

* Adam at ``train.lr``; best checkpoint by epoch train loss to
  ``train.model_path/model_name``, copied to the run dir as ``best.pt``;
  optional per-epoch weight files (``logging.checkpoints``);
* ``train.precision``: ``"bf16"`` runs the forward under a bf16 autocast with
  f32 parameters and f32 BatchNorm, and the loss on the f32 output
  (``model.py:198-204``, ``cdan.py:417``); ``"fp32"`` runs it all in f32.
  Default: bf16 on CUDA, fp32 on the CPU;
* ``train.fused_dense``: DenseBlocks through the growth-layer kernel;
* ``train.bn_recalibration``: after training, ``passes`` frozen-weight
  sweeps of the training data in ``stats_refresh`` mode re-estimate the
  checkpoint's BatchNorm statistics (``model.py:646``);
* the logger's epoch rows keep the JAX schema.

The device is explicit: ``train.device`` ``"cuda"`` or ``"tpu"`` means CUDA
and raises without a card; ``"cpu"`` runs on the CPU.  The test phase is not
ported yet (ROADMAP.md, queue 1), nor the train keys no shipped config sets:
``resume``, ``scan_chunk``, ``mesh``, ``remat``, ``lr_schedule``,
``grad_clip``, ``torch_init`` and ``logging.profiler``; each raises if set.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Dict, List

import torch

from multi_degradation_image_enhancement_tpu_torch.data.loader import batch_seed
from multi_degradation_image_enhancement_tpu_torch.engine import checkpoint as ckpt
from multi_degradation_image_enhancement_tpu_torch.engine.state import TrainState
from multi_degradation_image_enhancement_tpu_torch.ops.losses import build_loss_pipeline

UNPORTED_TRAIN_KEYS = ("resume", "scan_chunk", "mesh", "remat", "lr_schedule", "grad_clip",
                       "torch_init")


def resolve_device(name: str) -> torch.device:
    """``"cuda"``/``"tpu"`` → CUDA (raises without a card); ``"cpu"`` → CPU."""
    if name in ("cuda", "tpu") or str(name).startswith("cuda:"):
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {name!r} asks for CUDA, but no CUDA device is available")
        return torch.device("cuda" if name == "tpu" else name)
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unsupported device {name!r} (cuda, tpu or cpu)")


def make_train_step(loss_pipe, precision: str = "fp32"):
    """One optimizer step: forward, loss, backward, Adam, BatchNorm statistics.

    Returns ``step(state, inputs, targets, dropout=None, mask=None) -> loss
    dict`` (detached scalars, on the device).  ``dropout`` is a generator on
    the device or the four keep masks (``models.cdan.Dropout``)."""
    if precision not in ("bf16", "fp32"):
        raise ValueError(f"train.precision must be 'bf16' or 'fp32', got {precision!r}")
    bf16 = precision == "bf16"

    def step(state: TrainState, inputs, targets, dropout=None, mask=None) -> Dict[str, torch.Tensor]:
        model = state.model
        model.train()
        with torch.autocast(inputs.device.type, dtype=torch.bfloat16, enabled=bf16):
            outputs = model(inputs, dropout)
        loss_dict = loss_pipe(outputs, targets=targets, inputs=inputs, is_paired=True, mask=mask,
                              training=True)
        state.optimizer.zero_grad(set_to_none=True)
        loss_dict["total"].backward()
        state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in loss_dict.items()}

    return step


def _mean_of_dicts(dicts: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """Average device-scalar dicts with one host synchronisation."""
    if not dicts:
        return {}
    keys = list(dicts[0])
    means = torch.stack([torch.stack([d[k] for d in dicts]).mean() for k in keys])
    return dict(zip(keys, means.tolist()))


class Model:
    """The restoration engine's train path (reference ``models/model.py:25-363``)."""

    def __init__(self, network, config, dataloader, logger=None):
        self.config = config
        self.phase = config["phase"]
        if self.phase != "train":
            raise NotImplementedError("the test phase is not ported to PyTorch yet "
                                      "(ROADMAP.md, queue 1)")
        train_cfg = config["train"] or {}
        for key in UNPORTED_TRAIN_KEYS:
            if train_cfg.get(key):
                raise NotImplementedError(f"train.{key} is not ported to PyTorch yet (ROADMAP.md)")
        log_cfg = config.get("logging", {}) or {}
        if (log_cfg.get("profiler", {}) or {}).get("enabled"):
            raise NotImplementedError("logging.profiler is not ported to PyTorch yet (ROADMAP.md)")

        self.device = resolve_device(train_cfg.get("device") or "cpu")
        self.epoch = int(train_cfg["n_epoch"])
        self.lr = float(train_cfg["lr"])
        self.model_path = train_cfg["model_path"]
        self.model_name = train_cfg["model_name"]
        self.seed = int(train_cfg.get("seed", 42) or 42)
        self.precision = train_cfg.get("precision") or (
            "bf16" if self.device.type == "cuda" else "fp32")
        self.dataloader = dataloader
        self.logger = logger

        with torch.random.fork_rng(devices=[]):  # weights from train.seed alone
            torch.manual_seed(self.seed)
            for m in network.modules():
                if hasattr(m, "reset_parameters"):
                    m.reset_parameters()
        network.fused_dense = bool(train_cfg.get("fused_dense"))
        self.state = TrainState.create(network.to(self.device), self.lr)
        self.loss_pipe = build_loss_pipeline(config.get("loss", {}) or {})
        self._train_step = make_train_step(self.loss_pipe, self.precision)

        self.logging_enabled = bool(log_cfg.get("enabled", False))
        self.train_log_every = int((log_cfg.get("train", {}) or {}).get("log_every_n_batches", 0) or 0)
        ckpt_cfg = log_cfg.get("checkpoints", {}) or {}
        self.ckpt_enabled = bool(ckpt_cfg.get("enabled", False))
        self.ckpt_every = int(ckpt_cfg.get("every_n_epochs", 10) or 10)
        self.best_loss = float("inf")

    @property
    def network(self):
        return self.state.model

    def _log(self) -> bool:
        return self.logging_enabled and self.logger is not None

    def checkpoint_path(self) -> str:
        return os.path.join(self.model_path, self.model_name)

    def train(self):
        since = time.time()
        self.train_step()
        t = time.time() - since
        print(f"Training completed in {t // 60:.0f}m {t % 60:.0f}s")

    def train_step(self):
        for epoch in range(self.epoch):
            t0 = time.time()
            batch_dicts: List[Dict[str, torch.Tensor]] = []
            masks: List[torch.Tensor] = []
            for step_i, (inputs, targets, mask) in enumerate(self.dataloader):
                dropout = torch.Generator(device=self.device).manual_seed(
                    batch_seed(self.seed + 1, epoch, step_i))
                loss_dict = self._train_step(self.state, inputs, targets, dropout, mask)
                batch_dicts.append(loss_dict)
                masks.append(mask)
                if self._log() and self.train_log_every > 0 and (step_i + 1) % self.train_log_every == 0:
                    row = {"type": "batch", "epoch": epoch + 1, "step": step_i + 1}
                    row.update({f"loss_{k}": float(v) for k, v in loss_dict.items()})
                    self.logger.log_train(row)

            avg = _mean_of_dicts(batch_dicts)
            n_images = int(torch.cat(masks).sum().item()) if masks else 0
            epoch_loss = avg.get("total", float("nan"))
            epoch_time = time.time() - t0
            if epoch_loss < self.best_loss:  # best checkpoint by train loss (reference parity)
                self.best_loss = epoch_loss
                ckpt.save_weights(self.checkpoint_path(), self.network)
                self._copy_best_to_run_dir()
            if self._log():
                row = {"type": "epoch", "epoch": epoch + 1, "epoch_time_sec": float(epoch_time),
                       "images_per_sec": float(n_images / max(epoch_time, 1e-9)),
                       "lr": float(self.lr), "best_loss_so_far": float(self.best_loss)}
                row.update({f"loss_{k}": float(v) for k, v in avg.items()})
                self.logger.log_train(row)
                self.logger.set_summary({"best_train_loss": float(self.best_loss),
                                         "epochs_completed": int(epoch + 1)})
            self._maybe_save_epoch_weights(epoch)
            comps = ", ".join(f"{k}: {v:.4f}" for k, v in avg.items() if k != "total")
            print(f"Epoch [{epoch + 1}/{self.epoch}] Train total: {epoch_loss:.4f}"
                  + (f" | {comps}" if comps else "") + f" | best: {self.best_loss:.4f}")

        recal = (self.config["train"] or {}).get("bn_recalibration")
        if recal:
            self.recalibrate_bn(int(recal.get("passes", 3)) if isinstance(recal, dict) else 3)

    @torch.no_grad()
    def recalibrate_bn(self, passes: int = 3) -> None:
        """Re-estimate the checkpoint's BatchNorm statistics: ``passes``
        dropout-free sweeps of the training data in ``stats_refresh`` mode
        with the checkpoint's weights, then rewrite the checkpoint.  The
        original stays beside it as ``<name>.prerecal``."""
        path = self.checkpoint_path()
        if not os.path.isfile(path):
            print(f"[BN-RECAL] no checkpoint at {path} to recalibrate; skipped")
            return
        shutil.copyfile(path, path + ".prerecal")
        model = ckpt.load_weights(path, self.network)
        model.eval()
        model.stats_refresh = True
        try:
            for _ in range(passes):
                for inputs, _, _ in self.dataloader:
                    with torch.autocast(inputs.device.type, dtype=torch.bfloat16,
                                        enabled=self.precision == "bf16"):
                        model(inputs)
        finally:
            model.stats_refresh = False
        ckpt.save_weights(path, model)
        self._copy_best_to_run_dir()
        if self._log():
            self.logger.set_summary({"bn_recalibration_passes": int(passes)})
        print(f"[BN-RECAL] checkpoint stats re-estimated ({passes} passes) -> {path}")

    def _maybe_save_epoch_weights(self, epoch: int) -> None:
        run_dir = self.logger.run_dir() if self._log() else None
        if not (run_dir and self.ckpt_enabled and self.ckpt_every > 0):
            return
        if (epoch + 1) % self.ckpt_every == 0:
            ckpt.save_weights(os.path.join(run_dir, "checkpoints", f"epoch_{epoch + 1:03d}.pt"),
                              self.network)

    def _copy_best_to_run_dir(self) -> None:
        run_dir = self.logger.run_dir() if self._log() else None
        if run_dir and os.path.isfile(self.checkpoint_path()):
            shutil.copyfile(self.checkpoint_path(), os.path.join(run_dir, "best.pt"))

    def test(self):
        raise NotImplementedError("the test phase is not ported to PyTorch yet (ROADMAP.md, queue 1)")
