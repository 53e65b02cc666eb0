"""The restoration engine (counterpart of
``multi_degradation_image_enhancement_tpu/engine/model.py``).

Same constructor contract (``Model(network, config=…, dataloader=…,
logger=…)``) and config keys as the JAX engine.  Train phase:

* the weights drawn from ``train.seed``: Flax's defaults
  (``models.torch_init.flax_default_init_``), or PyTorch's with
  ``train.torch_init`` (``torch_reinit_``), as the JAX engine draws them
  (``model.py:319-335``);
* Adam at ``train.lr``, under ``train.lr_schedule`` (``"cosine"`` /
  ``"linear"``, ``engine.state.build_schedule``) and after
  ``train.grad_clip`` (clipping by the global norm), as
  ``optax.chain(clip_by_global_norm, adam(schedule))`` (``model.py:213-251``);
  the epoch rows' ``lr`` stays ``train.lr``, as JAX logs it;
* best checkpoint by epoch train loss to ``train.model_path/model_name``,
  copied to the run dir as ``best.pt``; with ``logging.checkpoints`` every
  ``every_n_epochs`` epochs a weight file ``checkpoints/epoch_NNN.pt`` and a
  full-state ``checkpoints/state_NNN/`` (``engine.checkpoint``);
* ``train.resume``: a ``state_NNN`` directory restored before the first
  step (weights, Adam's moments, the step and so the schedule's position);
  epochs, dropout seeds and the best loss start afresh, as in the JAX loop
  (``model.py:543-575``);
* ``train.precision``: ``"bf16"`` runs the forward under a bf16 autocast with
  f32 parameters and f32 BatchNorm, and the loss on the f32 output
  (``model.py:198-204``, ``cdan.py:417``); ``"fp32"`` runs it all in f32.
  Default: bf16 on CUDA, fp32 on the CPU;
* ``train.fused_dense``: DenseBlocks through the growth-layer kernel;
* ``train.remat``: every ConvBlock, DenseBlock and CBAM rematerialised in the
  backward (``models.cdan``); both are a CDAN's, and either set on another
  network stops the build;
* ``logging.profiler`` ``{enabled, trace_epochs}``: each listed epoch
  (1-based) under ``torch.profiler`` (CPU, and CUDA on the card), its Chrome
  trace written to ``<run_dir>/profile/`` (``model.py:287-291,551-556``)
  with the port's spans (``utils.tracing``) among its host ops; the epoch's
  device ranges (count and device ms a span name, ``train/step``,
  ``train/forward``, ``loss/lpips``, ...) printed beside the trace's path;
* ``train.bn_recalibration``: after training, ``passes`` frozen-weight
  sweeps of the training data in ``stats_refresh`` mode re-estimate the
  checkpoint's BatchNorm statistics (``model.py:646``);
* the logger's epoch rows keep the JAX schema.

Test phase (``model.py:464-534,756-928``): a strict load of
``test.model_path/model_name``; the network's served forward, a CDAN's
``models.cdan_fast.build_serving_apply`` or a Restormer's
``models.restormer.serving_forward`` (``test.fused_kernels`` /
``model.fused_kernels``: ``"auto"`` takes it on CUDA and the module on the
CPU, ``true`` forces it, ``false`` takes the module) in the precision of
``train.precision``; per batch the loss and metrics pipelines with
mask-aware means (the PRE stage), averaged over batches; with
``post_processing.enabled`` the op chain of ``ops.post_processing`` on the
outputs and, when ``evaluation.postprocessed`` (default: enabled), the same
pipelines on them (the POST stage); the raw and post-processed outputs
written as images by a pool of writer threads (``save_outputs``); ``test``
rows (``pre``, ``post``) and the summary through the logger.

The device is the card unless the config asks for the CPU:
``<phase>.device`` missing, null, ``"cuda"`` or ``"tpu"`` means CUDA and
raises without a card; ``"cpu"`` runs on the CPU.

``train.scan_chunk`` K > 1 (``model.py:293-296,398-460``): the one epoch
loop reads its ``batch`` log rows back once every K steps instead of once a
step, so K optimizer steps run back to back with no host synchronisation
between them.  The loader already hands over device batches and the steps
already queue without a host read, so nothing else differs: each step draws
its dropout as it does with ``scan_chunk: 0``, and the run is that run bit
for bit, under ``train.mesh`` too.

``train.mesh`` (``parallel.mesh``): under ``torchrun`` with one process per
GPU, the train step runs on each rank's shard of every global batch (its
``data`` rows, and with ``spatial`` its H rows; every rank builds the global
batch from the shared generators and keeps its rows), with sync-BN, the
loss's global means and one gradient all-reduce: a sharded step is the
single-device step on the global batch.  The mesh must span the world
(``torchrun --nproc_per_node N``); one process without a process group runs
the plain step.  The epoch rows count the global batch.  Only the primary
(rank 0) writes checkpoints, the logger's files, plots and traces, each
write followed by a barrier.  Every rank reads ``train.resume``, so ranks
on several nodes need a shared checkpoint directory for it.  BN
recalibration runs through sync-BN on the sharded batches, on the weights
the primary read and broadcast.  ``-p test`` stays unsharded: the primary
scores and writes outputs.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional

import torch

from multi_degradation_image_enhancement_tpu_torch.data import io_native
from multi_degradation_image_enhancement_tpu_torch.data.loader import batch_seed
from multi_degradation_image_enhancement_tpu_torch.engine import checkpoint as ckpt
from multi_degradation_image_enhancement_tpu_torch.engine.state import TrainState, build_schedule
from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN, eval_forward
from multi_degradation_image_enhancement_tpu_torch.models.cdan_fast import build_serving_apply
from multi_degradation_image_enhancement_tpu_torch.models.restormer import Restormer, serving_forward
from multi_degradation_image_enhancement_tpu_torch.models.torch_init import (
    flax_default_init_,
    torch_reinit_,
)
from multi_degradation_image_enhancement_tpu_torch.ops.losses import build_loss_pipeline
from multi_degradation_image_enhancement_tpu_torch.ops.metrics import build_metrics_pipeline
from multi_degradation_image_enhancement_tpu_torch.ops.perceptual import weight_status
from multi_degradation_image_enhancement_tpu_torch.ops.post_processing import apply_postprocessing
from multi_degradation_image_enhancement_tpu_torch.parallel import collectives, distributed
from multi_degradation_image_enhancement_tpu_torch.parallel.mesh import (
    mesh_from_config,
    replicate,
    shard_batch,
    shard_train_step,
)
from multi_degradation_image_enhancement_tpu_torch.utils import tracing


def resolve_device(name: Optional[str]) -> torch.device:
    """``None``/``"cuda"``/``"tpu"`` → CUDA (raises without a card);
    ``"cpu"`` → CPU."""
    if name is None:
        name = "cuda"
    if name in ("cuda", "tpu") or str(name).startswith("cuda:"):
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {name!r} asks for CUDA, but no CUDA device is available")
        return torch.device("cuda" if name == "tpu" else name)
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unsupported device {name!r} (cuda, tpu or cpu)")


def make_train_step(loss_pipe, precision: str = "fp32"):
    """One optimizer step: forward, loss, backward, the state's update
    (clipping, schedule, Adam), BatchNorm statistics.

    Returns ``step(state, inputs, targets, dropout=None, mask=None) -> loss
    dict`` (detached scalars, on the device).  ``dropout`` is a generator on
    the device or the four keep masks (``models.cdan.Dropout``).  Spans
    (``utils.tracing``, device ranges on the card): ``train/step`` around
    the whole, ``train/forward`` (the autocast forward), ``train/loss``,
    ``train/backward`` (``zero_grad`` and ``.backward()``) and
    ``train/optimizer`` (``apply_gradients``) inside it."""
    if precision not in ("bf16", "fp32"):
        raise ValueError(f"train.precision must be 'bf16' or 'fp32', got {precision!r}")
    bf16 = precision == "bf16"

    def step(state: TrainState, inputs, targets, dropout=None, mask=None) -> Dict[str, torch.Tensor]:
        dev = inputs.device
        with tracing.span("train/step", device=dev):
            model = state.model
            model.train()
            with tracing.span("train/forward", device=dev), torch.autocast(
                    inputs.device.type, dtype=torch.bfloat16, enabled=bf16):
                outputs = model(inputs, dropout)
            with tracing.span("train/loss", device=dev):
                loss_dict = loss_pipe(outputs, targets=targets, inputs=inputs, is_paired=True,
                                      mask=mask, training=True)
            with tracing.span("train/backward", device=dev):
                state.optimizer.zero_grad(set_to_none=True)
                loss_dict["total"].backward()
            with tracing.span("train/optimizer", device=dev):
                state.apply_gradients()
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
    """The restoration engine (reference ``models/model.py:25-363``)."""

    def __init__(self, network, config, dataloader, logger=None):
        self.config = config
        self.phase = config["phase"]
        if self.phase not in ("train", "test"):
            raise ValueError(f"phase must be 'train' or 'test', got {self.phase!r}")
        phase_cfg = config[self.phase] or {}
        train_cfg = config["train"] or {}
        log_cfg = config.get("logging", {}) or {}
        self.postproc_cfg = config.get("post_processing", {}) or {}

        self.device = resolve_device(phase_cfg.get("device"))
        self.epoch = int(train_cfg["n_epoch"])
        self.lr = float(train_cfg["lr"])
        self.model_path = phase_cfg["model_path"]
        self.model_name = phase_cfg["model_name"]
        self.seed = int(train_cfg.get("seed", 42) or 42)
        # the eval precision follows train.precision too (model.py:198-204)
        self.precision = train_cfg.get("precision") or (
            "bf16" if self.device.type == "cuda" else "fp32")
        self.dataloader = dataloader
        self.logger = logger

        self.loss_pipe = build_loss_pipeline(config.get("loss", {}) or {}, self.device)
        self.metrics_pipe = build_metrics_pipeline(config.get("metrics", {}) or {}, self.device)
        test_cfg = config.get("test", {}) or {}
        paired = ((test_cfg.get("dataset", {}) or {}).get("is_paired"))
        self.is_dataset_paired = True if paired is None else bool(paired)
        self.save_cfg = dict(config.get("save_outputs", {}) or {})
        self.save_cfg.setdefault("output_dir", test_cfg.get("output_images_path") or "outputs/")
        self.save_cfg.setdefault("save_raw", False)
        self.save_cfg.setdefault("save_postprocessed", True)
        self.save_cfg.setdefault("raw_prefix", "raw_")
        self.save_cfg.setdefault("post_prefix", self.save_cfg.get("prefix", "output_"))
        eval_cfg = config.get("evaluation", {}) or {}
        self.eval_on_raw = True if eval_cfg.get("raw") is None else bool(eval_cfg["raw"])
        self.post_enabled = bool(self.postproc_cfg.get("enabled", False))
        self.eval_on_post = self.post_enabled and (
            eval_cfg.get("postprocessed") is None or bool(eval_cfg["postprocessed"]))
        self._writer_pool: Optional[ThreadPoolExecutor] = None
        self._writer_futures: List[Future] = []

        self.scan_chunk = int(train_cfg.get("scan_chunk", 0) or 0)
        self.state: Optional[TrainState] = None
        self.mesh = None  # the train step's mesh (``train.mesh``), or None
        self._eval_network = network
        if self.phase == "train":
            init_gen = torch.Generator().manual_seed(self.seed)  # weights from train.seed alone
            if train_cfg.get("torch_init"):
                torch_reinit_(network, init_gen)
                print("[ENGINE] torch-default re-initialization applied")
            else:
                flax_default_init_(network, init_gen)
            if isinstance(network, CDAN):
                network.fused_dense = bool(train_cfg.get("fused_dense"))
                network.remat = bool(train_cfg.get("remat"))
            else:
                cdan_only = [k for k in ("fused_dense", "remat") if train_cfg.get(k)]
                if cdan_only:
                    raise ValueError(f"train.{' and train.'.join(cdan_only)} name CDAN modules; "
                                     f"the network is a {type(network).__name__}")
            sched_cfg = train_cfg.get("lr_schedule")
            schedule = build_schedule(sched_cfg, self.lr, self.epoch * max(len(dataloader), 1)
                                      ) if sched_cfg else None
            self.state = TrainState.create(network.to(self.device), self.lr, schedule,
                                           train_cfg.get("grad_clip"))
            self._train_step = make_train_step(self.loss_pipe, self.precision)
            self.mesh = mesh_from_config(train_cfg.get("mesh"))
            if self.mesh is not None:
                replicate(self.state, self.mesh)
                self._train_step = shard_train_step(self._train_step, self.mesh)
                print(f"[ENGINE] train step sharded over {self.mesh.shape}")
        self.resume_dir = train_cfg.get("resume")

        self.logging_enabled = bool(log_cfg.get("enabled", False))
        self.train_log_every = int((log_cfg.get("train", {}) or {}).get("log_every_n_batches", 0) or 0)
        ckpt_cfg = log_cfg.get("checkpoints", {}) or {}
        self.ckpt_enabled = bool(ckpt_cfg.get("enabled", False))
        self.ckpt_every = int(ckpt_cfg.get("every_n_epochs", 10) or 10)
        self.best_loss = float("inf")
        prof_cfg = log_cfg.get("profiler", {}) or {}
        self.profile_epochs = (set(prof_cfg.get("trace_epochs", []) or [])
                               if prof_cfg.get("enabled") else set())

        # Results say which feature networks run on pretrained weights and
        # which on seeded random frozen ones (model.py:305-313).
        status = weight_status()
        if status and self._log():
            self.logger.set_summary({"pretrained_weights": status})

    @property
    def network(self):
        return self.state.model if self.state is not None else self._eval_network

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
        if self.resume_dir:
            ckpt.restore_train_state(self.resume_dir, self.state)
            print(f"[CKPT] Resumed from {self.resume_dir} at step {self.state.step}")
        for epoch in range(self.epoch):
            t0 = time.time()
            with self._profiled(epoch):
                batch_dicts, masks = self._train_epoch(epoch)
            avg = _mean_of_dicts(batch_dicts)
            n_images = int(torch.cat(masks).sum().item()) if masks else 0
            epoch_loss = avg.get("total", float("nan"))
            epoch_time = time.time() - t0
            if epoch_loss < self.best_loss:  # best checkpoint by train loss (reference parity)
                self.best_loss = epoch_loss
                if distributed.is_primary():
                    ckpt.save_weights(self.checkpoint_path(), self.network)
                    self._copy_best_to_run_dir()
                distributed.barrier()
            if self._log():
                row = {"type": "epoch", "epoch": epoch + 1, "epoch_time_sec": float(epoch_time),
                       "images_per_sec": float(n_images / max(epoch_time, 1e-9)),
                       "lr": float(self.lr), "best_loss_so_far": float(self.best_loss)}
                row.update({f"loss_{k}": float(v) for k, v in avg.items()})
                self.logger.log_train(row)
                self.logger.set_summary({"best_train_loss": float(self.best_loss),
                                         "epochs_completed": int(epoch + 1)})
            self._maybe_save_epoch_checkpoint(epoch)  # the primary's logger alone has a run dir
            distributed.barrier()
            comps = ", ".join(f"{k}: {v:.4f}" for k, v in avg.items() if k != "total")
            print(f"Epoch [{epoch + 1}/{self.epoch}] Train total: {epoch_loss:.4f}"
                  + (f" | {comps}" if comps else "") + f" | best: {self.best_loss:.4f}")

        recal = (self.config["train"] or {}).get("bn_recalibration")
        if recal:
            self.recalibrate_bn(int(recal.get("passes", 3)) if isinstance(recal, dict) else 3)

    def _train_epoch(self, epoch: int):
        """One pass over the loader: ``(loss dicts, masks)`` of its steps.
        The ``batch`` log rows are read back every ``scan_chunk`` steps (every
        step without it), and the epoch's last rows after its last step.
        JAX pads a final partial chunk with valid=0 steps whose state update
        is a no-op (model.py:420-423); here it runs its real steps only, so
        the state after it is the same."""
        batch_dicts: List[Dict[str, torch.Tensor]] = []
        masks: List[torch.Tensor] = []
        pending: List[int] = []  # steps whose log rows are not yet read back
        for step_i, (inputs, targets, mask) in enumerate(self.dataloader):
            dropout = torch.Generator(device=self.device).manual_seed(
                batch_seed(self.seed + 1, epoch, step_i))
            batch = (inputs, targets, mask)
            if self.mesh is not None:  # this rank's rows (and H rows) of the global batch
                batch = shard_batch(batch, self.mesh)
            batch_dicts.append(self._train_step(self.state, *batch[:2], dropout, batch[2]))
            masks.append(mask)
            if self._log() and self.train_log_every > 0 and (step_i + 1) % self.train_log_every == 0:
                pending.append(step_i)
            if len(batch_dicts) % max(self.scan_chunk, 1) == 0:
                self._log_batches(epoch, pending, batch_dicts)
                pending = []
        self._log_batches(epoch, pending, batch_dicts)
        return batch_dicts, masks

    def _log_batches(self, epoch: int, steps: List[int],
                     batch_dicts: List[Dict[str, torch.Tensor]]) -> None:
        """The ``batch`` log rows of ``steps``, read back in one transfer."""
        if not steps:
            return
        keys = list(batch_dicts[0])
        host = torch.stack([torch.stack([batch_dicts[i][k] for k in keys])
                            for i in steps]).tolist()
        for step_i, values in zip(steps, host):
            row = {"type": "batch", "epoch": epoch + 1, "step": step_i + 1}
            row.update({f"loss_{k}": v for k, v in zip(keys, values)})
            self.logger.log_train(row)

    @contextlib.contextmanager
    def _profiled(self, epoch: int):
        """``torch.profiler`` around epoch ``epoch`` (0-based) when
        ``logging.profiler`` lists it (1-based) and a run dir exists: CPU
        activity, and CUDA activity on the card (which the profiler must
        support there), exported as ``profile/epoch_NNN.json``; the epoch's
        device ranges (``utils.tracing.device_totals()``) printed beside
        the path, then reset."""
        run_dir = self.logger.run_dir() if self.logger is not None else None
        if (epoch + 1) not in self.profile_epochs or not run_dir:
            yield
            return
        from torch.profiler import ProfilerActivity, profile, supported_activities

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            if ProfilerActivity.CUDA not in supported_activities():
                raise RuntimeError("logging.profiler: this PyTorch cannot trace CUDA activity")
            activities.append(ProfilerActivity.CUDA)
        trace_dir = os.path.join(run_dir, "profile")
        print(f"[PROFILER] tracing epoch {epoch + 1} -> {trace_dir}")
        tracing.reset()
        with profile(activities=activities) as prof:
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)  # every kernel of the epoch in the trace
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"epoch_{epoch + 1:03d}.json")
        prof.export_chrome_trace(path)
        ranges = ", ".join(f"{name} {ms:.3f} ms over {n}"
                           for name, (n, ms) in sorted(tracing.device_totals().items()))
        tracing.reset()
        print(f"[PROFILER] epoch {epoch + 1}: {path}; device ranges: {ranges or 'none'}")

    @torch.no_grad()
    def recalibrate_bn(self, passes: int = 3) -> None:
        """Re-estimate the checkpoint's BatchNorm statistics: ``passes``
        dropout-free sweeps of the training data in ``stats_refresh`` mode
        with the checkpoint's weights, then rewrite the checkpoint.  The
        original stays beside it as ``<name>.prerecal``.  Under several
        processes the primary alone reads the checkpoint and broadcasts
        whether there is one and its weights, so the ranks need not share a
        filesystem."""
        path = self.checkpoint_path()
        primary = distributed.is_primary()
        found = torch.tensor(int(primary and os.path.isfile(path)), device=self.device)
        distributed.broadcast_from_primary([found])
        if not found.item():
            print(f"[BN-RECAL] no checkpoint at {path} to recalibrate; skipped")
            return
        model = self.network
        if primary:
            ckpt.load_weights(path, model)
            shutil.copyfile(path, path + ".prerecal")
        distributed.broadcast_from_primary([*model.parameters(), *model.buffers()])
        model.eval()
        model.stats_refresh = True
        try:
            with collectives.use_mesh(self.mesh):  # sync-BN over the sharded batches
                for _ in range(passes):
                    for inputs, _, _ in self.dataloader:
                        if self.mesh is not None:
                            inputs = shard_batch(inputs, self.mesh)
                        with torch.autocast(inputs.device.type, dtype=torch.bfloat16,
                                            enabled=self.precision == "bf16"):
                            model(inputs)
        finally:
            model.stats_refresh = False
        if distributed.is_primary():
            ckpt.save_weights(path, model)
            self._copy_best_to_run_dir()
        distributed.barrier()
        if self._log():
            self.logger.set_summary({"bn_recalibration_passes": int(passes)})
        print(f"[BN-RECAL] checkpoint stats re-estimated ({passes} passes) -> {path}")

    def _maybe_save_epoch_checkpoint(self, epoch: int) -> None:
        """Every ``every_n_epochs`` epochs: ``checkpoints/epoch_NNN.pt`` (the
        weights) and the full-state ``checkpoints/state_NNN/`` beside it."""
        run_dir = self.logger.run_dir() if self._log() else None
        if not (run_dir and self.ckpt_enabled and self.ckpt_every > 0):
            return
        if (epoch + 1) % self.ckpt_every == 0:
            ckpt_dir = os.path.join(run_dir, "checkpoints")
            ckpt.save_weights(os.path.join(ckpt_dir, f"epoch_{epoch + 1:03d}.pt"), self.network)
            ckpt.save_train_state(os.path.join(ckpt_dir, f"state_{epoch + 1:03d}"), self.state)

    def _copy_best_to_run_dir(self) -> None:
        run_dir = self.logger.run_dir() if self._log() else None
        if run_dir and os.path.isfile(self.checkpoint_path()):
            shutil.copyfile(self.checkpoint_path(), os.path.join(run_dir, "best.pt"))


    # ------------------------------------------------------------------ test

    def test(self):
        """Scores on one process: the primary (the JAX engine builds its
        eval step without the mesh)."""
        if distributed.is_primary():
            self.test_step()
        distributed.barrier()

    def _load_for_eval(self) -> torch.nn.Module:
        """The checkpoint at ``model_path/model_name``, loaded strictly into
        the fresh network, in eval mode on the device."""
        return ckpt.load_weights(self.checkpoint_path(), self._eval_network).to(self.device).eval()

    def _fused_eval_forward(self, model: torch.nn.Module):
        """The network's served forward (a CDAN's ``build_serving_apply``, a
        Restormer's ``serving_forward``), or None for the module.

        ``test.fused_kernels`` or else ``model.fused_kernels``: ``false`` →
        the module; ``"auto"`` (the default) → the served forward on CUDA and
        the module on the CPU; anything else, ``true`` included, forces the
        served forward (the kernels' plain versions on the CPU).  A network
        with no served forward keeps the module unless ``true`` asks for
        more."""
        flag = (self.config.get("test", {}) or {}).get("fused_kernels")
        if flag is None:
            flag = (self.config.get("model", {}) or {}).get("fused_kernels", "auto")
        if flag is False or (flag == "auto" and self.device.type == "cpu"):
            return None
        dtype = torch.bfloat16 if self.precision == "bf16" else torch.float32
        if isinstance(model, CDAN):
            return build_serving_apply(model, dtype, self.device)
        if isinstance(model, Restormer):
            return serving_forward(model, dtype, self.device)
        if flag is True:
            raise RuntimeError(f"fused_kernels=true but the network is a "
                               f"{type(model).__name__}, which has no served forward "
                               f"(a CDAN and a Restormer have one)")
        return None

    def _build_eval_step(self, model: torch.nn.Module):
        """``step(inputs, targets=None, mask=None) -> {"raw", "post",
        "pre_loss", "pre_metric", "post_loss", "post_metric"}``: the forward,
        the post-processing chain (``post`` is ``raw`` when it is off), then
        with targets the loss and metric pipelines on the raw and on the
        post-processed outputs, each as configured (mask-aware means, device
        scalars)."""
        forward = self._fused_eval_forward(model)
        if forward is not None:
            print(f"[ENGINE] served forward active ({type(model).__name__})")
        else:
            forward = eval_forward(model, torch.bfloat16 if self.precision == "bf16"
                                   else torch.float32)

        @torch.inference_mode()
        def step(inputs, targets=None, mask=None) -> Dict[str, object]:
            outputs = forward(inputs)
            post = apply_postprocessing(outputs, self.postproc_cfg)
            result: Dict[str, object] = {"raw": outputs, "post": post}
            for stage, out, on in (("pre", outputs, self.eval_on_raw),
                                   ("post", post, self.eval_on_post)):
                if targets is not None and on:
                    result[f"{stage}_loss"] = self.loss_pipe(out, targets=targets, inputs=inputs,
                                                             mask=mask)
                    result[f"{stage}_metric"] = self.metrics_pipe(out, targets=targets,
                                                                  inputs=inputs, mask=mask)
            return result

        return step

    def _save_batch_outputs(self, outputs: torch.Tensor, start_index: int, prefix: str) -> None:
        """Queue one batch of outputs ([0, 1], NHWC) for encoding on the
        writer pool, as ``<prefix><index>.<format>`` from index
        ``start_index + 1``; only the copy to the host happens here.  PNG
        without ``resize_hw`` goes through the native engine's libpng writer
        where it is available, the rest through PIL.  PNG is lossless, so the
        files hold the same pixels as the JAX engine's."""
        from PIL import Image

        out_dir = self.save_cfg.get("output_dir", "outputs/")
        os.makedirs(out_dir, exist_ok=True)
        resize_hw = self.save_cfg.get("resize_hw")
        fmt = self.save_cfg.get("format", "png")
        frames = (outputs.float() * 255.0).clamp(0, 255).to(torch.uint8).cpu().numpy()

        def encode(frame, path):
            if resize_hw is None and fmt.lower() == "png" and io_native.encode_png(path, frame):
                return  # libpng through the native engine (model.py:781-800)
            img = Image.fromarray(frame)
            if resize_hw is not None:
                img = img.resize((resize_hw[1], resize_hw[0]), Image.BILINEAR)
            img.save(path)

        if self._writer_pool is None:
            self._writer_pool = ThreadPoolExecutor(max_workers=4)
        for i, frame in enumerate(frames):
            path = os.path.join(out_dir, f"{prefix}{start_index + i + 1}.{fmt}")
            self._writer_futures.append(self._writer_pool.submit(encode, frame, path))

    def _drain_writers(self) -> None:
        """Wait for every queued image; the first writer failure raises."""
        futures, self._writer_futures = self._writer_futures, []
        for f in futures:
            f.result()

    def test_step(self):
        """Score the checkpoint over the test loader (``model.py:817-928``):
        paired data gets the PRE (and, with post-processing, POST) losses
        and metrics averaged over batches; outputs are saved up to
        ``save_outputs.max_images``, where the loop also stops."""
        eval_fn = self._build_eval_step(self._load_for_eval())
        paired = self.is_dataset_paired
        save = bool(self.save_cfg.get("enabled", True))
        max_save = self.save_cfg.get("max_images")
        stages = {k: [] for k in ("pre_loss", "pre_metric", "post_loss", "post_metric")}
        out_counter = n_batches = 0
        try:
            for inputs, targets, mask in self.dataloader:
                result = eval_fn(inputs, targets if paired else None, mask)
                n_valid = int(mask.sum().item())
                for key, dicts in stages.items():
                    if key in result:
                        dicts.append(result[key])
                if save and (max_save is None or out_counter < max_save):
                    for kind, prefix_key, out in (("save_raw", "raw_prefix", "raw"),
                                                  ("save_postprocessed", "post_prefix", "post")):
                        if self.save_cfg.get(kind):
                            self._save_batch_outputs(result[out][:n_valid], out_counter,
                                                     self.save_cfg[prefix_key])
                out_counter += n_valid
                n_batches += 1
                if max_save is not None and out_counter >= max_save:
                    break
            self._drain_writers()
        finally:
            if self._writer_pool is not None:
                self._writer_pool.shutdown(wait=True)
                self._writer_pool = None

        avg = {k: _mean_of_dicts(v) for k, v in stages.items()}
        for stage, tag, on in (("pre", "[PRE] ", self.eval_on_raw),
                               ("post", "[POST]", self.eval_on_post)):
            if paired and on:
                print(f"{tag} Losses -> " + ", ".join(
                    f"{k}: {v:.4f}" for k, v in avg[f"{stage}_loss"].items()))
                if avg[f"{stage}_metric"]:
                    print(f"{tag} Metrics -> " + ", ".join(
                        f"{k}: {v:.4f}" for k, v in avg[f"{stage}_metric"].items()))
        if self._log():
            if not paired:
                self.logger.log_test({"type": "test", "stage": "unpaired", "batches": n_batches})
            for stage, on in (("pre", self.eval_on_raw), ("post", self.eval_on_post)):
                if paired and on:
                    row = {"type": "test", "stage": stage, "batches": n_batches}
                    row.update({f"loss_{k}": v for k, v in avg[f"{stage}_loss"].items()})
                    row.update({f"metric_{k}": v for k, v in avg[f"{stage}_metric"].items()})
                    self.logger.log_test(row)
            self.logger.set_summary({"best_train_loss": float(self.best_loss),
                                     "test_batches": int(n_batches),
                                     "post_processing_enabled": self.post_enabled})
        return avg["pre_loss"], avg["pre_metric"]
