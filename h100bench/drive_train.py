"""The training cells: the program's train step
(``engine.model.make_train_step`` over the recipe's loss pipeline, on
``engine.state.TrainState.create(model, lr)``, CDAN with ``fused_dense``)
stepped back to back, fed from a resident pool of degraded/clean pairs in an
order drawn from the seed, with dropout keep masks the harness draws.

Set-up builds the one train state, then drives it through the window's own
step function for the ``reference_steps`` first steps (the warm-up, on rows
that all differ), recording each step's loss, the first gradient as Adam's
first moment holds it, and the parameters and running statistics after
them.  The window then steps the same state on until ``--seconds`` have
passed and closes on a readback of the last step's loss.  After it: the
memory peak, the traced window (``--trace 1``), the program freed, then the
reference's steps from the same weights, batches and masks.
"""

from __future__ import annotations

import gc
import json
import os
import time
from typing import Dict

import torch

from h100bench import checks, traffic, weights
from h100bench.drive_serve import calibrated_state
from h100bench.outcome import Outcome, event_sync, setup_marks
from h100bench.reference import exact_f32
from h100bench.reference.train import train_steps
from h100bench.timing import cuda_ms

PERCEPTUAL = ("vgg_perceptual", "lpips")
ORDER_BLOCK = 1024  # steps of batch order put on the device at a time


def weights_dir() -> str:
    """Where the frozen loss networks' npz files go: a fixed directory under
    the run's ``TMPDIR``."""
    import tempfile

    return os.path.join(tempfile.gettempdir(), "h100bench", "perceptual")


class Feed:
    """Step i's (inputs, targets, four keep masks), all on the device: pool
    rows by the seed's order, uint8 → [0, 1], masks from their own
    generator."""

    def __init__(self, seed, mix, degraded, clean, device):
        self.order = traffic.BatchOrder(seed, mix["pool"], mix["batch"])
        self.mix, self.degraded, self.clean, self.device = mix, degraded, clean, device
        self.masks = torch.Generator(device).manual_seed(seed + 3)
        self.rows = torch.empty(0, mix["batch"], dtype=torch.long, device=device)

    def __call__(self, i: int):
        while i >= self.rows.shape[0]:  # one host→device copy per block of steps
            n = self.rows.shape[0]
            block = [self.order.take(j) for j in range(n, n + ORDER_BLOCK)]
            self.rows = torch.cat([self.rows, torch.tensor(block, device=self.device)])
        rows = self.rows[i]
        m = self.mix
        masks = traffic.dropout_masks(self.masks, m["batch"], m["height"], m["width"], self.device)
        return traffic.to01(self.degraded[rows]), traffic.to01(self.clean[rows]), masks


def _statistics(model) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _snapshot(model, losses, grads, buffers1) -> Dict:
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    return {"losses": [float(x) for x in losses], "grads": grads, "params": params,
            "buffers": _statistics(model), "buffers1": buffers1}


def first_moment_grads(model, optimizer, beta1: float) -> Dict[str, torch.Tensor]:
    """The gradient of the first step as Adam holds it: exp_avg / (1 − β1);
    zero where the optimizer holds no state for a leaf."""
    out = {}
    for k, p in model.named_parameters():
        st = optimizer.state.get(p, {})
        out[k] = (st["exp_avg"] / (1.0 - beta1)).detach().clone() if "exp_avg" in st \
            else torch.zeros_like(p)
    return out


def perceptual_ms(loss_pipe, out_like: torch.Tensor, target: torch.Tensor, reps: int = 3) -> float:
    """CUDA-event ms of the loss networks' terms of ``loss_pipe`` (forward on
    the output and the target, backward to the output) on one step's batch,
    timed from the benchmark's side."""
    terms = [t for t in loss_pipe.terms if t.name in PERCEPTUAL]

    def once():
        out = out_like.detach().clone().requires_grad_(True)
        sum(t.weight * t.fn(outputs=out, targets=target).mean() for t in terms).backward()

    return cuda_ms(once, reps, warmup=1) if terms else 0.0


def prepare(cell, seed: int, device):
    """(degraded pool, clean pool, CDAN weights, loss-network weights) from
    the seed, as every run and the control make them."""
    gen = torch.Generator(device).manual_seed(seed)
    degraded, clean = traffic.train_pool(gen, cell.mix, cell.config["degradation"], device)
    state0 = calibrated_state(gen, traffic.to01(degraded[:int(cell.mix["calibration_rows"])]),
                              device)
    perceptual = {}
    if any(t["name"] in PERCEPTUAL for t in cell.recipe["loss"]["terms"]):
        perceptual = weights.perceptual_state(gen, device)
    return degraded, clean, state0, perceptual


def growth_launches():
    """The program's counters of growth-layer calls (#4/#5, #6/#7): a sanity
    line on standard error, not a metric."""
    from multi_degradation_image_enhancement_tpu_torch.ops.cuda.growth_train import (
        growth_layer_bwd,
        growth_layer_fwd,
    )

    return growth_layer_fwd.launches, growth_layer_bwd.launches


class Trainer:
    """The one train state of a run, built from the seed and driven through
    the set-up steps by the window's own step function: ``prog`` holds what
    the reference is compared with, ``batches`` what it is fed."""

    def __init__(self, cell, seed: int, device, mark=lambda what: None):
        from multi_degradation_image_enhancement_tpu_torch.engine.model import make_train_step
        from multi_degradation_image_enhancement_tpu_torch.engine.state import TrainState
        from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN
        from multi_degradation_image_enhancement_tpu_torch.ops.losses import build_loss_pipeline

        tcfg = cell.config["train"]
        degraded, clean, self.state0, self.perceptual = prepare(cell, seed, device)
        mark("pairs, calibrated weights and loss networks on the device")
        if self.perceptual:
            weights.write_perceptual_npz(self.perceptual, weights_dir())
            os.environ["MDIE_WEIGHTS_DIR"] = weights_dir()
            mark("the loss networks' npz files written")
        with torch.device(device):
            self.model = CDAN()
        self.model.load_state_dict(self.state0)
        self.model.fused_dense = bool(tcfg["fused_dense"])
        self.tstate = TrainState.create(self.model, float(tcfg["lr"]))
        mark("the program's CDAN and train state")
        self.loss_pipe = build_loss_pipeline(cell.recipe["loss"], device)
        self.step_fn = make_train_step(self.loss_pipe, tcfg["precision"])
        mark("the program's loss pipeline and step")
        self.feed = Feed(seed, cell.mix, degraded, clean, device)
        self.cell, self.lr = cell, float(tcfg["lr"])

        beta1 = self.tstate.optimizer.param_groups[0]["betas"][0]
        self.batches, losses, grads, buffers1 = [], [], None, None
        for i in range(int(cell.mix["reference_steps"])):
            loss, batch = self.step(i)
            self.batches.append(batch)
            losses.append(loss["total"])
            if i == 0:
                grads = first_moment_grads(self.model, self.tstate.optimizer, beta1)
                buffers1 = _statistics(self.model)
        self.prog = _snapshot(self.model, losses, grads, buffers1)
        mark(f"{len(self.batches)} steps of the window's step function")

    def step(self, i: int):
        x, y, masks = self.feed(i)
        return self.step_fn(self.tstate, x, y, masks), (x, y, masks)

    def free_program(self, device) -> None:
        del self.tstate, self.model, self.loss_pipe, self.step_fn
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    def numbers(self) -> Dict:
        """The reference's steps from the same weights, batches and masks,
        against the program's."""
        with exact_f32():
            ref = train_steps(self.state0, self.batches, self.cell.recipe["loss"]["terms"],
                              self.perceptual, self.lr)
        values = checks.train_numbers(self.prog, ref, self.state0)
        values["losses"] = " ".join(f"{p:.7f}/{r:.7f}" for p, r in
                                    zip(self.prog["losses"], ref["losses"]))
        return values


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float, log) -> Outcome:
    mix = cell.mix
    b, h, w = mix["batch"], mix["height"], mix["width"]
    ses = Trainer(cell, seed, device, setup_marks(log, t_start))
    event_sync(device)

    t0 = time.perf_counter()
    setup_s = t0 - t_start
    n0, n = int(mix["reference_steps"]), 0
    launches0 = growth_launches()
    while time.perf_counter() - t0 < seconds:
        loss, _ = ses.step(n0 + n)
        n += 1
    last_loss = float(loss["total"])  # the readback closes the window
    window = time.perf_counter() - t0

    o = Outcome(attempted=n, failed=0 if last_loss == last_loss else 1)
    o.memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    o.e2e = {"train_img_per_s": n * b / window, "setup_s": setup_s}
    log(f"window {window:.3f} s, {n} steps of {b} ({n * b} images), {window / n * 1e3:.4f} ms a "
        f"step on average; last loss {last_loss:.6f}; growth-layer calls a step (fwd, bwd) "
        f"{[(a - z) / n for a, z in zip(growth_launches(), launches0)]}")
    o.ctx.update(kind="train", batch=b, height=h, width=w, steps_per_s=n / window,
                 terms=cell.recipe["loss"]["terms"])
    if trace:
        from h100bench import traces

        k = int(mix["trace_steps"])
        for i, (key, host) in enumerate((("trace", False), ("host_trace", True))):
            j0 = n0 + n + i * k
            o.ctx[key] = traces.profile(lambda j, j0=j0: ses.step(j0 + j), k,
                                        lambda: event_sync(device), host)
        if device.type == "cuda" and ses.perceptual:
            x, y, _ = ses.feed(0)
            o.ctx["perceptual_ms"] = perceptual_ms(ses.loss_pipe, x, y)
    del loss
    ses.free_program(device)
    values = ses.numbers()
    log("readings " + json.dumps(values))
    o.readings, o.checks = values, checks.judge(values, cell.limits)
    return o


def control_readings(cell, seed: int, device, witness: bool = False) -> Dict:
    """The reference's three set-up steps put in the program's place:
    ``control`` in FP8 (e4m3 operands, e5m2 gradients, per-tensor scales),
    ``half_batch`` (each step on half its batch, the mean taken over the
    rest) and ``unchanged`` (a step that returns its state unchanged: the
    parameters and statistics left at their start); with ``witness`` also
    ``bf16_witness``, the reference in bf16, the program's precision."""
    degraded, clean, state0, perceptual = prepare(cell, seed, device)
    feed = Feed(seed, cell.mix, degraded, clean, device)
    batches = [feed(i) for i in range(int(cell.mix["reference_steps"]))]
    terms, lr = cell.recipe["loss"]["terms"], float(cell.config["train"]["lr"])
    with exact_f32():
        ref = train_steps(state0, batches, terms, perceptual, lr)
        out = {"control": checks.train_numbers(
                   train_steps(state0, batches, terms, perceptual, lr, quant="fp8"), ref, state0),
               "half_batch": checks.train_numbers(
                   train_steps(state0, batches, terms, perceptual, lr, half_batch=True), ref,
                   state0)}
        if witness:
            out["bf16_witness"] = checks.train_numbers(
                train_steps(state0, batches, terms, perceptual, lr, quant="bf16"), ref, state0)
    params = {k: state0[k] for k in ref["params"]}
    still = {"losses": ref["losses"], "grads": {k: torch.zeros_like(v) for k, v in params.items()},
             "params": params, "buffers": {k: state0[k] for k in ref["buffers"]},
             "buffers1": {k: state0[k] for k in ref["buffers"]}}
    out["unchanged"] = checks.train_numbers(still, ref, state0)
    return out


def program_readings(cell, seed: int, device, seconds: float) -> Dict:
    """The program's own numbers: the set-up steps of the window's step
    function on the run's state, against the reference; no window, so
    ``seconds`` is not used."""
    ses = Trainer(cell, seed, device)
    ses.free_program(device)
    return {"program": ses.numbers()}
