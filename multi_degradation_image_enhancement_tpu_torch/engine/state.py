"""Train state: the model, its optimizer, the step count, and the optional
learning-rate schedule and gradient clipping (counterpart of
``multi_degradation_image_enhancement_tpu/engine/state.py`` and of the
optimizer the JAX engine builds, ``engine/model.py:213-251``).

JAX threads an immutable ``TrainState`` through a pure step; here the model
and the optimizer are updated in place and the state groups them.
``torch.optim.Adam``'s defaults (β1 0.9, β2 0.999, eps 1e-8, no weight decay)
are ``optax.adam``'s, and its ``exp_avg`` / ``exp_avg_sq`` / ``step`` are
optax's ``mu`` / ``nu`` / ``count``.  bf16 needs no loss scaling, so there is
no GradScaler.

:meth:`TrainState.apply_gradients` is ``optax.chain(clip_by_global_norm,
adam(schedule))``: the gradients are clipped as optax clips them, the
learning rate is the schedule at ``step`` (the count of updates made so far,
0 for the first: optax's ``scale_by_schedule`` count), then Adam steps.
``step`` is the only counter, so restoring it restores the schedule's
position.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from multi_degradation_image_enhancement_tpu_torch.parallel import collectives

Schedule = Callable[[int], float]


def cosine_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """``optax.cosine_decay_schedule``: init·((1 − α)·½(1 + cos(π·min(t, T)/T)) + α)."""
    if not decay_steps > 0:
        raise ValueError(f"the cosine schedule requires positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        t = min(count, decay_steps)
        return init_value * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
                             + alpha)

    return schedule


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """``optax.linear_schedule``: from ``init_value`` to ``end_value`` over
    ``transition_steps`` updates, then constant (constant at ``init_value``
    when ``transition_steps`` <= 0)."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def build_schedule(cfg: Any, lr: float, total_steps: int) -> Schedule:
    """The schedule of ``train.lr_schedule`` (``engine/model.py:213-243`` of
    the JAX package): ``"cosine"`` or ``"linear"``, or ``{"name": …, "args":
    {…}}`` with ``alpha`` (cosine, default 0.01), ``end_value`` (linear,
    default lr·0.01) and ``decay_steps`` (default ``total_steps``, the run's
    length in updates).  An unknown name raises."""
    name = cfg if isinstance(cfg, str) else cfg.get("name")
    args = {} if isinstance(cfg, str) else dict(cfg.get("args") or {})
    decay_steps = int(args.get("decay_steps", total_steps))
    if name == "cosine":
        return cosine_schedule(lr, decay_steps, float(args.get("alpha", 0.01)))
    if name == "linear":
        return linear_schedule(lr, float(args.get("end_value", lr * 0.01)), decay_steps)
    raise ValueError(f"unknown train.lr_schedule: {name!r}")


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: with norm = ‖all grads‖₂, each
    gradient becomes ``g / norm * max_norm`` when norm >= max_norm and is left
    untouched (bit for bit) otherwise.  No host synchronisation: below the
    threshold the divisor and the factor are exactly 1.  Returns the norm.

    The norm is ``sqrt(Σ sum(g²))``, as optax forms it: PyTorch's CPU
    ``vector_norm`` of a large tensor drifts by ~1e-5 relative."""
    norm = torch.stack([sq.sum() for sq in torch._foreach_mul(grads, grads)]).sum().sqrt()
    below = norm < max_norm
    one = torch.ones((), dtype=norm.dtype, device=norm.device)
    torch._foreach_div_(grads, torch.where(below, one, norm))
    torch._foreach_mul_(grads, torch.where(below, one, one * max_norm))
    return norm


@torch.no_grad()
def all_reduce_grads_(grads: List[torch.Tensor], group) -> None:
    """Sum each gradient over ``group``'s ranks in place, as one bucket: one
    all-reduce of the flattened gradients, then the sums copied back."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    sums = flat.split([g.numel() for g in grads])
    torch._foreach_copy_(grads, [t.view_as(g) for t, g in zip(sums, grads)])


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    schedule: Optional[Schedule] = None
    grad_clip: Optional[float] = None

    @classmethod
    def create(cls, model: torch.nn.Module, lr: float, schedule: Optional[Schedule] = None,
               grad_clip: Optional[float] = None) -> "TrainState":
        return cls(model=model, optimizer=torch.optim.Adam(model.parameters(), lr=lr),
                   schedule=schedule, grad_clip=float(grad_clip) if grad_clip else None)

    def apply_gradients(self) -> None:
        """One update from the gradients in ``.grad``: under a mesh their sum
        over its ranks, then clip, set the scheduled learning rate, Adam;
        ``step`` counts it.

        Under a mesh each rank's loss is its share of the global loss, so the
        global gradient is the sum of the ranks' (``parallel.collectives``):
        one bucketed all-reduce after ``backward()``, before clipping sees
        the global norm.  Not ``DistributedDataParallel``: its reducer
        averages, overlaps buckets with a backward that here already
        exchanges halos and statistics in autograd's order, and would have to
        be told to leave the buffers alone (sync-BN keeps them equal)."""
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        group = collectives.grad_group()
        if group is not None and grads:
            all_reduce_grads_(grads, group)
        if self.grad_clip:
            clip_by_global_norm_(grads, self.grad_clip)
        if self.schedule is not None:
            lr = self.schedule(self.step)
            for group in self.optimizer.param_groups:
                group["lr"] = lr
        self.optimizer.step()
        self.step += 1
