"""Classify → route → restore, top-1, as plain functions over
:class:`RefResNet18` and one :class:`RefCDAN` per expert.  The published
repository (danielluca00/Multi-Degradation-Image-Enhancement) holds the
parts, a multi-label classifier and one CDAN checkpoint per degradation,
and no script that joins them; the joining rule here is the one the port
serves (``run_pipeline`` top1, ``pipeline.RoutedRestorer``) and the JAX
package before it, written from its description:

* probabilities: the sigmoid of the class head's logits, columns in the
  bank's order;
* a row is active when some class's probability reaches that class's
  threshold; an inactive row is *clean* and passes through unchanged;
* an active row goes to its argmax expert (the first maximum), even where
  that expert's own probability is under its threshold;
* each expert takes at most ``max(1, ceil(B / E · capacity_factor))`` rows,
  ranked in batch order; the rest of its rows are *dropped* and pass
  through unchanged;
* each routed row is restored by its expert, on its own (eval BatchNorm
  treats every image alone, so which rows share a forward does not matter).

Departure from the published model: the capacity (a bucket per expert,
so a batch's work is bounded) is the serving mode's own; the published
classifier only scores, and every routed image is restored.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

CLEAN, DROPPED = -1, -2


def capacity(batch: int, experts: int, capacity_factor: float) -> int:
    return max(1, int(math.ceil(batch / experts * capacity_factor)))


def route(probs: torch.Tensor, thresholds: torch.Tensor, capacity_factor: float) -> List[int]:
    """Each row's route: its expert, :data:`CLEAN` or :data:`DROPPED`."""
    b, e = probs.shape
    cap = capacity(b, e, capacity_factor)
    active = (probs >= thresholds[None, :].to(probs)).any(dim=1).tolist()
    best = probs.argmax(dim=1).tolist()  # the first maximum
    taken = [0] * e
    out = []
    for row in range(b):
        if not active[row]:
            out.append(CLEAN)
            continue
        k = best[row]
        out.append(k if taken[k] < cap else DROPPED)
        taken[k] += 1
    return out


def restore(experts: Sequence, x: torch.Tensor, routes: Sequence[int]) -> torch.Tensor:
    """``x`` with each routed row replaced by its expert's output; clean
    and dropped rows are ``x``'s own, bit for bit."""
    out = x.clone()
    for k, expert in enumerate(experts):
        rows = [r for r, to in enumerate(routes) if to == k]
        if rows:
            out[rows] = expert(x[rows]).to(out.dtype)
    return out


@torch.no_grad()
def pipeline(classifier, experts: Sequence, thresholds: torch.Tensor, capacity_factor: float,
             x01_nhwc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, List[int]]:
    """(restored images, probabilities, routes) of one batch."""
    logits, _ = classifier(x01_nhwc)
    probs = torch.sigmoid(logits)
    routes = route(probs, thresholds, capacity_factor)
    return restore(experts, x01_nhwc, routes), probs, routes
