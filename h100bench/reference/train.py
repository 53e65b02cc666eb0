"""The reference's training steps: the train-mode CDAN, the recipe's loss,
the gradient by autograd, Adam (β1 0.9, β2 0.999, ε 1e-8, bias-corrected,
no weight decay), BatchNorm's running statistics.  Float32 throughout; the
caller turns TF32 off (``reference.exact_f32``)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from h100bench.reference.cdan import RefCDAN, split_state
from h100bench.reference.losses import recipe_loss

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def train_steps(state: Dict[str, torch.Tensor], batches: Sequence, terms: List[dict],
                perceptual: Dict[str, torch.Tensor], lr: float, quant: Optional[str] = None,
                half_batch: bool = False) -> dict:
    """Adam steps from ``state`` (published names, left untouched) over
    ``batches`` = [(inputs, targets, four keep masks)].

    Returns ``losses`` (one float a step), ``grads`` (the first step's
    gradient by name), ``params`` and ``buffers`` after the last step and
    ``buffers1`` after the first.
    ``half_batch``: a planted fault, each step on the first half of its
    batch only."""
    params0, buffers0 = split_state(state)
    params = {k: v.detach().clone().float().requires_grad_(True) for k, v in params0.items()}
    buffers = {k: v.detach().clone().float() for k, v in buffers0.items()}
    net = RefCDAN(params, buffers, quant)
    net.training = True
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first_grads, buffers1 = [], None, None
    for t, (x, y, masks) in enumerate(batches, start=1):
        if half_batch:
            n = x.shape[0] // 2
            x, y, masks = x[:n], y[:n], [k[:n] for k in masks]
        total, _ = recipe_loss(terms, net(x, masks).float(), y, perceptual)
        grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
        losses.append(float(total.detach()))
        if buffers1 is None:
            buffers1 = {k: v.clone() for k, v in buffers.items()}
        with torch.no_grad():
            named = {k: (torch.zeros_like(p) if g is None else g)
                     for (k, p), g in zip(params.items(), grads)}
            if first_grads is None:
                first_grads = {k: g.clone() for k, g in named.items()}
            for k, p in params.items():
                g = named[k]
                m[k].mul_(BETA1).add_(g, alpha=1.0 - BETA1)
                v2[k].mul_(BETA2).addcmul_(g, g, value=1.0 - BETA2)
                m_hat = m[k] / (1.0 - BETA1 ** t)
                v_hat = v2[k] / (1.0 - BETA2 ** t)
                p.sub_(lr * m_hat / (v_hat.sqrt() + EPS))
    return {"losses": losses, "grads": first_grads,
            "params": {k: p.detach() for k, p in params.items()}, "buffers": buffers,
            "buffers1": buffers1}
