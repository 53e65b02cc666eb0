"""Train state: the model, its optimizer and the step count (counterpart of
``multi_degradation_image_enhancement_tpu/engine/state.py``).

JAX threads an immutable ``TrainState`` through a pure step; here the model
and the optimizer are updated in place and the state only groups them.
``torch.optim.Adam``'s defaults (β1 0.9, β2 0.999, eps 1e-8, no weight decay)
are ``optax.adam``'s.  bf16 needs no loss scaling, so there is no GradScaler.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @classmethod
    def create(cls, model: torch.nn.Module, lr: float) -> "TrainState":
        return cls(model=model, optimizer=torch.optim.Adam(model.parameters(), lr=lr))
