"""Weight files and full-state checkpoints (counterpart of
``multi_degradation_image_enhancement_tpu/engine/checkpoint.py``).

:func:`save_weights` writes the model's ``state_dict`` under the reference's
module names (e.g. ``weights/CDAN_noise_synthetic.pt``), as the reference's
best-checkpoint flow does; :func:`load_weights` loads one strictly.

:func:`save_train_state` writes what ``train.resume`` needs into a directory
``state_NNN/``: one ``torch.save`` of the step count, the model's
``state_dict`` and the optimizer's (Adam's ``step``, ``exp_avg``,
``exp_avg_sq``: optax's ``count``, ``mu``, ``nu``);
:func:`restore_train_state` loads it into a built state.  This is the port's
own format: the JAX package's Orbax states do not cross over (its weights do,
through ``utils.jax_port``).
"""

from __future__ import annotations

import os
from typing import TYPE_CHECKING

import torch

if TYPE_CHECKING:
    from multi_degradation_image_enhancement_tpu_torch.engine.state import TrainState

STATE_FILE = "state.pt"


def _save_atomic(payload, path: str) -> None:
    """``torch.save`` to a temporary name, then a rename: a reader never
    sees half a file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_weights(path: str, model: torch.nn.Module) -> None:
    _save_atomic({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)


def load_weights(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load ``path`` into ``model`` with ``strict=True``; returns the model."""
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True), strict=True)
    return model


def save_train_state(ckpt_dir: str, state: "TrainState") -> None:
    """The full training state (step, model, optimizer) into ``ckpt_dir``."""
    _save_atomic({"step": int(state.step),
                  "model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
                  "optimizer": state.optimizer.state_dict()},
                 os.path.join(ckpt_dir, STATE_FILE))


def restore_train_state(ckpt_dir: str, state: "TrainState") -> "TrainState":
    """Load a :func:`save_train_state` directory into ``state`` (strictly;
    the optimizer's tensors move to the parameters' device); returns it."""
    payload = torch.load(os.path.join(ckpt_dir, STATE_FILE), map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state
