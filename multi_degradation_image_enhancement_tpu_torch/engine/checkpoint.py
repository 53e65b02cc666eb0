"""Weight files (counterpart of
``multi_degradation_image_enhancement_tpu/engine/checkpoint.py``).

:func:`save_weights` writes the model's ``state_dict`` under the reference's
module names (e.g. ``weights/CDAN_noise_synthetic.pt``), as the reference's
best-checkpoint flow does; :func:`load_weights` loads one strictly.  The JAX
package's full-state resume is not ported (ROADMAP.md).
"""

from __future__ import annotations

import os

import torch


def save_weights(path: str, model: torch.nn.Module) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    tmp = f"{path}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_weights(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load ``path`` into ``model`` with ``strict=True``; returns the model."""
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True), strict=True)
    return model
