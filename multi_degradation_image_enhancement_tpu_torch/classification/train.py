"""Classifier checkpoints (the save/load half of
``multi_degradation_image_enhancement_tpu/classification/train.py``,
``:209-225``).

The port's format: the model's ``state_dict`` as a ``.pt`` file (the engine's
weight files, ``engine.checkpoint``), beside it the same ``<path>.json``
metadata (``classes`` and whatever the trainer records).  The JAX package's
msgpack checkpoints are not read here (that needs Flax's serializer); its
weights cross over through ``utils.jax_port.classifier_state_dict``.
Classifier training itself is not ported yet.
"""

from __future__ import annotations

import json
from typing import Dict

import torch

from multi_degradation_image_enhancement_tpu_torch.engine.checkpoint import (
    load_weights,
    save_weights,
)


def save_checkpoint(path: str, model: torch.nn.Module, meta: Dict) -> None:
    save_weights(path, model)
    with open(path + ".json", "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=2)


def load_checkpoint(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load ``path`` into ``model`` strictly; returns the model."""
    return load_weights(path, model)
