"""JSON config loading with the reference's dialect (the same as
``multi_degradation_image_enhancement_tpu/utils/config.py``): ``//`` line
comments are stripped, missing keys read as ``None``, and the CLI phase sets
``phase``.  The JAX package's config files are read as files, unchanged."""

from __future__ import annotations

import json
from collections import OrderedDict
from typing import Any


class NoneDict(dict):
    """A dict whose missing keys read as ``None``."""

    def __missing__(self, key):
        return None


def dict_to_nonedict(config: Any) -> Any:
    if isinstance(config, dict):
        return NoneDict(**{k: dict_to_nonedict(v) for k, v in config.items()})
    if isinstance(config, list):
        return [dict_to_nonedict(v) for v in config]
    return config


def _strip_line_comments(text: str) -> str:
    """Keep the part of every line before ``//`` (the reference's rule, which
    also cuts ``//`` inside strings; no shipped config relies on that)."""
    return "\n".join(line.split("//")[0] for line in text.splitlines())


def load_config(path: str, phase: str | None = None) -> NoneDict:
    with open(path, "r", encoding="utf-8") as f:
        config = json.loads(_strip_line_comments(f.read()), object_pairs_hook=OrderedDict)
    if phase is not None:
        config["phase"] = phase
    return dict_to_nonedict(config)
