"""Seeding (counterpart of ``multi_degradation_image_enhancement_tpu/utils/rng.py``).

The JAX package seeds Python and NumPy and returns a root PRNG key; here the
root of the run's randomness is a ``torch.Generator``.  The global torch RNG
is seeded as well, for the host-side consumers that draw from it.  No cuDNN
flag is changed: the JAX function pins nothing either.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed_and_cudnn(seed_value: int = 42) -> torch.Generator:
    """Seed ``random``, NumPy and torch; return a CPU generator seeded with
    ``seed_value``."""
    random.seed(seed_value)
    np.random.seed(seed_value)
    torch.manual_seed(seed_value)
    return torch.Generator().manual_seed(seed_value)


set_seed = set_seed_and_cudnn
