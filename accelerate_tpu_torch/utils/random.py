"""Seeding (mirrors ``accelerate_tpu/utils/random.py``: ``set_seed`` :27,
``get_rng_key`` :47).

The JAX package keeps a root PRNG key; the port keeps the root seed and
hands out seeded ``torch.Generator``s on the device.  The streams differ
from JAX's, so tests feed both frameworks noise made with numpy.
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np
import torch

from .device import resolve_device

_root_seed: Optional[int] = None


def set_seed(seed: int) -> int:
    """Seed python, numpy and torch and set the root seed."""
    global _root_seed
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    _root_seed = seed
    return seed


def get_root_seed() -> int:
    if _root_seed is None:
        set_seed(0)
    return _root_seed


def get_rng_key(fold: Optional[int] = None, device=None) -> torch.Generator:
    """A generator on ``device`` (``"cuda"`` by default) seeded from the
    root seed, or from (root seed, ``fold``) for a derived stream."""
    seed = get_root_seed()
    if fold is not None:
        seed = (seed * 1_000_003 + fold + 1) % (2**63)
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)
