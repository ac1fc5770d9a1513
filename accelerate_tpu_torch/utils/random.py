"""Seeding (mirrors ``accelerate_tpu/utils/random.py``: ``set_seed`` :27,
``get_rng_key`` :47, ``synchronize_rng_states`` :107).

The JAX package keeps a root PRNG key; the port keeps the root seed and
hands out seeded ``torch.Generator``s on the device.  The streams differ
from JAX's, so tests feed both frameworks noise made with numpy.
"""

from __future__ import annotations

import random
from typing import Iterable, Optional

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


RNG_TYPES = ("python", "numpy", "torch", "cuda", "generator", "seed")


def synchronize_rng_state(rng_type: str, generator: Optional[torch.Generator] = None) -> None:
    """Give every process process 0's state of one stream (JAX
    ``synchronize_rng_state`` :62): ``"python"`` / ``"numpy"`` /
    ``"torch"`` (the CPU generator), ``"cuda"`` (the current card's default
    generator; nothing without a card), ``"generator"`` (``generator``'s)
    or ``"seed"`` (the root seed, the JAX package's ``"jax"`` stream).  One
    process: nothing to do."""
    from ..ops.operations import broadcast_object_list

    rng_type = str(rng_type)
    if rng_type not in RNG_TYPES + ("jax",):
        raise ValueError(f"unknown rng type {rng_type!r}; one of {RNG_TYPES}")
    if rng_type in ("seed", "jax"):
        global _root_seed
        payload = [get_root_seed()]
        broadcast_object_list(payload, from_process=0)
        _root_seed = payload[0]
    elif rng_type == "numpy":
        payload = [np.random.get_state()]
        broadcast_object_list(payload, from_process=0)
        np.random.set_state(payload[0])
    elif rng_type == "python":
        payload = [random.getstate()]
        broadcast_object_list(payload, from_process=0)
        random.setstate(payload[0])
    elif rng_type == "torch":
        payload = [torch.get_rng_state()]
        broadcast_object_list(payload, from_process=0)
        torch.set_rng_state(payload[0])
    elif rng_type == "cuda":
        if torch.cuda.is_available():
            payload = [torch.cuda.get_rng_state().cpu()]
            broadcast_object_list(payload, from_process=0)
            torch.cuda.set_rng_state(payload[0])
    elif generator is not None:
        payload = [generator.get_state().cpu()]
        broadcast_object_list(payload, from_process=0)
        generator.set_state(payload[0])


def synchronize_rng_states(rng_types: Iterable = ("python", "numpy", "torch", "cuda"),
                           generator: Optional[torch.Generator] = None) -> None:
    """Process 0's state of each stream on every process (JAX :107), so the
    processes' next draws are equal."""
    for rng_type in rng_types:
        synchronize_rng_state(rng_type, generator)
