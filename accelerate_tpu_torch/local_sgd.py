"""Local SGD: parameters averaged across processes every few optimizer
steps instead of gradients every step (mirrors
``accelerate_tpu/local_sgd.py``).

Each process trains its own train state with no gradient reduction (an
``Accelerator`` without a parallelism config), and ``step(state)``
averages ``state.params`` over the process group every
``local_sgd_steps``-th call: an all-reduce mean, written into the
parameter tensors in place.  One process: a no-op.
"""

from __future__ import annotations

import warnings

import torch

from .ops import operations as ops
from .state import world


class LocalSGD:
    """The JAX ``LocalSGD`` context manager::

        with LocalSGD(accelerator, local_sgd_steps=8) as local_sgd:
            for batch in loader:
                state, metrics = step(state, batch)
                state = local_sgd.step(state)
            state = local_sgd.sync(state)  # the loop ended mid-cadence

    Leaving the block more steps after the last average than zero warns
    (ranks may hold different params)."""

    def __init__(self, accelerator=None, local_sgd_steps: int = 8, enabled: bool = True):
        if local_sgd_steps < 1:
            raise ValueError(f"local_sgd_steps must be >= 1, got {local_sgd_steps}")
        self.accelerator = accelerator
        self.local_sgd_steps = local_sgd_steps
        self.num_steps = 0
        self._num_processes = (accelerator.num_processes if accelerator is not None
                               else world()[0])
        self.enabled = enabled and self._num_processes > 1
        self._last_synced_step = 0

    def __enter__(self) -> "LocalSGD":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None and self.enabled and self.num_steps != self._last_synced_step:
            warnings.warn(
                f"LocalSGD exited {self.num_steps - self._last_synced_step} step(s) "
                "after the last parameter average; ranks may hold divergent "
                "params. Call `state = local_sgd.sync(state)` after the loop.",
                stacklevel=2,
            )
        return None

    def step(self, state):
        """Count one optimizer step; average the params at the cadence."""
        self.num_steps += 1
        if not self.enabled or self.num_steps % self.local_sgd_steps:
            return state
        return self.sync(state)

    def sync(self, state):
        """Average the params across processes now (a train state with
        ``params`` or a name -> tensor dict), in place; returns ``state``."""
        self._last_synced_step = self.num_steps
        if not self.enabled:
            return state
        params = state.params if hasattr(state, "params") else state
        averaged = ops.reduce(params, reduction="mean")
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(averaged[name])
        return state
