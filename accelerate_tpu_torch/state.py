"""Process, precision and accumulation state (mirrors the single-device
parts of ``accelerate_tpu/state.py``: ``PartialState`` :100,
``AcceleratorState`` :308, ``GradientState`` :433).

Plain objects, each owned by the :class:`~..accelerator.Accelerator` that
made it: two accelerators in one process keep their own device, mixed
precision and accumulation steps.  (The JAX package's are process-wide
singletons, because its process belongs to a mesh; one process drives one
device here, and multi-GPU worlds are ROADMAP item A13.)
"""

from __future__ import annotations

from typing import Optional

from .ops.precision import get_policy
from .utils.dataclasses import GradientAccumulationPlugin
from .utils.device import resolve_device

MIXED_PRECISION_TYPES = ("no", "fp16", "bf16", "fp8")


class PartialState:
    """The process and its device: ``device`` (``"cuda"`` unless the caller
    passes ``cpu=True`` or a device), one process, index 0."""

    num_processes = 1
    process_index = 0
    is_main_process = True
    distributed_type = "NO"

    def __init__(self, cpu: bool = False, device=None):
        self.device = resolve_device("cpu" if cpu else device)


class AcceleratorState(PartialState):
    """:class:`PartialState` plus the mixed-precision mode, ``"no"`` or
    ``"bf16"`` (``fp16`` and ``fp8`` raise ``NotImplementedError``)."""

    def __init__(self, mixed_precision: Optional[str] = None, cpu: bool = False, device=None):
        mp = (mixed_precision or "no").lower()
        if mp not in MIXED_PRECISION_TYPES:
            raise ValueError(
                f"mixed_precision must be one of {list(MIXED_PRECISION_TYPES)}, got {mp!r}"
            )
        get_policy(mp)  # fp16 / fp8 raise here
        super().__init__(cpu=cpu, device=device)
        self.mixed_precision = mp


class GradientState:
    """Gradient-accumulation bookkeeping: the plugin, ``num_steps`` and
    ``sync_gradients``."""

    def __init__(self, gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None):
        self.sync_gradients = True
        self.plugin = gradient_accumulation_plugin or GradientAccumulationPlugin()

    @property
    def num_steps(self) -> int:
        return self.plugin.num_steps

    def _set_sync_gradients(self, sync_gradients: bool):
        self.sync_gradients = sync_gradients
