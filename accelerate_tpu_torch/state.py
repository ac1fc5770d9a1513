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

from .logging import get_logger
from .ops.precision import fp8_hardware_supported, get_policy
from .utils.dataclasses import GradientAccumulationPlugin, parse_flag_from_env
from .utils.device import resolve_device

logger = get_logger(__name__)

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
    """:class:`PartialState` plus the mixed-precision mode: ``"no"``,
    ``"bf16"``, ``"fp16"`` or ``"fp8"``.  fp8 on a device without fp8
    tensor cores (before sm_89, or the CPU) warns and proceeds, or with
    ``ACCELERATE_FP8_FALLBACK_BF16`` set falls back to bf16 (JAX
    :356-372)."""

    def __init__(self, mixed_precision: Optional[str] = None, cpu: bool = False, device=None):
        mp = (mixed_precision or "no").lower()
        if mp not in MIXED_PRECISION_TYPES:
            raise ValueError(
                f"mixed_precision must be one of {list(MIXED_PRECISION_TYPES)}, got {mp!r}"
            )
        super().__init__(cpu=cpu, device=device)
        if mp == "fp8" and not (self.device.type == "cuda" and fp8_hardware_supported()):
            if parse_flag_from_env("ACCELERATE_FP8_FALLBACK_BF16"):
                logger.warning(
                    "mixed_precision='fp8' requested but this device has no fp8 matmul "
                    "units; falling back to bf16 (ACCELERATE_FP8_FALLBACK_BF16 is set).")
                mp = "bf16"
            else:
                logger.warning(
                    "mixed_precision='fp8' requested but this device has no fp8 matmul "
                    "units: the quantize / descale work is pure overhead. Training proceeds "
                    "in fp8 as requested; set ACCELERATE_FP8_FALLBACK_BF16=true to fall back "
                    "to bf16 on such hardware.")
        get_policy(mp)
        self.mixed_precision = mp


class GradientState:
    """Gradient-accumulation bookkeeping: the plugin, ``num_steps``,
    ``sync_gradients``, and the data loaders' signals: the prepared loader
    being iterated (``active_dataloader``) flips ``end_of_dataloader`` on
    its last batch and carries ``remainder`` (the samples of the dataset's
    last, padded batch), which ``gather_for_metrics`` reads.  Each
    :class:`~..accelerator.Accelerator` owns one and hands it to the
    loaders and schedulers it prepares."""

    def __init__(self, gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None):
        self.sync_gradients = True
        self.plugin = gradient_accumulation_plugin or GradientAccumulationPlugin()
        self.active_dataloader = None
        self.dataloader_references: list = [None]

    @property
    def num_steps(self) -> int:
        return self.plugin.num_steps

    @property
    def adjust_scheduler(self) -> bool:
        return self.plugin.adjust_scheduler

    @property
    def sync_with_dataloader(self) -> bool:
        return self.plugin.sync_with_dataloader

    @property
    def in_dataloader(self) -> bool:
        return self.active_dataloader is not None

    @property
    def end_of_dataloader(self) -> bool:
        if not self.in_dataloader:
            return False
        return self.active_dataloader.end_of_dataloader

    @property
    def remainder(self) -> int:
        if not self.in_dataloader:
            return -1
        return self.active_dataloader.remainder

    def _set_sync_gradients(self, sync_gradients: bool):
        self.sync_gradients = sync_gradients

    def _add_dataloader(self, dataloader):
        self.active_dataloader = dataloader
        self.dataloader_references.append(dataloader)

    def _remove_dataloader(self, dataloader):
        if dataloader in self.dataloader_references:
            self.dataloader_references.remove(dataloader)
        self.active_dataloader = self.dataloader_references[-1]
