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

import builtins
from contextlib import contextmanager
from functools import partial
from typing import Callable, Optional

from .logging import get_logger
from .ops.precision import fp8_hardware_supported, get_policy
from .utils.dataclasses import DistributedType, GradientAccumulationPlugin, parse_flag_from_env
from .utils.device import resolve_device

logger = get_logger(__name__)

# set once an AcceleratorState has been built in this process (is_initialized)
_accelerator_state_built = False

MIXED_PRECISION_TYPES = ("no", "fp16", "bf16", "fp8")


class PartialState:
    """The process and its device: ``device`` (``"cuda"`` unless the caller
    passes ``cpu=True`` or a device), one process, index 0, and the JAX
    package's process helpers (JAX :174-293) with their one-process
    meaning: every ``on_*`` decorator of process 0 runs its function, the
    barriers return at once, ``print`` prints."""

    num_processes = 1
    process_index = 0
    local_process_index = 0
    is_main_process = True
    is_local_main_process = True
    is_last_process = True
    use_distributed = False
    distributed_type = DistributedType.NO

    def __init__(self, cpu: bool = False, device=None):
        self.device = resolve_device("cpu" if cpu else device)

    def wait_for_everyone(self):
        """One process: nothing to wait for."""

    @contextmanager
    def main_process_first(self):
        """The main process runs the block first (one process: it runs)."""
        yield from self._goes_first(self.is_main_process)

    @contextmanager
    def local_main_process_first(self):
        yield from self._goes_first(self.is_local_main_process)

    def _goes_first(self, is_main: bool):
        if not is_main:
            self.wait_for_everyone()
        yield
        if is_main:
            self.wait_for_everyone()

    def on_main_process(self, function: Optional[Callable] = None):
        if function is None:
            return partial(self.on_main_process)

        def _inner(*args, **kwargs):
            if self.is_main_process:
                return function(*args, **kwargs)

        return _inner

    def on_local_main_process(self, function: Optional[Callable] = None):
        if function is None:
            return partial(self.on_local_main_process)

        def _inner(*args, **kwargs):
            if self.is_local_main_process:
                return function(*args, **kwargs)

        return _inner

    def on_last_process(self, function: Callable):
        def _inner(*args, **kwargs):
            if self.is_last_process:
                return function(*args, **kwargs)

        return _inner

    def on_process(self, function: Optional[Callable] = None, process_index: Optional[int] = None):
        if function is None:
            return partial(self.on_process, process_index=process_index)

        def _inner(*args, **kwargs):
            if self.process_index == process_index:
                return function(*args, **kwargs)

        return _inner

    def print(self, *args, **kwargs):
        """Print on the main process."""
        if self.is_main_process:
            builtins.print(*args, **kwargs)


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
        global _accelerator_state_built
        _accelerator_state_built = True


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


def is_initialized() -> bool:
    """True once an :class:`AcceleratorState` has been built in this
    process (an ``Accelerator`` exists or existed; JAX :519)."""
    return _accelerator_state_built
