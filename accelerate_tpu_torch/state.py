"""Process, precision and accumulation state (mirrors
``accelerate_tpu/state.py``: ``PartialState`` :100, ``AcceleratorState``
:308, ``GradientState`` :433).

One process drives one card.  A world of several processes is a
``torch.distributed`` process group, initialised the way the JAX package
initialises ``jax.distributed`` (JAX :47-97): from an
``InitProcessGroupKwargs`` (``coordinator_address``, ``num_processes``,
``process_id``, ``timeout``), else from the JAX package's environment
contract (``ACCELERATE_COORDINATOR_ADDRESS`` / ``ACCELERATE_NUM_PROCESSES``
/ ``ACCELERATE_PROCESS_ID``), else from torchrun's (``RANK`` /
``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT``).  A
group the caller already initialised is adopted as it is.  The backend is
NCCL on the card and gloo for ``cpu=True``; a failed initialisation
raises.  A world of several processes is ``DistributedType.MULTI_HOST``
(the JAX package's name for a multi-process world); one process stays
``NO``.

Plain objects, each owned by the :class:`~..accelerator.Accelerator` that
made it (the JAX package's are process-wide singletons); the process group
and the newest mesh are the process's (:func:`ambient_mesh`).
"""

from __future__ import annotations

import builtins
import math
import os
from contextlib import contextmanager
from datetime import timedelta
from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

from .logging import get_logger
from .ops.precision import fp8_hardware_supported, get_policy
from .utils.dataclasses import (
    DistributedType,
    GradientAccumulationPlugin,
    InitProcessGroupKwargs,
    parse_flag_from_env,
)
from .utils.device import resolve_device

logger = get_logger(__name__)

# set once an AcceleratorState has been built in this process (is_initialized)
_accelerator_state_built = False

MIXED_PRECISION_TYPES = ("no", "fp16", "bf16", "fp8")

# the mesh and parallelism config of the newest AcceleratorState that built
# one: what the config-name entry points (models.llama's "ring"
# attention, parallel.collectives without a mesh) run on
_AMBIENT: dict = {"mesh": None, "config": None}


def ambient_mesh():
    """``(mesh, parallelism_config)`` of the newest accelerator state that
    built a mesh in this process, ``(None, None)`` before one."""
    return _AMBIENT["mesh"], _AMBIENT["config"]


def world() -> tuple[int, int]:
    """``(num_processes, process_index)`` of the process group, ``(1, 0)``
    without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _init_method(address: str) -> str:
    """A coordinator address as an init method: ``host:port`` becomes
    ``tcp://host:port``; ``tcp://``, ``file://`` and ``env://`` pass."""
    return address if "://" in address else f"tcp://{address}"


def _world_request(kwargs: Optional[InitProcessGroupKwargs]):
    """``(init_method, world_size, rank)`` the caller asks for, or None for
    one process: the kwargs first, then the JAX package's environment
    contract, then torchrun's."""
    env = os.environ
    if kwargs is not None and (kwargs.coordinator_address or (kwargs.num_processes or 1) > 1):
        if not kwargs.coordinator_address:
            raise ValueError(
                f"InitProcessGroupKwargs(num_processes={kwargs.num_processes}) needs a "
                "coordinator_address (host:port, or a file:// init method)")
        world = kwargs.num_processes or int(env.get("ACCELERATE_NUM_PROCESSES", "1"))
        rank = (kwargs.process_id if kwargs.process_id is not None
                else int(env.get("ACCELERATE_PROCESS_ID", "0")))
        return _init_method(kwargs.coordinator_address), world, rank
    if env.get("ACCELERATE_COORDINATOR_ADDRESS"):
        world = int(env.get("ACCELERATE_NUM_PROCESSES", "1"))
        rank = int(env.get("ACCELERATE_PROCESS_ID", "-1"))
        if world > 1 and rank < 0:
            raise ValueError("ACCELERATE_COORDINATOR_ADDRESS with several processes needs "
                             "ACCELERATE_PROCESS_ID")
        return _init_method(env["ACCELERATE_COORDINATOR_ADDRESS"]), world, max(rank, 0)
    if env.get("WORLD_SIZE") and env.get("RANK") and env.get("MASTER_ADDR"):
        return "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    return None


def _timeout(kwargs: Optional[InitProcessGroupKwargs]) -> Optional[timedelta]:
    if kwargs is None:
        return None
    if kwargs.initialization_timeout:
        return timedelta(seconds=kwargs.initialization_timeout)
    return kwargs.timeout


def _init_world(kwargs, backend: str, world_of_one: bool) -> None:
    """Initialise the process group the caller asks for (see the module
    doc); with ``world_of_one`` and no request, a group of this one
    process over an in-memory store, so a parallelism config has a mesh."""
    import torch.distributed as dist

    request = _world_request(kwargs)
    if dist.is_initialized():
        if request is not None and request[1] != dist.get_world_size():
            raise ValueError(f"a world of {request[1]} processes was asked for inside a "
                             f"process group of {dist.get_world_size()}")
        return
    timeout = _timeout(kwargs)
    extra = {"timeout": timeout} if timeout is not None else {}
    if request is not None and request[1] > 1:
        method, world, rank = request
        if not 0 <= rank < world:
            raise ValueError(f"process rank {rank} outside a world of {world}")
        dist.init_process_group(backend, init_method=method, world_size=world, rank=rank,
                                **extra)
    elif world_of_one or request is not None:
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0, **extra)


class PartialState:
    """The process, its device and its world: ``device`` (``"cuda"`` unless
    the caller passes ``cpu=True`` or a device; in a world of several
    processes on the card, ``cuda:<local rank>``), ``num_processes``,
    ``process_index``, ``local_process_index``, and the JAX package's
    process helpers (JAX :174-306): the ``on_*`` decorators, the barrier
    ``wait_for_everyone``, ``main_process_first``,
    ``split_between_processes``, ``print`` on the main process and
    ``destroy_process_group``.  ``world_of_one=True`` makes a group of this
    one process when no world is asked for (an accelerator with a
    parallelism config needs a mesh).

    ``backend="gloo"`` with a card device is a world whose collectives run
    on the host while its processes compute on the card: the way several
    processes share one GPU (NCCL refuses two ranks on one device).  Such a
    world is asked for explicitly; its collectives take host tensors, and
    each process keeps the device it was given (``cuda:0`` for all)."""

    def __init__(self, cpu: bool = False, device=None,
                 init_process_group_kwargs: Optional[InitProcessGroupKwargs] = None,
                 world_of_one: bool = False, backend: Optional[str] = None):
        import torch.distributed as dist

        dev = resolve_device("cpu" if cpu else device)
        self.debug = parse_flag_from_env("ACCELERATE_DEBUG_MODE")
        if backend not in (None, "gloo", "nccl"):
            raise ValueError(f"backend {backend!r}: 'gloo' or 'nccl'")
        if backend == "nccl" and dev.type == "cpu":
            raise ValueError("backend='nccl' needs a card device")
        self.backend = backend or ("gloo" if dev.type == "cpu" else "nccl")
        _init_world(init_process_group_kwargs, self.backend, world_of_one)
        self.num_processes, self.process_index = world()
        if dist.is_initialized():
            self.backend = dist.get_backend()
        self.local_process_index = int(os.environ.get("LOCAL_RANK", self.process_index))
        if dev.type == "cuda" and dev.index is None and self.num_processes > 1:
            dev = torch.device("cuda", self.local_process_index % torch.cuda.device_count())
        if dev.type == "cuda" and self.num_processes > 1:
            torch.cuda.set_device(dev)
        self.device = dev
        self.distributed_type = (DistributedType.MULTI_HOST if self.num_processes > 1
                                 else DistributedType.NO)

    @property
    def use_distributed(self) -> bool:
        return self.distributed_type != DistributedType.NO

    @property
    def is_main_process(self) -> bool:
        return self.process_index == 0

    @property
    def is_local_main_process(self) -> bool:
        return self.local_process_index == 0

    @property
    def is_last_process(self) -> bool:
        return self.process_index == self.num_processes - 1

    def wait_for_everyone(self):
        """A barrier over the process group (one process: returns)."""
        if self.num_processes > 1:
            import torch.distributed as dist

            dist.barrier()

    @contextmanager
    def main_process_first(self):
        """The main process runs the block first, the others wait."""
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

    @contextmanager
    def split_between_processes(self, inputs, apply_padding: bool = False):
        """Split a list, tuple, dict of equal-length values, tensor or array
        evenly across processes (JAX :215): ``ceil(len / n)`` items each,
        the last processes short; ``apply_padding`` repeats the last item
        so every process gets the same count."""
        if self.num_processes == 1:
            yield inputs
            return
        length = len(inputs)
        if isinstance(inputs, dict):
            lengths = {len(v) for v in inputs.values()}
            if len(lengths) != 1:
                raise ValueError("All dict values must have the same length to split "
                                 "between processes")
            length = lengths.pop()
        per = math.ceil(length / self.num_processes)
        start = self.process_index * per
        end = start + per

        def _split(obj):
            if isinstance(obj, (list, tuple, np.ndarray, torch.Tensor)):
                sliced = obj[start:end]
                if apply_padding and len(sliced) < per and len(obj) > 0:
                    pad = [obj[-1]] * (per - len(sliced))
                    if isinstance(obj, torch.Tensor):
                        sliced = torch.cat([sliced, torch.stack(pad)], dim=0)
                    elif isinstance(obj, np.ndarray):
                        sliced = np.concatenate([sliced, np.stack(pad)], axis=0)
                    else:
                        sliced = list(sliced) + pad
                return sliced
            return obj

        if isinstance(inputs, dict):
            yield {k: _split(v) for k, v in inputs.items()}
        else:
            yield _split(inputs)

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

    def destroy_process_group(self):
        """Tear the process group down (JAX :295), after a barrier so no
        process leaves while another still talks to it."""
        import torch.distributed as dist

        from .parallel import collectives

        if dist.is_initialized():
            self.wait_for_everyone()
            dist.destroy_process_group()
        _AMBIENT.update(mesh=None, config=None)
        collectives._GROUPS.clear()


class AcceleratorState(PartialState):
    """:class:`PartialState` plus the mixed-precision mode (``"no"``,
    ``"bf16"``, ``"fp16"`` or ``"fp8"``; fp8 on a device without fp8
    tensor cores warns and proceeds, or with ``ACCELERATE_FP8_FALLBACK_BF16``
    falls back to bf16, JAX :356-372) and the parallelism config with its
    mesh (JAX :417): validated against the world's size at construction;
    ``PARALLELISM_CONFIG_*`` in the environment supplies one when none is
    given.  Built inside ``parallel.virtual.VirtualMesh.run`` with a
    config, the state is that rank's of the virtual world: its mesh is the
    virtual mesh, validated against its size."""

    def __init__(self, mixed_precision: Optional[str] = None, cpu: bool = False, device=None,
                 parallelism_config=None,
                 init_process_group_kwargs: Optional[InitProcessGroupKwargs] = None):
        from .parallelism_config import ParallelismConfig

        mp = (mixed_precision or "no").lower()
        if mp not in MIXED_PRECISION_TYPES:
            raise ValueError(
                f"mixed_precision must be one of {list(MIXED_PRECISION_TYPES)}, got {mp!r}"
            )
        if parallelism_config is None and os.environ.get("PARALLELISM_CONFIG_DP_SHARD_SIZE"):
            parallelism_config = ParallelismConfig.from_env()
        # built inside parallel/virtual.VirtualMesh.run: that virtual world's
        # rank, on the running rank's mesh
        ambient = _AMBIENT["mesh"]
        virtual = (ambient if parallelism_config is not None
                   and getattr(ambient, "is_virtual", False) else None)
        super().__init__(cpu=cpu, device=device,
                         init_process_group_kwargs=init_process_group_kwargs,
                         world_of_one=parallelism_config is not None and virtual is None)
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
        if parallelism_config is not None:
            parallelism_config._validate(virtual.size if virtual is not None
                                         else self.num_processes)
        self.parallelism_config = parallelism_config
        self._mesh = virtual
        global _accelerator_state_built
        _accelerator_state_built = True

    @property
    def mesh(self):
        """The ``DeviceMesh`` over the world's ranks, built on first use
        (every rank must reach it together): the parallelism config's, or
        pure data parallelism over every rank (JAX :417)."""
        if self._mesh is None:
            from .parallelism_config import ParallelismConfig

            if self.parallelism_config is None:
                self.parallelism_config = ParallelismConfig(dp_shard_size=self.num_processes)
            import torch.distributed as dist

            if not dist.is_initialized():
                _init_world(None, self.backend, world_of_one=True)
            self._mesh = self.parallelism_config.build_device_mesh(
                "cuda" if self.device.type == "cuda" else "cpu")
            _AMBIENT.update(mesh=self._mesh, config=self.parallelism_config)
        return self._mesh


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
