"""The Accelerator: train state, train step and the training loop's data,
schedule, checkpoint and resilience layers on one device (mirrors the
single-device, non-offload path of ``accelerate_tpu/accelerator.py``).

The training loop keeps the JAX package's shape::

    acc = Accelerator(mixed_precision="bf16",
                      kwargs_handlers=[GradSyncKwargs(grad_dtype="bf16")],
                      project_config=ProjectConfiguration(
                          project_dir=run_dir, automatic_checkpoint_naming=True),
                      resilience_plugin=ResiliencePlugin(nan_guard=True,
                                                         handle_preemption=True))
    loader = acc.prepare(torch.utils.data.DataLoader(dataset, batch_size=10))
    state = acc.create_train_state(model, "lion-sr")
    state = acc.maybe_resume(train_state=state) or state
    step = acc.prepare_train_step(make_llama_loss_fn(model, fused_vocab_chunks=4))
    for batch in loader:
        state, metrics = step(state, batch)     # grads, clip, update
        acc.save_state(train_state=state, async_save=True)

The state's params are a name -> tensor dict in the order the JAX package
flattens its param tree (the stochastic-rounding salts key on it).  Given a
module, they are its own parameter tensors, so the module trains in place.
PyTorch runs eagerly: where the JAX step is one jitted program that
donates its input state, the port's step updates the params **in
place**, which saves holding a second copy of the weights; a checkpoint
therefore snapshots them to host memory before the next step runs
(``checkpointing.py``).

The memory and precision recipes (JAX :770-1330):

- ``mixed_precision="fp16"``: the f32 loss scaled by a
  :class:`~.ops.precision.DynamicLossScale` carried in the state, the
  gradients unscaled in f32, a step with a non-finite gradient skipped
  (params and optimizer state bitwise unchanged) as the scale backs off;
  the host reads the finiteness flag once a step, as the NaN guard does.
- ``mixed_precision="fp8"``: the step runs under ``fp8_autocast`` with the
  delayed-scaling metas of ``TrainState.fp8_state`` (``ops/fp8.py``),
  rolled after each update.
- ``FullyShardedDataParallelPlugin(cpu_offload=True)`` (ZeRO-offload): the
  optimizer state and, with ``offload_params``, the stored params live in
  pinned host memory; each step fetches the compute-width params into the
  model's device tensors, stages the gradients device-to-host on a side
  stream and runs the optimizer update on the host in torch CPU ops; with
  ``host_update_chunk_gib`` the update runs over leaf groups
  (``ops/streaming.chunk_groups``, group-relative SR salts as in JAX), and
  with ``host_update_pipeline`` every group's copy is queued at once so
  group k + 1's gradients cross while group k updates.  Global-norm
  clipping then takes the norm on the host.  ``offload_log`` holds the last
  step's bytes and host times.  Under a sharding plan each rank offloads
  its own ranges and stages its reduced f32 gradient ranges.

The one-process surface of the JAX class (JAX :418-506, :1968-2240,
:2475-2521): ``prepare_eval_step``, ``has_aux`` steps, ``autocast``,
triggers, the process helpers, trackers (``tracking.py``: ``log_with=``,
``init_trackers`` / ``log``), ``profile`` (``utils/profiler.py`` on
``torch.profiler``) and, under ``TelemetryPlugin``, the training timeline
(``step_dispatch`` / ``guard_sync`` phases, the loader's ``data_wait`` /
``h2d_staging``, ``train_timeline.json`` at ``end_training``) and the
train step's SLO monitor.

Data and context parallelism over a ``torch.distributed`` world (JAX
:418-506, :2046-2184; ``state.py`` initialises the world): a
``ParallelismConfig`` (``dp_replicate`` x ``dp_shard`` x ``cp``) builds the
``DeviceMesh`` at construction, the train state is laid out by the FSDP
sharding plan (``parallel/sharding.py``) and the step runs its collectives
(``parallel/fsdp.py``): full parameters gathered for the forward, the
gradients reduce-scattered or all-reduced, the update on each rank's
range, the loss the global token mean.  The collectives façade
(``gather``, ``gather_for_metrics``, ``reduce``, ``pad_across_processes``,
``split_between_processes``) runs over the world, ``check_trigger`` sums
the flag across it, and ``maybe_context_parallel`` hands each rank its
zigzag shard of the step's buffers.

Tensor and sequence parallelism (``tp`` / ``sp``, the collective-matmul
ring) lay the Llama's weights out in Megatron slices; under ``ep`` the MoE
table splits each Mixtral expert leaf's experts over the ep ranks, which
read the same batch (``non_data_parallel_size`` counts ep), route alike,
run their own experts and sum their partial outputs (``models/
mixtral.py``); a ``pp`` axis builds its world, and
``parallel.pipeline_parallel.prepare_pipeline`` runs a model as a GPipe
pipeline over it (``unwrap_model`` gives the model back, the
pipeline's trained tensors copied into it).

Multi-node data parallelism (JAX :614-660, :1400-1600): on a mesh with a
``dcn`` axis above 1 the replicated (NO_SHARD / SHARD_GRAD_OP) data-parallel
step reduces its gradients hierarchically (``parallel/hierarchical.py``:
reduce-scatter inside the node, an all-reduce of the slab across ``dcn``,
optionally PowerSGD-compressed, an all-gather), and
``GradSyncKwargs(compression="powersgd")`` runs the DDP PowerSGD step
(``parallel/powersgd.py``), the codec's factors and residuals in
``TrainState.comm_state``.  The recovery ladder (JAX :1797-1871,
:2294-2466): ``ResiliencePlugin(peer_snapshot_every=N)`` arms buddy-rank
host-RAM snapshots (``resilience/peer_ckpt.py``), the ``rank_loss`` and
``straggler`` faults fire in the step, :meth:`Accelerator.recover` walks
peer RAM, the verified disk checkpoint, then a fresh start, and a
preemption stop is agreed across the ranks.

Checkpoints of a train state that is sharded or split over several
ranks are each rank's own ranges with one index of the global layout,
saved synchronously or asynchronously, and restore onto any plan and
process count (``checkpointing.py``).

The sharded step's memory and precision recipes: under FULL_SHARD /
HYBRID_SHARD the forward gathers the weights one unit at a time (the
embedding, each decoder block, the head: ``parallel/fsdp.py``'s
:class:`~.parallel.fsdp.UnitGathers`, units named by the loss function's
model), frees them after the unit (``reshard_after_forward=True``, gathered
again in the backward) or keeps them until its backward (``False``), and
reduces each unit's gradient in its backward, bitwise the whole-tree step;
a step with accumulation or a gradient codec, or a loss function that names
no units, gathers the whole tree.  ZeRO-offload keeps each rank's ranges on
the host (the update with the whole leaves' salts, the chunk groups from the
global shapes, the norm summed over the ranks), and fp8 takes every amax
of the global tensor (``precision.fp8_amax_over``), so the metas agree on
every rank.  Off this path, and raising ``NotImplementedError`` with their
ROADMAP item: Mixtral under tp / cp / sp (A13h.5), pp composed with tp /
cp / sp (A13h.6).  Quantized and LoRA denses, the LoRA head and the
scanned stack run under tp (A13h.4; ``models/layers.py``), their denses
with the collective matmul off.  The donation audit and compile
counter (``audit_step``, ``compile_events``) have no eager meaning and are
not ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import os
import time
from typing import Any, Callable, Optional, Union

import numpy as np
import torch
from torch import nn

from .data_loader import (
    DataLoaderDispatcher,
    DataLoaderShard,
    prepare_data_loader,
    skip_first_batches,
)
from .logging import get_logger
from .ops import fp8 as _fp8
from .ops import operations as _ops
from .ops import streaming as _streaming
from .ops.precision import (
    DynamicLossScale,
    Policy,
    all_finite,
    fp8_amax_over,
    fp8_autocast,
    get_policy,
)
from .ops.stochastic_rounding import GradientTransformation, flax_leaf_order
from .optimizer import AcceleratedOptimizer, make_optimizer
from .parallelism_config import ParallelismConfig
from .resilience import faults as _faults
from .resilience import guard as _guard
from .resilience.goodput import GoodputTracker
from .resilience.retry import RetryPolicy
from .scheduler import AcceleratedScheduler
from .state import AcceleratorState, GradientState
from .utils.dataclasses import (
    AutocastKwargs,
    DataLoaderConfiguration,
    FP8RecipeKwargs,
    FullyShardedDataParallelPlugin,
    GradientAccumulationPlugin,
    GradSyncKwargs,
    InitProcessGroupKwargs,
    ProfileKwargs,
    ProjectConfiguration,
    ResiliencePlugin,
    TelemetryPlugin,
    parse_flag_from_env,
)
from .utils.random import get_rng_key

logger = get_logger(__name__)


@dataclasses.dataclass
class TrainState:
    """The train state the framework owns (JAX ``TrainState``)."""

    step: int
    params: dict
    opt_state: Any
    rng: torch.Generator
    apply_fn: Optional[Callable] = None
    tx: Optional[GradientTransformation] = None
    # NaN-guard skip counters ({nan_skips, consecutive_nan_skips}: int32 0-d
    # tensors, resilience/guard.py), carried so they survive a resume;
    # None unless ResiliencePlugin.nan_guard
    guard_state: Optional[dict] = None
    # accumulation mode "across_steps": the f32 gradient sum carried between
    # calls and the microsteps since the last update
    grad_accum: Optional[list] = None
    accum_step: int = 0
    # fp16: the dynamic loss scale (ops/precision.DynamicLossScale)
    loss_scale: Optional[DynamicLossScale] = None
    # fp8 delayed scaling: {module name: Fp8Meta} (ops/fp8.py)
    fp8_state: Optional[dict] = None
    # the gradient codec's (qs, errs), name -> tensor or None: the flat
    # PowerSGD step's or the hierarchical step's DCN codec's; this rank's
    # own residuals
    comm_state: Optional[tuple] = None

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def global_norm(tensors) -> torch.Tensor:
    """``sqrt(sum ||t||^2)`` over a list or dict of tensors, accumulated in
    f32 (one reduction per tensor, no f32 copy of a bf16 one)."""
    tensors = list(tensors.values()) if isinstance(tensors, dict) else list(tensors)
    if not tensors:
        return torch.tensor(0.0)
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32) for t in tensors]
    return torch.sqrt(torch.stack(norms).square().sum())


def _copy_state(state: TrainState) -> TrainState:
    """A train state whose tensors are copies of ``state``'s, for a step
    that must leave its input as it was (``donate_state=False``)."""
    def copy(x):
        return x.detach().clone() if isinstance(x, torch.Tensor) else x

    def copy_tree(tree):
        return torch.utils._pytree.tree_map(copy, tree)

    opt = state.opt_state
    if hasattr(opt, "_fields"):
        opt = type(opt)(*[copy_tree(v) for v in opt])
    else:
        opt = copy_tree(opt)
    return state.replace(
        params={n: copy(p) for n, p in state.params.items()}, opt_state=opt,
        guard_state=copy_tree(state.guard_state), grad_accum=copy_tree(state.grad_accum))


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP item {item})")


class Accelerator:
    """One device per process (``"cuda"`` unless ``cpu=True`` or
    ``device=`` says otherwise) in a world of one or several processes,
    mixed precision ``"no"``, ``"bf16"``, ``"fp16"`` or ``"fp8"``, the
    sharding plan of a ``parallelism_config`` or ZeRO-offload
    (``fsdp_plugin``), gradient accumulation, the train and eval steps,
    and the loop around them: prepared data loaders and schedules,
    verified checkpoints, the NaN guard, preemption, goodput, trackers,
    the profiler and the training timeline.  The JAX package's
    constructor, plus ``device``."""

    def __init__(self, device_placement: bool = True, split_batches: bool = False,
                 mixed_precision: Optional[str] = None, gradient_accumulation_steps: int = 1,
                 cpu: bool = False,
                 dataloader_config: Optional[DataLoaderConfiguration] = None,
                 parallelism_config=None, fsdp_plugin=None,
                 tp_config=None, cp_config=None, sp_config=None,
                 gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None,
                 resilience_plugin: Optional[ResiliencePlugin] = None,
                 telemetry_plugin: Optional[TelemetryPlugin] = None,
                 rng_types: Optional[list] = None,
                 log_with: Optional[Union[str, list]] = None,
                 project_dir: Optional[str] = None,
                 project_config: Optional[ProjectConfiguration] = None,
                 step_scheduler_with_optimizer: bool = True,
                 kwargs_handlers: Optional[list] = None, device=None):
        if parallelism_config is not None:
            if not isinstance(parallelism_config, ParallelismConfig):
                raise TypeError(f"parallelism_config must be a ParallelismConfig, got "
                                f"{type(parallelism_config).__name__}")
            pc = parallelism_config
            if pc.pp_size > 1 and max(pc.tp_size, pc.cp_size, pc.sp_size) > 1:
                raise _not_ported("pipeline parallelism composed with tp / cp / sp", "A13h.6")
        if fsdp_plugin is not None and not isinstance(fsdp_plugin,
                                                      FullyShardedDataParallelPlugin):
            raise TypeError(f"fsdp_plugin must be a FullyShardedDataParallelPlugin, got "
                            f"{type(fsdp_plugin).__name__}")
        self.fsdp_plugin = fsdp_plugin
        # the ring collective matmul's mode (ops/collective_matmul.py), read
        # by every forward: the plugin's knob, or none, which clears a mode an
        # earlier Accelerator installed back to the env default (JAX :326-334)
        from .ops.collective_matmul import set_collective_matmul

        set_collective_matmul(fsdp_plugin.collective_matmul if fsdp_plugin is not None
                              else None)
        # tp_config.plan picks the plan's rule table (JAX :735); the configs
        # are kept as JAX keeps them (:336-338)
        self.tp_config = tp_config
        self.cp_config = cp_config
        self.sp_config = sp_config
        self.resilience_plugin = resilience_plugin or ResiliencePlugin()
        # armed by the prepared step at its first update under
        # peer_snapshot_every > 0 (resilience/peer_ckpt.py)
        self._peer_snapshotter = None
        # how the newest prepared train step resolved the hierarchical sync
        self._dcn_sync: Optional[dict] = None
        self.grad_sync_kwargs = GradSyncKwargs()
        self.fp8_recipe: Optional[FP8RecipeKwargs] = None
        self.autocast_handler = AutocastKwargs()
        self.profile_kwargs = ProfileKwargs()
        self.init_process_group_kwargs: Optional[InitProcessGroupKwargs] = None
        for handler in kwargs_handlers or []:
            if isinstance(handler, FP8RecipeKwargs):
                self.fp8_recipe = handler
            elif isinstance(handler, GradSyncKwargs):
                self.grad_sync_kwargs = handler
            elif isinstance(handler, AutocastKwargs):
                self.autocast_handler = handler
            elif isinstance(handler, ProfileKwargs):
                self.profile_kwargs = handler
            elif isinstance(handler, InitProcessGroupKwargs):
                self.init_process_group_kwargs = handler
            else:
                raise TypeError(f"unknown kwargs handler {type(handler).__name__}")
        if gradient_accumulation_plugin is None:
            gradient_accumulation_plugin = GradientAccumulationPlugin(
                num_steps=gradient_accumulation_steps)
        elif (gradient_accumulation_steps != 1
              and gradient_accumulation_plugin.num_steps != gradient_accumulation_steps):
            raise ValueError(
                "Pass gradient_accumulation_steps OR gradient_accumulation_plugin, not "
                "conflicting both"
            )
        self.project_configuration = project_config or ProjectConfiguration(project_dir=project_dir)
        if project_dir is not None and self.project_configuration.project_dir is None:
            self.project_configuration.set_directories(project_dir)
        self.state = AcceleratorState(mixed_precision=mixed_precision, cpu=cpu, device=device,
                                      parallelism_config=parallelism_config,
                                      init_process_group_kwargs=self.init_process_group_kwargs)
        # a world (a config, or several processes) has its mesh from the
        # start: every rank builds it here, together
        self._parallel = (self.state.parallelism_config is not None
                          or self.state.num_processes > 1)
        if self._parallel:
            self.state.mesh
        self.gradient_state = GradientState(gradient_accumulation_plugin=gradient_accumulation_plugin)
        self.policy: Policy = get_policy(self.state.mixed_precision)
        self.split_batches = split_batches
        self.device_placement = device_placement
        self.step_scheduler_with_optimizer = step_scheduler_with_optimizer
        self.dataloader_config = dataloader_config or DataLoaderConfiguration(
            split_batches=split_batches)
        self.rng_types = rng_types
        self.step_count = 0
        self._in_accumulate = False
        # the offloaded step's last bytes and times (see the module doc)
        self.offload_log: dict = {}
        self._offload_buffers: dict = {}
        # the sharding plan of the newest train state made in a world
        # (parallel/fsdp.py), None outside one
        self._dp_plan = None

        self._dataloaders: list = []
        self._optimizers: list = []
        self._schedulers: list = []
        self._models: list = []
        self._custom_objects: list = []
        self._save_model_state_pre_hooks: dict = {}
        self._load_model_state_pre_hooks: dict = {}
        # in-flight async train-state write and its long-lived writer
        # (checkpointing.py), and the pinned host buffers saves snapshot into
        self._pending_checkpointer = None
        # a save across processes awaiting its collective publish
        self._pending_publish = None
        self._async_checkpointer = None
        self._checkpoint_buffers: list = []
        self.last_restored_checkpoint: Optional[str] = None
        # each save's timings and bytes by directory (checkpointing.py)
        self.checkpoint_log: dict = {}
        # the goodput tracker always exists (zeros when the run is clean)
        self.goodput = GoodputTracker()
        self.flag_tensor: Optional[torch.Tensor] = None
        self.trackers: list = []
        self.log_with = (list(log_with) if isinstance(log_with, (list, tuple))
                         else ([log_with] if log_with else []))
        # the training timeline and the step's SLO monitor: host-side, armed
        # only by the plugin, so the step wrapper pays one attribute check
        # when they are off
        self.telemetry_plugin = telemetry_plugin or TelemetryPlugin()
        self.timeline = None
        self.slo_monitor = None
        if self.telemetry_plugin.timeline:
            from .telemetry import TrainTimeline

            self.timeline = TrainTimeline(capacity=self.telemetry_plugin.ring_capacity)
        if self.telemetry_plugin.slo is not None:
            from .telemetry import SLOMonitor

            self.slo_monitor = SLOMonitor(self.telemetry_plugin.slo)
        self._slo_prev_step_t = None
        self._preemption = None
        if self.resilience_plugin.handle_preemption:
            self.install_preemption_handler()
        if _faults.active_fault_plan() is None:
            # a subprocess run's plan arrives as JSON in ACCELERATE_FAULT_PLAN
            env_plan = _faults.FaultPlan.from_env()
            if env_plan is not None:
                _faults.install_fault_plan(env_plan)

    # -- introspection ---------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def mixed_precision(self) -> str:
        return self.state.mixed_precision

    @property
    def num_processes(self) -> int:
        return self.state.num_processes

    @property
    def process_index(self) -> int:
        return self.state.process_index

    @property
    def is_main_process(self) -> bool:
        return self.state.is_main_process

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.gradient_state.num_steps

    @property
    def sync_gradients(self) -> bool:
        return self.gradient_state.sync_gradients

    @property
    def project_dir(self):
        return self.project_configuration.project_dir

    @property
    def distributed_type(self):
        return self.state.distributed_type

    @property
    def local_process_index(self) -> int:
        return self.state.local_process_index

    @property
    def is_local_main_process(self) -> bool:
        return self.state.is_local_main_process

    @property
    def is_last_process(self) -> bool:
        return self.state.is_last_process

    @property
    def use_distributed(self) -> bool:
        return self.state.use_distributed

    @property
    def mesh(self):
        """The ``DeviceMesh`` over the world's ranks (JAX :438): the
        parallelism config's, or pure data parallelism over every rank."""
        return self.state.mesh

    @property
    def parallelism_config(self) -> ParallelismConfig:
        """The parallelism config (a default one over every rank once the
        mesh exists, JAX :442)."""
        self.state.mesh
        return self.state.parallelism_config

    def on_main_process(self, function=None):
        return self.state.on_main_process(function)

    def on_local_main_process(self, function=None):
        return self.state.on_local_main_process(function)

    def on_process(self, function=None, process_index=None):
        return self.state.on_process(function, process_index=process_index)

    def on_last_process(self, function):
        return self.state.on_last_process(function)

    def wait_for_everyone(self):
        """A barrier over the world's processes."""
        self.state.wait_for_everyone()

    def print(self, *args, **kwargs):
        """``print`` on the main process."""
        self.state.print(*args, **kwargs)

    @contextlib.contextmanager
    def main_process_first(self):
        with self.state.main_process_first():
            yield

    @contextlib.contextmanager
    def local_main_process_first(self):
        with self.state.local_main_process_first():
            yield

    # -- the collectives façade (JAX :510, :2046-2084) ----------------------

    def split_between_processes(self, inputs, apply_padding: bool = False):
        """A context yielding this process's share of ``inputs`` (JAX :510)."""
        return self.state.split_between_processes(inputs, apply_padding=apply_padding)

    def gather(self, tensor):
        return _ops.gather(tensor)

    def reduce(self, tensor, reduction: str = "sum", scale: float = 1.0):
        return _ops.reduce(tensor, reduction=reduction, scale=scale)

    def pad_across_processes(self, tensor, dim: int = 0, pad_index: int = 0,
                             pad_first: bool = False):
        return _ops.pad_across_processes(tensor, dim=dim, pad_index=pad_index,
                                         pad_first=pad_first)

    # -- multi-node data parallelism (JAX :614-660, :1898-1925) ------------

    def _mesh_sizes(self) -> dict:
        """``{axis: size}`` of the mesh; empty for one process without a
        parallelism config (which has none)."""
        if not self._parallel:
            return {}
        from .parallel.collectives import mesh_sizes

        return mesh_sizes(self.mesh)

    def _compression_axes(self) -> list:
        """The mesh axes the gradient compression reduces over: the
        data-parallel plane, the cross-node ``dcn`` axis included."""
        sizes = self._mesh_sizes()
        return [a for a in ("dcn", "dp_replicate", "dp_shard") if a in sizes]

    def _dp_world(self) -> int:
        sizes = self._mesh_sizes()
        return int(np.prod([sizes[a] for a in self._compression_axes()]))

    def _ici_size(self) -> int:
        sizes = self._mesh_sizes()
        return int(np.prod([sizes[a] for a in self._compression_axes() if a != "dcn"]))

    def _ddp_shape(self) -> tuple[dict, bool, Any]:
        """What keeps a config from the DDP shape the codecs need:
        ``(the non-data-parallel axes above 1, whether the params shard,
        the sharding strategy)``."""
        if not self._parallel:
            return {}, False, None
        from .parallel.sharding import param_fsdp_axes, resolve_sharding_strategy

        pc = self.parallelism_config
        bad = {k: v for k, v in
               {"tp": pc.tp_size, "pp": pc.pp_size, "cp": pc.cp_size,
                "sp": pc.sp_size, "ep": pc.ep_size}.items() if v > 1}
        strategy = resolve_sharding_strategy(self.fsdp_plugin, pc)
        return bad, bool(param_fsdp_axes(self.mesh, pc, strategy)), strategy

    def _resolve_hierarchical(self) -> tuple[bool, Optional[str]]:
        """``(engage, incompatibility)`` of the hierarchical gradient sync:
        engage when the mesh has a ``dcn`` axis above 1 and the config is
        DDP-shaped (replicated params, pure data parallelism);
        ``incompatibility`` names the blocker when the dcn axis exists but
        the path cannot replace the flat reduction."""
        gsk = self.grad_sync_kwargs
        if gsk.hierarchical is False:
            return False, None
        if self._mesh_sizes().get("dcn", 1) <= 1:
            if gsk.hierarchical:
                return False, "mesh has no dcn axis (ParallelismConfig.dcn_size <= 1)"
            return False, None
        bad, params_sharded, strategy = self._ddp_shape()
        offload_opt, _ = self._offload_flags()
        blockers = []
        if bad:
            blockers.append(f"non-dp axes {bad}")
        if params_sharded:
            blockers.append(f"params sharded ({strategy})")
        if offload_opt:
            blockers.append("cpu_offload")
        if self.gradient_state.num_steps > 1:
            blockers.append("gradient accumulation > 1")
        if self.policy.needs_loss_scaling:
            blockers.append("fp16 loss scaling")
        if gsk.comm_dtype or gsk.grad_dtype:
            blockers.append("comm_dtype/grad_dtype")
        if gsk.compression:
            blockers.append("compression='powersgd' (the flat DDP codec owns the step)")
        if blockers:
            return False, "; ".join(blockers)
        return True, None

    @property
    def dcn_sync(self) -> Optional[dict]:
        """How the newest prepared train step resolved the hierarchical
        reduction (None before ``prepare_train_step``): ``{"enabled",
        "dcn_size", "ici_size", "compression", "why_not"}``."""
        return self._dcn_sync

    def dcn_sync_accounting(self, params, step_compute_s: Optional[float] = None) -> dict:
        """Predicted DCN bytes a rank moves a step for ``params``' gradient
        sync on this mesh (``parallel/hierarchical.dcn_comm_accounting``):
        the hierarchical schedule against the flat one, with the PowerSGD
        codec where ``GradSyncKwargs.dcn_compression`` sets it.  Zeros on a
        mesh without a ``dcn`` axis."""
        from .parallel.hierarchical import dcn_comm_accounting

        sync = self.dcn_sync
        compression = (sync["compression"] if sync is not None
                       else self.grad_sync_kwargs.dcn_compression)
        return dcn_comm_accounting(params, ici_size=self._ici_size(),
                                   dcn_size=self._mesh_sizes().get("dcn", 1),
                                   compression=compression, rank=self.grad_sync_kwargs.rank,
                                   step_compute_s=step_compute_s)

    @contextlib.contextmanager
    def maybe_context_parallel(self, buffers=None, buffer_seq_dims=None,
                               no_restore_buffers=None):
        """Each step buffer as this rank's cp shard (JAX :2131): reordered
        along its sequence dim into the zigzag layout
        (``parallel/context_parallel.py``) and cut to the rank's
        contiguous part, on the accelerator's device.  Yields the list;
        at ``cp_size <= 1`` the buffers as they are.  Labels must be
        pre-shifted before (``shift_labels``, ``-100`` past the end): after
        the reorder the next position is no longer the next index.
        ``no_restore_buffers`` is accepted for the signature: nothing is
        mutated, so nothing is restored::

            shift = torch.roll(ids, -1, 1); shift[:, -1] = -100
            with acc.maybe_context_parallel([ids, shift], [1, 1]) as (ids_cp, shift_cp):
                state, m = step(state, {"input_ids": ids_cp, "shift_labels": shift_cp})
        """
        if buffers is None:
            yield []
            return
        pcfg = self.state.parallelism_config
        if pcfg is None or pcfg.cp_size <= 1:
            yield list(buffers)
            return
        from .parallel import collectives
        from .parallel.context_parallel import zigzag_shard

        cp = pcfg.cp_size
        seq_dims = buffer_seq_dims or [1] * len(buffers)
        if len(seq_dims) != len(buffers):
            raise ValueError("buffer_seq_dims must match buffers in length")
        rank = collectives.axis_index("cp", self.mesh)
        out = []
        for buf, dim in zip(buffers, seq_dims):
            t = torch.as_tensor(buf)
            local = torch.chunk(zigzag_shard(t, cp, axis=dim), cp, dim=dim)[rank]
            out.append(local.contiguous().to(self.device))
        yield out

    @contextlib.contextmanager
    def join_uneven_inputs(self, joinables, even_batches: Optional[bool] = None):
        """The prepared loaders even the batches out up front (``even_batches``),
        so nothing needs joining; ``even_batches=False`` warns (JAX
        :2120)."""
        if even_batches is False:
            import warnings

            warnings.warn("join_uneven_inputs cannot retrofit uneven batches; use "
                          "even_batches=True")
        yield

    # -- prepare ---------------------------------------------------------

    def prepare(self, *args, device_placement: Optional[list] = None):
        """Lift user objects into their prepared equivalents, in order: data
        loaders (:meth:`prepare_data_loader`), optimizers (a
        :class:`GradientTransformation`), schedules (a callable marked
        ``is_schedule = True``, :meth:`prepare_scheduler`) and modules
        (recorded for the checkpoint hooks); anything else passes
        through."""
        if device_placement is None:
            device_placement = [None] * len(args)
        result = tuple(self._prepare_one(obj, dp) for obj, dp in zip(args, device_placement))
        return result if len(result) > 1 else (result[0] if result else None)

    def _prepare_one(self, obj, device_placement=None):
        if isinstance(obj, (DataLoaderShard, DataLoaderDispatcher)):
            return obj  # already prepared
        if isinstance(obj, torch.utils.data.DataLoader):
            return self.prepare_data_loader(obj, device_placement=device_placement)
        if isinstance(obj, (AcceleratedOptimizer, GradientTransformation)):
            return self.prepare_optimizer(obj)
        if isinstance(obj, AcceleratedScheduler):
            return obj
        if isinstance(obj, nn.Module):
            return self.prepare_model(obj)
        if callable(obj) and not inspect.isclass(obj):
            try:
                n_args = len(inspect.signature(obj).parameters)
            except (TypeError, ValueError):
                n_args = None
            if n_args == 1:
                if getattr(obj, "is_schedule", False):
                    return self.prepare_scheduler(obj)
                logger.warning(
                    "prepare() received a 1-argument callable %r that is not marked as a "
                    "schedule; returning it unchanged. If it is a learning-rate schedule, "
                    "pass it through accelerator.prepare_scheduler() or set "
                    "`fn.is_schedule = True`.", getattr(obj, "__name__", obj),
                )
        return obj

    def prepare_model(self, model, device_placement=None, evaluation_mode: bool = False):
        """Record the module (the checkpoint hooks receive it) and return it
        unchanged: its parameters become the train state's params in
        :meth:`create_train_state`."""
        self._models.append(model)
        return model

    def prepare_data_loader(self, data_loader, device_placement=None,
                            slice_fn_for_dispatch=None):
        """A :class:`~.data_loader.DataLoaderShard` (or dispatcher) over
        ``data_loader`` that hands out batches on this accelerator's device,
        signals this accelerator's gradient state, retries its staging
        under the resilience plugin's budget and is checkpointed with the
        accelerator."""
        if isinstance(data_loader, (DataLoaderShard, DataLoaderDispatcher)):
            return data_loader
        put_on_device = device_placement if device_placement is not None else self.device_placement
        dlc = self.dataloader_config
        prepared = prepare_data_loader(
            data_loader,
            device=self.device,
            split_batches=dlc.split_batches or self.split_batches,
            put_on_device=put_on_device,
            rng_types=self.rng_types,
            dispatch_batches=dlc.dispatch_batches,
            even_batches=dlc.even_batches,
            slice_fn_for_dispatch=slice_fn_for_dispatch,
            use_seedable_sampler=dlc.use_seedable_sampler,
            data_seed=dlc.data_seed,
            non_blocking=dlc.non_blocking,
            use_stateful_dataloader=dlc.use_stateful_dataloader,
            prefetch_size=dlc.prefetch_size,
            transfer_retry_policy=self._transfer_retry_policy(),
            on_transfer_retry=self.goodput.record_retry,
            gradient_state=self.gradient_state,
            parallelism_config=self.state.parallelism_config,
        )
        if self.timeline is not None:
            # the loader's data_wait / h2d_staging phases (data_loader.py)
            prepared._timeline = self.timeline
        pcfg = self.state.parallelism_config
        if pcfg is not None and pcfg.sp_size > 1 and isinstance(prepared, DataLoaderShard):
            # the batch spec's sequence split over sp (JAX :663-672): each
            # rank its contiguous slice, labels shifted first
            from .parallel.sequence_parallel import shard_batch_along_sequence

            prepared._batch_fn = functools.partial(shard_batch_along_sequence, mesh=self.mesh)
        self._dataloaders.append(prepared)
        return prepared

    def _transfer_retry_policy(self) -> RetryPolicy:
        rp = self.resilience_plugin
        return RetryPolicy(retries=rp.io_retries, backoff_s=rp.io_backoff_s)

    def prepare_scheduler(self, scheduler) -> AcceleratedScheduler:
        """Wrap a schedule ``step -> lr``: the prepared train step writes
        ``schedule(count)`` into the optimizer's ``hyperparams["lr"]``
        before each update (``scheduler.py``), and the wrapper is
        checkpointed with the accelerator."""
        if isinstance(scheduler, AcceleratedScheduler):
            return scheduler
        wrapped = AcceleratedScheduler(
            scheduler,
            optimizer=self._optimizers[-1] if self._optimizers else None,
            step_with_optimizer=self.step_scheduler_with_optimizer,
            split_batches=self.split_batches,
            gradient_state=self.gradient_state,
            num_processes=self.num_processes,
        )
        self._schedulers.append(wrapped)
        return wrapped

    # -- optimizer and train state ---------------------------------------

    def prepare_optimizer(self, optimizer: Union[str, GradientTransformation,
                                                 AcceleratedOptimizer],
                          device_placement=None) -> AcceleratedOptimizer:
        """A recipe name (:func:`~.optimizer.make_optimizer`; the -sr8
        recipes at the plugin's ``int8_state_block_size``), a
        transformation, or an :class:`AcceleratedOptimizer`."""
        if isinstance(optimizer, AcceleratedOptimizer):
            return optimizer
        if isinstance(optimizer, str):
            # the -sr8 recipes take their scale granularity from the plugin
            block = (self.fsdp_plugin.int8_state_block_size
                     if self.fsdp_plugin is not None and optimizer.endswith("-sr8") else None)
            optimizer = make_optimizer(optimizer, block_size=block)
        wrapped = AcceleratedOptimizer(optimizer)
        self._optimizers.append(wrapped)
        return wrapped

    def _offload_flags(self) -> tuple[bool, bool]:
        """(offload the optimizer state, offload the stored params) from the
        plugin (JAX :770)."""
        p = self.fsdp_plugin
        if p is None:
            return False, False
        return bool(p.cpu_offload), bool(p.cpu_offload and p.offload_params)

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """A host copy of ``t``, page-locked when the accelerator is on the
        card (the CPU accelerator's host is its device: ``t`` itself)."""
        if self.device.type != "cuda":
            return t
        return t.detach().to("cpu").pin_memory()

    def device_params(self, params: dict) -> dict:
        """Whole device copies of (possibly host-offloaded or sharded)
        params, for uses off the train step (JAX :747); resident params
        come back as they are.  A sharded train state's params are
        gathered (every rank must call this together)."""
        plan = self._dp_plan
        if plan is not None and params.keys() == plan.layouts.keys() and any(
                tuple(p.shape) != plan.layouts[n].whole_shape for n, p in params.items()):
            params = plan.whole_params(params)
        return {n: p if p.device.type == self.device.type else p.to(self.device)
                for n, p in params.items()}

    def create_train_state(self, params: Union[nn.Module, dict], optimizer,
                           apply_fn: Optional[Callable] = None,
                           rng: Optional[torch.Generator] = None) -> TrainState:
        """The train state over ``params`` (a module — its own parameter
        tensors — or a name -> tensor dict), ordered as the JAX package
        flattens its tree, with the optimizer state initialised on them (in
        a world, each rank's shards under the sharding plan:
        ``parallel/fsdp.py``; a module's full copies of the sharded leaves
        are released),
        the guard's counters under ``ResiliencePlugin(nan_guard=True)``, the
        carried accumulator under ``mode="across_steps"``, the loss scale
        under fp16 and the delayed-scaling metas under fp8.  Under
        ``cpu_offload`` the optimizer state (and with ``offload_params`` the
        stored params) are page-locked host copies; the module's device
        tensors then hold the compute copy each step fetches."""
        module = params if isinstance(params, nn.Module) else None
        if module is not None:
            params = {n: p.detach() for n, p in module.named_parameters()}
        params = {n: params[n] for n in flax_leaf_order(params)}
        dev = self.device
        for name, p in params.items():
            if p.device.type != dev.type or (dev.index is not None and p.device.index != dev.index):
                raise ValueError(f"param {name} is on {p.device}, the accelerator on "
                                 f"{self.device}")
        tx = self.prepare_optimizer(optimizer).tx
        accum = (self.gradient_state.num_steps > 1
                 and self.gradient_state.plugin.mode == "across_steps")
        offload_opt, offload_params = self._offload_flags()
        gsk = self.grad_sync_kwargs
        comm_state = None
        if gsk.compression == "powersgd":
            from .parallel.powersgd import init_powersgd_state

            comm_state = init_powersgd_state(params, gsk.rank, device=dev)
        elif gsk.dcn_compression == "powersgd" and self._resolve_hierarchical()[0]:
            # the DCN codec's state only where the hierarchical path engages
            # (prepare_train_step raises on a config where it cannot)
            from .parallel.hierarchical import init_dcn_powersgd_state

            comm_state = init_dcn_powersgd_state(params, gsk.rank, self._ici_size(), device=dev)
        plan = None
        if self._parallel:
            from .parallel.fsdp import DataParallelPlan, parallel_align
            from .parallel.sharding import tp_rules_for

            pcfg = self.state.parallelism_config
            plan = DataParallelPlan(self.mesh, pcfg, self.fsdp_plugin, params,
                                    align=parallel_align(self.fsdp_plugin),
                                    tp_rules=tp_rules_for(pcfg, self.tp_config))
            stored = plan.shard_params(params)
            if module is not None:
                for name, p in module.named_parameters():
                    if stored.get(name) is not None and stored[name] is not params[name]:
                        p.data = torch.empty(0, dtype=p.dtype, device=p.device)
            params = stored
        self._dp_plan = plan
        fp8_state = None
        if self.mixed_precision == "fp8" and _fp8.fp8_delayed_enabled():
            recipe = self.fp8_recipe
            fp8_state = _fp8.init_fp8_state(
                params, history_len=recipe.amax_history_len if recipe else None,
                margin=recipe.margin if recipe else None, plan=plan)
        if offload_opt:
            # the stored params' compute copies: the given device tensors (a
            # rank's ranges under a plan: no whole leaf crosses)
            self._offload_buffers = {"compute": dict(params), "grads": {}, "params": [],
                                     "fetch": {}}
            host_params = {n: self._to_host(p) for n, p in params.items()}
            if plan is None:
                opt_leaves = list(host_params.values())
            elif any(lay.relay for lay in plan.layouts.values()):
                # a relay leaf's range lies over the whole leaf: cut on the card
                opt_leaves = [self._to_host(t) for t in plan.opt_params(params)]
            else:
                opt_leaves = plan.opt_params(host_params)
            # the optimizer state is made on the host
            opt_state = tx.init(opt_leaves)
            opt_state = type(opt_state)(*[
                [self._to_host(t) for t in v] if isinstance(v, list) else v
                for v in opt_state])
            if offload_params:
                params = host_params
        else:
            opt_state = tx.init(plan.opt_params(params) if plan is not None
                                else list(params.values()))
        return TrainState(
            step=0,
            params=params,
            opt_state=opt_state,
            rng=rng if rng is not None else get_rng_key(0, device=self.device),
            apply_fn=apply_fn,
            tx=tx,
            guard_state=(_guard.init_guard_state(self.device)
                         if self.resilience_plugin.nan_guard else None),
            grad_accum=([torch.zeros(plan.layouts[n].shape if plan is not None else p.shape,
                                     dtype=torch.float32, device=dev)
                         for n, p in params.items()] if accum else None),
            loss_scale=(DynamicLossScale(device=dev) if self.policy.needs_loss_scaling
                        else None),
            fp8_state=fp8_state,
            comm_state=comm_state,
        )

    # -- the train step --------------------------------------------------

    def _lr_schedule(self, state: TrainState) -> Optional[Callable]:
        """The schedule of the newest prepared scheduler bound to this
        state's optimizer (or to none)."""
        for sched in reversed(self._schedulers):
            if sched.optimizer is None or sched.optimizer.tx is state.tx:
                return sched.schedule
        return None

    def prepare_train_step(self, loss_fn: Callable, max_grad_norm: Optional[float] = None,
                           has_aux: bool = False, donate_state: bool = True) -> Callable:
        """``step(state, batch) -> (new_state, metrics)`` for
        ``loss_fn(params, batch [, rng])``: gradients (f32, or bf16 with
        ``GradSyncKwargs(grad_dtype="bf16")``), accumulation over
        ``gradient_accumulation_steps`` (``in_step``: microbatches of the
        batch, summed in f32; ``across_steps``: the f32 sum carried in the
        state, an update every ``num_steps``-th call), global-norm clipping
        in each gradient's own width, the optimizer update in place — on
        the host under ``cpu_offload``.  ``metrics`` holds ``loss`` and
        ``grad_norm`` as tensors; under fp16 also ``grads_finite`` and
        ``loss_scale``; with the NaN guard its three keys.  A step reads
        one finiteness flag back when the guard or fp16 is on, none
        otherwise (the offloaded step waits on its copies besides).  In a
        world the step runs the sharding plan's collectives
        (``parallel/fsdp.py``) and ``loss`` is the global token mean: each
        rank's loss weighted by its share of the valid tokens, summed.  On a
        ``dcn`` mesh the replicated step reduces hierarchically, and
        ``GradSyncKwargs(compression="powersgd")`` runs the PowerSGD step
        (:meth:`dcn_sync` says which); those two codec steps take JAX's
        mean of the ranks' own mean losses (:meth:`_codec_step`)."""
        gsk = self.grad_sync_kwargs
        codec = self._resolve_grad_sync(has_aux)
        if not donate_state and self._offload_flags()[0]:
            raise ValueError("donate_state=False under cpu_offload: the offloaded state lives "
                             "in reused page-locked buffers, updated in place")
        if gsk.grad_dtype not in (None, "bf16"):
            raise ValueError(f"GradSyncKwargs.grad_dtype supports only 'bf16', got "
                             f"{gsk.grad_dtype!r}")
        policy = self.policy
        if gsk.grad_dtype is not None and policy.needs_loss_scaling:
            raise ValueError(
                "GradSyncKwargs.grad_dtype supports only 'bf16' without loss scaling (fp16 "
                f"grads must be unscaled in fp32); got grad_dtype={gsk.grad_dtype!r} with "
                f"mixed_precision={self.mixed_precision!r}")
        comm_dtype = {"bf16": torch.bfloat16, "fp16": torch.float16, None: None}[gsk.comm_dtype]
        wants_rng = "rng" in inspect.signature(loss_fn).parameters
        accum_steps = self.gradient_state.num_steps
        mode = self.gradient_state.plugin.mode
        compute_width = gsk.grad_dtype is not None
        use_fp8 = self.mixed_precision == "fp8"
        nan_guard = bool(self.resilience_plugin.nan_guard)
        guard_abort_after = self.resilience_plugin.max_consecutive_nan_skips if nan_guard else 0
        if nan_guard and mode == "across_steps" and accum_steps > 1:
            logger.warning(
                "nan_guard with gradient accumulation mode='across_steps' only protects the "
                "boundary update: a non-finite microbatch pollutes the carried accumulator "
                "before the guard sees it"
            )
        offload_opt, offload_params = self._offload_flags()
        plugin = self.fsdp_plugin
        chunk_bytes = (int(plugin.host_update_chunk_gib * 2**30)
                       if offload_opt and plugin.host_update_chunk_gib else None)
        pipeline = bool(chunk_bytes is not None and plugin.host_update_pipeline)
        if chunk_bytes is not None:
            logger.warning(
                "host_update_chunk_gib=%s splits the optimizer update into per-leaf-group "
                "host updates: the recipe must be per-leaf independent (the named recipes "
                "are); pass max_grad_norm to prepare_train_step for global clipping",
                plugin.host_update_chunk_gib)
        # clipping under offload takes the norm on the host, after every
        # gradient has crossed (JAX :1148-1160)
        gnorm_on_host = offload_opt and max_grad_norm is not None
        # the guard's host reading of the step just run: (skipped, consecutive)
        guard_read: dict = {}
        # per-unit gathering under a sharding plan (parallel/fsdp.py): the
        # loss_fn's model names its units; a step with accumulation or a
        # codec gathers the whole tree
        units_of = getattr(loss_fn, "fsdp_units", None)
        reshard = plugin.reshard_after_forward if plugin is not None else True
        owned_by_plan: dict = {}
        # which gradients the last compute_grads handed over reduced
        unit_done: dict = {}

        def owned_leaves() -> frozenset:
            plan = self._dp_plan
            if plan is None or units_of is None or codec is not None or accum_steps > 1:
                return frozenset()
            if owned_by_plan.get("plan") is not plan:
                from .parallel.fsdp import owned_leaves as plan_owned

                owned_by_plan.update(plan=plan, owned=frozenset(plan_owned(plan, units_of())))
            return owned_by_plan["owned"]

        def fetch_params(state: TrainState) -> dict:
            """The params the forward reads: the stored ones (gathered whole
            under a sharding plan, but for the leaves its units gather), or
            under ``offload_params`` their compute-width copies fetched into
            the device buffers (cast on the host first where the widths
            differ: only the compute copy crosses; under a plan a rank's
            ranges, gathered after)."""
            params = fetch_compute(state)
            if self._dp_plan is not None:
                return self._dp_plan.gather_params(params, skip=owned_leaves())
            return params

        def fetch_compute(state: TrainState) -> dict:
            if offload_opt:
                self.offload_log = {"h2d_bytes": 0}
            if not offload_params:
                return state.params
            buf = self._offload_buffers
            compute, staging = buf["compute"], buf["fetch"]
            h2d = 0
            for name, hp in state.params.items():
                want = policy.compute_dtype if hp.is_floating_point() else hp.dtype
                dst = compute[name]
                if dst.dtype != want:
                    dst = compute[name] = torch.empty(hp.shape, dtype=want, device=self.device)
                src = hp
                if hp.dtype != want:
                    src = staging.get(name)
                    if src is None:
                        src = staging[name] = self._to_host(torch.empty(hp.shape, dtype=want))
                    src.copy_(hp)
                if dst is not src:
                    dst.copy_(src, non_blocking=True)
                h2d += dst.numel() * dst.element_size()
            self.offload_log["h2d_bytes"] = h2d
            return compute

        def grad_widths(g: torch.Tensor, state: TrainState) -> torch.Tensor:
            """A gradient in the widths the reduction and the update take."""
            if comm_dtype is not None:
                g = g.to(comm_dtype)
            if not compute_width and (not offload_opt or state.loss_scale is not None
                                      or self._dp_plan is not None):
                # f32 on the card; the offloaded step sends the compute width
                # and widens on the host (fp16 must unscale in f32 first),
                # but under a plan reduces in f32 as the resident step does
                # and sends the rank's f32 ranges
                g = g.float()
            return g

        def compute_grads(state: TrainState, params: dict, batch, rng, weighted: bool = True):
            names = list(params)
            owned = owned_leaves()
            if compute_width:
                # differentiate with respect to the compute-width copy: every
                # gradient is born bf16
                leaves = [p.detach().to(policy.compute_dtype).requires_grad_()
                          for p in params.values()]
                p_in = dict(zip(names, leaves))
            else:
                leaves = [p.detach().requires_grad_() for p in params.values()]
                p_in = policy.cast_to_compute(dict(zip(names, leaves)))
            units = None
            if owned:
                from .parallel.fsdp import UnitGathers

                # the owned leaves go in as the stored ranges: each unit
                # gathers (and casts) its own
                ranges = {n: leaf for n, leaf in zip(names, leaves) if n in owned}
                p_in.update(ranges)
                units = UnitGathers(self._dp_plan, ranges, policy.compute_dtype,
                                    lambda g: grad_widths(g, state), reshard)
            with contextlib.ExitStack() as regions:
                if use_fp8:
                    regions.enter_context(fp8_autocast())
                    regions.enter_context(_fp8.merge_fp8_collection(state.fp8_state))
                    if self._dp_plan is not None:
                        # every amax the fp8 products take is the global
                        # tensor's (JAX's under GSPMD)
                        regions.enter_context(fp8_amax_over(self._dp_plan.mesh,
                                                            self._dp_plan.all_axes))
                if units is not None:
                    regions.enter_context(units.active())
                out = loss_fn(p_in, batch, rng) if wants_rng else loss_fn(p_in, batch)
            loss, aux = out if has_aux else (out, None)
            loss = loss.float()
            weight = (self._dp_plan.token_weight(batch)
                      if weighted and self._dp_plan is not None else None)
            if weight is not None:
                loss = loss * weight
            # the scalar loss lives in f32, so scaling it by 2^16 cannot overflow
            scaled = state.loss_scale.scale_loss(loss) if state.loss_scale is not None else loss
            plan = self._dp_plan
            if plan is not None and plan.virtual:
                from .parallel.collectives import joint_grad

                grads = joint_grad(scaled, leaves, plan.mesh)
            else:
                grads = torch.autograd.grad(scaled, leaves, allow_unused=True)
            grads = [grad_widths(torch.zeros_like(p) if g is None else g, state)
                     if n not in owned else None
                     for n, g, p in zip(names, grads, leaves)]
            unit_done.clear()
            if units is not None:
                grads, unit_done["done"] = units.grads(names, grads)
                units.close()
            if aux is not None:
                aux = torch.utils._pytree.tree_map(
                    lambda x: x.detach() if isinstance(x, torch.Tensor) else x, aux)
            return loss.detach(), grads, aux

        def read_finite(state: TrainState, flags: list) -> tuple[bool, int]:
            """One host read: the step's device finiteness flags and the
            guard's consecutive count."""
            prev = (state.guard_state["consecutive_nan_skips"] if state.guard_state is not None
                    else torch.zeros((), dtype=torch.int32, device=flags[0].device))
            finite, consecutive = torch.stack(
                [torch.stack([f.to(prev.device) for f in flags]).all().to(torch.int32),
                 prev]).tolist()
            return bool(finite), consecutive

        # sum semantics (average_grads=False): the optimizer sees the sum over
        # the data-parallel ranks, the reduction's mean times their number
        grad_scale = 1 if gsk.average_grads else self._dp_world()

        def apply_update(state: TrainState, grads: list, loss, reduced: bool = False):
            """The update from this rank's gradients and loss, or, with
            ``reduced``, from the whole mean gradients and the reduced loss
            of a codec step."""
            plan = self._dp_plan
            if plan is not None:
                if reduced:
                    grads = plan.local_grads(grads)
                else:
                    grads = plan.reduce_grads(grads, done=unit_done.pop("done", None))
                    loss = plan.psum(loss)
                if grad_scale != 1:
                    grads = [g * grad_scale for g in grads]
            loss_scale = state.loss_scale
            flags = []
            metrics = {"loss": loss}
            if loss_scale is not None:
                grads = loss_scale.unscale(grads)
                grads_finite = all_finite(grads)
                if plan is not None:
                    grads_finite = plan.all_finite(grads_finite)
                new_scale = loss_scale.update(grads_finite)
                flags.append(grads_finite)
                metrics.update(grads_finite=grads_finite, loss_scale=new_scale.scale)
                state = state.replace(loss_scale=new_scale)
            gnorm = None
            if not gnorm_on_host:
                gnorm = (plan.global_norm(grads, global_norm) if plan is not None
                         else global_norm(grads))
                if nan_guard:
                    flags.append(_guard.step_finite(loss, gnorm))
            elif nan_guard:
                flags.append(torch.isfinite(loss))
            if flags and nan_guard and self.timeline is not None:
                with self.timeline.phase("guard_sync", step=self.step_count):
                    finite, consecutive = read_finite(state, flags)
            else:
                finite, consecutive = read_finite(state, flags) if flags else (True, 0)
            staged = None
            if offload_opt:
                staged = self._stage_grads(state, grads, chunk_bytes, pipeline, gnorm_on_host)
                if gnorm_on_host:
                    gnorm = staged["gnorm"]
                    if nan_guard and not bool(torch.isfinite(gnorm)):
                        finite = False
            metrics["grad_norm"] = gnorm
            if nan_guard:
                guard_read.update(skipped=not finite, consecutive=0 if finite else consecutive + 1)
                if state.guard_state is not None:
                    new_guard = _guard.update_guard_counters(state.guard_state, finite)
                    metrics = _guard.guard_metrics(metrics, finite, new_guard)
                    state = state.replace(guard_state=new_guard)
                else:
                    metrics["nan_skipped"] = torch.tensor(not finite, device=loss.device)
            if finite:
                schedule = self._lr_schedule(state)
                if schedule is not None:
                    hp = getattr(state.opt_state, "hyperparams", None)
                    if hp is None or "lr" not in hp:
                        raise ValueError(
                            "a prepared schedule writes the optimizer's hyperparams['lr'], "
                            "which only the -sr recipes read; "
                            f"{type(state.opt_state).__name__} keeps the learning rate it "
                            "was built with")
                    hp["lr"].fill_(float(schedule(state.opt_state.count)))
                if offload_opt:
                    new_opt = self._host_update(state, staged, max_grad_norm)
                else:
                    if max_grad_norm is not None:
                        clip = torch.clamp(max_grad_norm / (gnorm + 1e-6), max=1.0)
                        # in each grad's own width: an f32 scalar would
                        # promote a bf16 tree back to f32
                        grads = [g * clip.to(g.dtype) for g in grads]
                    if plan is not None:
                        leaves = plan.opt_params(state.params)
                        # a range's -sr salts take its whole leaf's size
                        kw = ({"numels": plan.numels} if plan.any_sharded
                              and "numels" in inspect.signature(state.tx.update).parameters
                              else {})
                        new_leaves, new_opt = state.tx.update(grads, state.opt_state, leaves,
                                                              **kw)
                        plan.write_back(state.params, new_leaves)
                    else:
                        leaves = list(state.params.values())
                        new_leaves, new_opt = state.tx.update(grads, state.opt_state, leaves)
                        with torch.no_grad():
                            for p, new in zip(leaves, new_leaves):
                                p.copy_(new)
                state = state.replace(opt_state=new_opt)
            # skipped: params, the optimizer's tensors and its count stay as
            # they are.  The fp8 histories tick either way, on the weights
            # the next step reads (JAX :1381-1389)
            if state.fp8_state is not None:
                state = state.replace(fp8_state=_fp8.update_fp8_state(
                    state.fp8_state, state.params, plan=self._dp_plan))
            return state.replace(step=state.step + 1), metrics

        def microbatches(batch):
            def piece(x, i):
                if not torch.is_tensor(x) or x.dim() == 0:
                    return x
                if x.shape[0] % accum_steps:
                    raise ValueError(f"batch dim {x.shape[0]} not divisible by "
                                     f"gradient_accumulation_steps {accum_steps}")
                n = x.shape[0] // accum_steps
                return x[i * n:(i + 1) * n]
            return [{k: piece(v, i) for k, v in batch.items()} for i in range(accum_steps)]

        if codec is not None:
            step_fn = self._codec_step(codec, compute_grads, fetch_params, apply_update)

        elif accum_steps > 1 and mode == "across_steps":

            def step_fn(state: TrainState, batch):
                loss, grads, aux = compute_grads(state, fetch_params(state), batch, state.rng)
                acc = state.grad_accum
                for a, g in zip(acc, grads):
                    a.add_(g)
                metrics = {"loss": loss, "grad_norm": global_norm(grads)}
                if has_aux:
                    metrics["aux"] = aux
                if state.accum_step + 1 < accum_steps:
                    metrics["synced"] = False
                    return state.replace(accum_step=state.accum_step + 1), metrics
                new_state, _ = apply_update(state, [a / accum_steps for a in acc], loss)
                # as in JAX, the boundary update's guard metrics are not
                # reported in this mode, and so not counted
                guard_read.clear()
                for a in acc:
                    a.zero_()
                metrics["synced"] = True
                return new_state.replace(grad_accum=acc, accum_step=0), metrics

        elif accum_steps > 1:

            def step_fn(state: TrainState, batch):
                acc, loss_sum = None, torch.zeros((), device=self.device)
                params = fetch_params(state)
                for mb in microbatches(batch):
                    loss, grads, aux = compute_grads(state, params, mb, state.rng)
                    # the sum runs in f32 whatever the gradients' width
                    if acc is None:
                        acc = [g.float() for g in grads]
                    else:
                        for a, g in zip(acc, grads):
                            a.add_(g.float())
                    loss_sum = loss_sum + loss
                new_state, metrics = apply_update(state, [a / accum_steps for a in acc],
                                                  loss_sum / accum_steps)
                if has_aux:
                    metrics["aux"] = aux   # the last microbatch's
                return new_state, metrics

        else:

            def step_fn(state: TrainState, batch):
                loss, grads, aux = compute_grads(state, fetch_params(state), batch, state.rng)
                new_state, metrics = apply_update(state, grads, loss)
                if has_aux:
                    metrics["aux"] = aux
                return new_state, metrics

        def wrapped(state: TrainState, batch):
            # fault-injection hook: one None check unless a plan is installed
            for ev in _faults.fault_point("step"):
                if ev.kind == "preempt":
                    # a real signal through the installed handler, the path a
                    # cloud preemption notice takes
                    handler = self.install_preemption_handler()
                    os.kill(os.getpid(), handler.signals[0])
                elif ev.kind == "nan_grad":
                    batch = _faults.poison_batch(batch)
                elif ev.kind == "straggler":
                    # a deterministic host stall: this rank reaches the step
                    # boundary late, which the agreed preemption stop absorbs
                    time.sleep(_faults.STRAGGLER_STALL_S)
                elif ev.kind == "rank_loss":
                    # this rank's state is gone, not retryable: the caller
                    # routes the gang through recover()'s ladder
                    raise _faults.RankLostError(
                        f"injected rank loss at step {self.step_count + 1} "
                        f"(process {self.process_index})")
            if not self._in_accumulate:
                self.step_count += 1
                self.goodput.record_step()
                self.gradient_state._set_sync_gradients(
                    mode != "across_steps" or self.step_count % accum_steps == 0)
            guard_read.clear()
            if not donate_state:
                state = _copy_state(state)
            timeline = self.timeline
            if timeline is not None:
                # host time issuing the step (launches are asynchronous)
                with timeline.phase("step_dispatch", step=self.step_count):
                    new_state, metrics = step_fn(state, batch)
            else:
                new_state, metrics = step_fn(state, batch)
            if self.slo_monitor is not None:
                # step_time_s is the cadence between wrapped calls (the first
                # call starts it), which needs no device sync
                now = time.perf_counter()
                prev, self._slo_prev_step_t = self._slo_prev_step_t, now
                if prev is not None:
                    self.slo_monitor.observe("step_time_s", now - prev)
                self.slo_monitor.observe("goodput_frac", self.goodput.goodput_frac())
            if guard_read:
                if guard_read["skipped"]:
                    self.goodput.record_nan_skip()
                _guard.check_abort(guard_read["consecutive"], guard_abort_after)
            rp = self.resilience_plugin
            if rp.peer_snapshot_every > 0 and not self._in_accumulate:
                # buddy-rank host-RAM snapshot (resilience/peer_ckpt.py),
                # armed at the first update so the schema gate sees the real
                # state; its host copy is the only synchronous part
                if self._peer_snapshotter is None:
                    from .resilience.peer_ckpt import PeerSnapshotter

                    self._peer_snapshotter = PeerSnapshotter(
                        new_state, rp.peer_snapshot_every, keep=rp.peer_snapshot_keep,
                        plan=self._dp_plan)
                self._peer_snapshotter.maybe_snapshot(new_state, self.step_count)
            if self._preemption is not None and self._agreed_preemption():
                # stop at the step boundary: the post-step state agrees with
                # the data loader position and the step counters
                self._preemption_exit(new_state)
            return new_state, metrics

        return wrapped

    def _resolve_grad_sync(self, has_aux: bool) -> Optional[dict]:
        """Check ``GradSyncKwargs``' codec knobs against the config (JAX
        :1400-1447, its errors and warning), record :attr:`dcn_sync` and
        return the codec step's plan: ``{"kind": "powersgd", "axes"}``,
        ``{"kind": "hierarchical", "ici_axes", "dcn_codec"}``, or None for
        the flat reduction.  Axes of one rank are left out of the
        collectives."""
        gsk = self.grad_sync_kwargs
        compression = gsk.compression
        if compression not in (None, "powersgd"):
            raise ValueError(f"unknown GradSyncKwargs.compression {compression!r}; "
                             "options: 'powersgd'")
        dcn_codec = gsk.dcn_compression
        if dcn_codec not in (None, "powersgd"):
            raise ValueError(f"unknown GradSyncKwargs.dcn_compression {dcn_codec!r}; "
                             "options: 'powersgd'")
        hier_engage, hier_why = self._resolve_hierarchical()
        if hier_engage and has_aux:
            hier_engage, hier_why = False, "has_aux"
        sizes = self._mesh_sizes()
        dcn_size = sizes.get("dcn", 1)
        if gsk.hierarchical and not hier_engage:
            raise ValueError(
                "GradSyncKwargs.hierarchical=True but the ICI->DCN path cannot "
                f"engage: {hier_why}. The hierarchical reduction is the DDP "
                "comm-hook shape: a dcn mesh axis > 1 plus pure data "
                "parallelism with replicated params (sharding_strategy "
                "NO_SHARD or SHARD_GRAD_OP), no cpu_offload, accumulation of "
                "1, no fp16 scaling, no aux outputs, no comm_dtype/grad_dtype.")
        if dcn_codec and not hier_engage:
            raise ValueError(
                f"GradSyncKwargs.dcn_compression={dcn_codec!r} rides the "
                f"hierarchical ICI->DCN path, which cannot engage: "
                f"{hier_why or 'mesh has no dcn axis'}")
        if not hier_engage and hier_why and dcn_size > 1:
            logger.warning(
                "mesh has a dcn axis (size %d) but the hierarchical gradient "
                "sync cannot engage (%s): falling back to the flat joint-axis "
                "reduction, whose cross-slice hop carries ici_size redundant "
                "full-gradient copies over DCN", dcn_size, hier_why)
        self._dcn_sync = {"enabled": bool(hier_engage), "dcn_size": int(dcn_size),
                          "ici_size": self._ici_size(),
                          "compression": dcn_codec if hier_engage else None,
                          "why_not": None if hier_engage else hier_why}
        live = tuple(a for a in self._compression_axes() if sizes[a] > 1)
        if compression == "powersgd":
            offload_opt, _ = self._offload_flags()
            accum = self.gradient_state.num_steps > 1
            width_knobs = gsk.comm_dtype or gsk.grad_dtype
            fp16 = self.policy.needs_loss_scaling
            bad, params_sharded, strategy = self._ddp_shape()
            if bad or params_sharded or offload_opt or accum or fp16 or has_aux or width_knobs:
                raise ValueError(
                    "compression='powersgd' is the DDP comm-hook analog: pure "
                    "data parallelism with replicated params (sharding_strategy "
                    "NO_SHARD or SHARD_GRAD_OP — FULL_SHARD/HYBRID would "
                    "all-gather every param each step inside the shard_map), "
                    "no cpu_offload, accumulation of 1, no "
                    "fp16 scaling, no aux outputs, and no comm_dtype/"
                    "grad_dtype (the factor psums are fp32 — a width knob "
                    "would be silently ignored). Offending config: "
                    f"{bad or ''}"
                    f"{' params-sharded(' + str(strategy) + ')' if params_sharded else ''}"
                    f"{' offload' if offload_opt else ''}"
                    f"{' accum>1' if accum else ''}"
                    f"{' fp16' if fp16 else ''}"
                    f"{' has_aux' if has_aux else ''}"
                    f"{' comm_dtype/grad_dtype' if width_knobs else ''}")
            return {"kind": "powersgd", "axes": live}
        if hier_engage:
            return {"kind": "hierarchical", "ici_axes": tuple(a for a in live if a != "dcn"),
                    "dcn_codec": dcn_codec}
        return None

    def _codec_step(self, codec: dict, compute_grads, fetch_params, apply_update):
        """The step of a codec plan from :meth:`_resolve_grad_sync`: each
        rank's f32 gradients through the flat PowerSGD codec (JAX
        :1448-1536) or the hierarchical sync (JAX :1538-1600), then the
        update on the mean.  As in JAX's ``_psgd_local`` / ``_hier_grads``,
        the codec is fed the gradient of each rank's own mean loss (no
        token weighting: the reduced gradient is the mean of the ranks'
        means, whatever each rank's count of valid tokens), and the
        reported loss is the ``pmean`` of the ranks' own losses: over the
        codec's axes for the flat codec, inside the node and then across
        ``dcn`` for the hierarchical step, the gradients' two-stage order.
        The dense step keeps its global token mean (:meth:`prepare_train_step`)."""
        from .parallel import collectives

        rank = self.grad_sync_kwargs.rank
        mesh = self.mesh if self._parallel else None

        def rank_grads(state: TrainState, batch):
            loss, grads, _ = compute_grads(state, fetch_params(state), batch, state.rng,
                                           weighted=False)
            return loss, dict(zip(state.params, grads))

        if codec["kind"] == "powersgd":
            from .parallel.powersgd import compress_decompress

            axes = codec["axes"]

            def step_fn(state: TrainState, batch):
                loss, grads = rank_grads(state, batch)
                qs, errs = state.comm_state
                g_hat, new_qs, new_errs = compress_decompress(grads, qs, errs, axes, rank, mesh)
                if axes:
                    loss = collectives.pmean(loss, axes, mesh)
                return apply_update(state.replace(comm_state=(new_qs, new_errs)),
                                    list(g_hat.values()), loss, reduced=True)

            return step_fn

        from .parallel.hierarchical import hierarchical_sync

        ici_axes, dcn_codec = codec["ici_axes"], codec["dcn_codec"]

        def step_fn(state: TrainState, batch):
            loss, grads = rank_grads(state, batch)
            qs, errs = state.comm_state if dcn_codec else (None, None)
            g_hat, new_qs, new_errs = hierarchical_sync(grads, ici_axes, "dcn", qs=qs,
                                                        errs=errs, rank=rank, mesh=mesh)
            # the loss averaged in the gradients' two-stage order, inside the
            # node first: the same value whatever the process count
            if ici_axes:
                loss = collectives.pmean(loss, ici_axes, mesh)
            loss = collectives.pmean(loss, "dcn", mesh)
            if dcn_codec:
                state = state.replace(comm_state=(new_qs, new_errs))
            return apply_update(state, list(g_hat.values()), loss, reduced=True)

        return step_fn

    def reset_step_cadence(self) -> None:
        """Re-anchor the SLO monitor's ``step_time_s`` cadence after a pause
        that is not a step (an eval loop, a stall): the next step starts a
        fresh gap instead of being observed as one long step."""
        self._slo_prev_step_t = None

    def prepare_eval_step(self, eval_fn: Callable) -> Callable:
        """``step(params, batch) -> eval_fn(params, batch)`` with the
        policy's compute cast applied to the params (JAX :1968), under
        ``fp8_autocast`` when ``mixed_precision="fp8"``, with no autograd
        graph; host-offloaded params are fetched to the device first."""
        policy = self.policy
        use_fp8 = self.mixed_precision == "fp8"

        def step(params, batch):
            params = policy.cast_to_compute(self.device_params(params))
            with torch.no_grad(), (fp8_autocast() if use_fp8 else contextlib.nullcontext()):
                return eval_fn(params, batch)

        return step

    # -- the offloaded update --------------------------------------------

    def _stage_grads(self, state: TrainState, grads: list, chunk_bytes: Optional[int],
                     pipeline: bool, norm_on_host: bool) -> dict:
        """Queue the gradients' device-to-host copies into reused pinned
        buffers (``ops/streaming.stage_put``): all at once, one stage per
        group (pipelined: every group queued now, so group k + 1 crosses
        while group k updates; serial: each group queued when its update
        starts, by :meth:`_host_update`).  With ``norm_on_host`` every
        gradient is on the host before the global norm is taken there."""
        buf = self._offload_buffers
        n = len(grads)
        plan = self._dp_plan
        groups = (_streaming.chunk_groups(self._global_leaves(state), chunk_bytes) if chunk_bytes
                  else [list(range(n))])
        cuda = grads[0].device.type == "cuda"
        log = self.offload_log
        log.update(d2h_bytes=sum(g.numel() * g.element_size() for g in grads), groups=len(groups),
                   pipeline=pipeline, host_wait_ms=0.0, host_update_ms=0.0)
        if cuda:
            # the backward's end: the host's wait on it is compute, not copy
            done = torch.cuda.Event()
            done.record()
            t0 = time.perf_counter()
            done.synchronize()
            log["backward_wait_ms"] = (time.perf_counter() - t0) * 1e3
        bulk = norm_on_host or len(groups) == 1
        staged = {"groups": groups, "stages": [None] * len(groups), "grads": grads}
        if bulk:
            whole = _streaming.stage_put(grads, buf["grads"].setdefault("all", []))
            staged["whole"] = whole
        elif pipeline:
            for gi, idxs in enumerate(groups):
                staged["stages"][gi] = _streaming.stage_put(
                    [grads[i] for i in idxs], buf["grads"].setdefault(gi, []))
        if norm_on_host:
            t0 = time.perf_counter()
            host = whole.wait_host()
            log["host_wait_ms"] += (time.perf_counter() - t0) * 1e3
            host = [g.float() for g in host]
            # under a plan the ranks' squares summed (padding lanes are zero)
            staged["gnorm"] = (plan.global_norm(host, global_norm) if plan is not None
                               else global_norm(host))
        return staged

    def _global_leaves(self, state: TrainState):
        """The train state's leaves at their global shapes (the chunk groups
        are a numerics contract: the -sr salts are group-relative leaf
        indices, so a rank's ranges group as JAX's global leaves do)."""
        plan = self._dp_plan
        if plan is None:
            return state.params
        return [torch.empty(lay.whole_shape, device="meta") for lay in plan.layouts.values()]

    def _host_update(self, state: TrainState, staged: dict, max_grad_norm: Optional[float]):
        """The optimizer update on the host, group by group over the staged
        gradients (widened to f32 there): each group's slice of the
        optimizer state (``slice_congruent``), its own leaf indices from 0
        (the SR salts of JAX's chunked update), the new weights and state
        written into the host tensors in place (the page-locked buffers
        stay), then the compute copies' or the card's params refreshed.
        Returns the merged optimizer state."""
        buf, log = self._offload_buffers, self.offload_log
        _, offload_params = self._offload_flags()
        plan = self._dp_plan
        names = list(state.params)
        n = len(names)
        groups = staged["groups"]
        if offload_params:
            host_p = (plan.opt_params(state.params) if plan is not None
                      else list(state.params.values()))
        else:
            dev_p = (plan.opt_params(state.params) if plan is not None
                     else list(state.params.values()))
            host_p = _streaming.stage_put(dev_p, buf["params"]).wait_host()
            log["d2h_bytes"] += sum(p.numel() * p.element_size() for p in host_p)
        # a range's -sr salts take its whole leaf's size
        numels = (plan.numels if plan is not None and plan.any_sharded
                  and "numels" in inspect.signature(state.tx.update).parameters else None)
        clip = None
        if max_grad_norm is not None:
            clip = torch.clamp(max_grad_norm / (staged["gnorm"] + 1e-6), max=1.0)
        whole = staged.get("whole")
        self_widening = isinstance(getattr(state.opt_state, "hyperparams", None), dict)

        def update_groups() -> list:
            """Every group's update, in order."""
            outs = []
            for gi, idxs in enumerate(groups):
                t0 = time.perf_counter()
                if whole is not None:
                    host_g = whole.wait_host()
                    g = [host_g[i] for i in idxs]
                else:
                    if staged["stages"][gi] is None:
                        staged["stages"][gi] = _streaming.stage_put(
                            [staged["grads"][i] for i in idxs],
                            buf["grads"].setdefault(gi, []))
                    g = staged["stages"][gi].wait_host()
                t1 = time.perf_counter()
                # the -sr / -sr8 recipes (states with hyperparameters) widen
                # each gradient themselves, slice by slice; the others take f32
                g32 = g if clip is None and self_widening else [x.float() for x in g]
                if clip is not None:
                    g32 = [x * clip for x in g32]
                sub = _streaming.slice_congruent(state.opt_state, n, idxs)
                p_sub = [host_p[i] for i in idxs]
                kw = {"numels": [numels[i] for i in idxs]} if numels is not None else {}
                new_p, new_sub = state.tx.update(g32, sub, p_sub, **kw)
                with torch.no_grad():
                    for p, x in zip(p_sub, new_p):
                        p.copy_(x)
                outs.append(new_sub)
                log["host_wait_ms"] += (t1 - t0) * 1e3
                log["host_update_ms"] += (time.perf_counter() - t1) * 1e3
            return outs

        # on a virtual world the ranks' host work runs on the caller's thread
        # (VirtualMesh.on_caller: a rank thread's CPU ops run several times
        # slower)
        outs = (plan.mesh.on_caller(update_groups) if plan is not None and plan.virtual
                else update_groups())
        stages = [whole] if whole is not None else staged["stages"]
        log["d2h_ms"] = sum(st.copy_ms() for st in stages)
        if log["d2h_ms"] > 0:
            # the share of the copy time the host did not spend waiting
            log["d2h_hidden"] = max(0.0, 1.0 - log["host_wait_ms"] / log["d2h_ms"])
        merged = _streaming.merge_congruent(state.opt_state, outs, n, groups)
        # the new state's values into the old (page-locked) tensors
        fields = []
        with torch.no_grad():
            for old, new in zip(state.opt_state, merged):
                if isinstance(old, list) and len(old) == n:
                    for o, x in zip(old, new):
                        o.copy_(x)
                    fields.append(old)
                else:
                    fields.append(new)
        if plan is not None:
            # the new ranges into the stored params: in place where a range
            # is a view of its stored range, else gathered over the axes the
            # state splits finer (on the card: the H2D copy first)
            if offload_params:
                plan.write_back(state.params, host_p)
            else:
                dev = [h.to(self.device, non_blocking=True) for h in host_p]
                log["h2d_bytes"] = log.get("h2d_bytes", 0) + sum(
                    p.numel() * p.element_size() for p in dev)
                plan.write_back(state.params, dev)
        elif not offload_params:
            with torch.no_grad():
                for p, h in zip(state.params.values(), host_p):
                    if p is not h:
                        p.copy_(h, non_blocking=True)
            log["h2d_bytes"] = log.get("h2d_bytes", 0) + sum(
                p.numel() * p.element_size() for p in host_p)
        return type(state.opt_state)(*fields)

    # -- the reference's loop surface -----------------------------------

    def backward(self, loss=None, **kwargs):
        raise RuntimeError(
            "The prepared train step computes the gradients: define "
            "`loss_fn(params, batch)` and use `accelerator.prepare_train_step(loss_fn)`; the "
            "returned step runs the gradients, accumulation, clipping and the optimizer update."
        )

    @contextlib.contextmanager
    def accumulate(self, *models):
        """Accumulation bookkeeping (JAX ``accumulate``): counts the step
        (a step run inside the context leaves the count to it) and sets
        ``sync_gradients`` as the prepared step would."""
        self.step_count += 1
        self.goodput.record_step()
        mode = self.gradient_state.plugin.mode
        self.gradient_state._set_sync_gradients(
            mode != "across_steps" or self.step_count % self.gradient_state.num_steps == 0)
        self._in_accumulate = True
        try:
            yield
        finally:
            self._in_accumulate = False

    def clip_grad_norm_(self, grads, max_norm: float, norm_type: float = 2.0):
        """Global-norm clip of a list or dict of gradients; returns
        ``(clipped, norm)``.  Inside a prepared step pass ``max_grad_norm``."""
        if norm_type != 2.0:
            raise NotImplementedError("only L2 global-norm clipping is supported")
        gnorm = global_norm(grads)
        clip = torch.clamp(max_norm / (gnorm + 1e-6), max=1.0)
        if isinstance(grads, dict):
            return {k: g * clip for k, g in grads.items()}, gnorm
        return [g * clip for g in grads], gnorm

    def clip_grad_value_(self, grads, clip_value: float):
        """Each gradient clamped to ``[-clip_value, clip_value]`` (a list or
        dict, returned; JAX :2041)."""
        if isinstance(grads, dict):
            return {k: g.clamp(-clip_value, clip_value) for k, g in grads.items()}
        return [g.clamp(-clip_value, clip_value) for g in grads]

    def unscale_gradients(self, optimizer=None):
        """The prepared step unscales fp16 gradients itself: nothing to do
        (JAX :2094)."""
        return None

    def no_sync(self, model=None):
        """One process reduces nothing: an inert context (JAX :2027)."""
        return contextlib.nullcontext()

    def unwrap_model(self, model, keep_fp32_wrapper: bool = True):
        """The module inside a pipeline's :class:`~.parallel.pipeline_parallel.
        PipelinedModel`, holding the pipeline's trained tensors (``utils.
        other.extract_model_from_parallel``: every rank calls it), and
        inside ``torch.compile``'s and the data-parallel wrappers
        (``_orig_mod`` / ``module``); the port wraps no module itself
        otherwise, so a prepared model comes back as it is (JAX :2086)."""
        from .utils.other import extract_model_from_parallel

        model = extract_model_from_parallel(model, keep_fp32_wrapper)
        while True:
            inner = getattr(model, "_orig_mod", None)
            if inner is None and isinstance(model, (nn.DataParallel,
                                                    nn.parallel.DistributedDataParallel)):
                inner = model.module
            if inner is None:
                return model
            model = inner

    # -- the NaN trigger (JAX :2099) ---------------------------------------

    def set_trigger(self):
        """Raise the flag :meth:`check_trigger` reads."""
        self.flag_tensor = torch.ones((), dtype=torch.int32, device=self.device)

    def check_trigger(self) -> bool:
        """True on every process once any process called
        :meth:`set_trigger` (the flags summed across the world), which it
        resets."""
        flag = (self.flag_tensor if self.flag_tensor is not None
                else torch.zeros((), dtype=torch.int32, device=self.device))
        if int(_ops.reduce(flag, reduction="sum")) >= 1:
            self.flag_tensor = None
            return True
        return False

    # -- contexts ----------------------------------------------------------

    @contextlib.contextmanager
    def autocast(self, autocast_handler: Optional[AutocastKwargs] = None):
        """The compute-dtype context (JAX :2113).  The prepared train and
        eval steps apply the policy themselves, so nothing changes inside
        them: a step's outputs are bitwise the same inside and outside."""
        yield

    @contextlib.contextmanager
    def profile(self, profile_handler: Optional[ProfileKwargs] = None):
        """A step-scheduled ``torch.profiler`` window (JAX :2185): yields a
        :class:`~.utils.profiler.CUDAProfiler`; call ``profiler.step()``
        once a training step and the ``active`` steps of each wait /
        warmup / active cycle are traced (without ``step()``, the whole
        block)::

            with acc.profile(ProfileKwargs(wait=1, warmup=1, active=2,
                                           output_trace_dir=d)) as p:
                for batch in loader:
                    state, metrics = step(state, batch)
                    p.step()
        """
        from .utils.profiler import CUDAProfiler

        profiler = CUDAProfiler(profile_handler or self.profile_kwargs)
        profiler._enter()
        try:
            yield profiler
        finally:
            profiler._exit()

    # -- lifecycle ---------------------------------------------------------

    def free_memory(self, *objects):
        """Drop the accelerator's references to what it prepared, collect
        and give the card's cached blocks back (JAX :2213).  Returns
        ``objects``."""
        import gc

        self._dataloaders = []
        self._optimizers = []
        self._schedulers = []
        self._models = []
        self.step_count = 0
        self._offload_buffers = {}
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return objects

    def clear(self, *objects):
        return self.free_memory(*objects)

    def init_params(self, module: nn.Module, rng=None, *sample_args, **sample_kwargs) -> dict:
        """The module's parameters on this accelerator's device, as the
        name -> tensor dict :meth:`create_train_state` takes (JAX :717).  A
        module built under ``big_modeling.init_empty_weights`` (on
        ``meta``) is materialised one tensor at a time straight onto the
        device (``init_params_leafwise``: normal(0, 0.02) matrices, ones
        for norm scales, zeros elsewhere); a built one is moved there.
        ``rng`` and the sample inputs are accepted for the JAX signature:
        a torch module knows its shapes."""
        if any(p.device.type == "meta" for p in module.parameters()):
            from .big_modeling import init_params_leafwise

            init_params_leafwise(module, device=self.device)
        else:
            module.to(self.device)
        return {n: p.detach() for n, p in module.named_parameters()}

    # -- trackers (JAX :2475-2495; backends in tracking.py) ---------------

    def init_trackers(self, project_name: str, config: Optional[dict] = None,
                      init_kwargs: Optional[dict] = None):
        """Build the trackers named by ``log_with`` under the project's
        logging directory, storing ``config`` in each."""
        from . import tracking

        init_kwargs = init_kwargs or {}
        self.trackers = []
        for name in self.log_with:
            tracker = tracking.resolve_tracker(name, project_name,
                                               self.project_configuration.logging_dir,
                                               **init_kwargs.get(str(name), {}))
            if tracker is not None:
                self.trackers.append(tracker)
        if config is not None:
            for tracker in self.trackers:
                tracker.store_init_configuration(config)

    def get_tracker(self, name: str, unwrap: bool = False):
        for tracker in self.trackers:
            if tracker.name == name:
                return tracker.tracker if unwrap else tracker
        raise ValueError(f"Tracker {name} not initialized")

    def log(self, values: dict, step: Optional[int] = None, log_kwargs: Optional[dict] = None):
        log_kwargs = log_kwargs or {}
        for tracker in self.trackers:
            tracker.log(values, step=step, **log_kwargs.get(tracker.name, {}))

    def gather_for_metrics(self, input_data, use_gather_object: bool = False):
        """Gather evaluation outputs across processes (JAX :2049): tensor
        trees with :meth:`gather`, anything else (or with
        ``use_gather_object``) with ``gather_object``; then drop the
        duplicate tail samples a padded last batch added: on the data
        loader's last batch only the ``remainder`` first rows are kept."""
        gs = self.gradient_state
        leaves = _ops._leaves(input_data)
        tensors = not use_gather_object and all(_ops.is_array_like(x) for x in leaves)
        data = _ops.gather(input_data) if tensors else _ops.gather_object(input_data)
        if not (gs.end_of_dataloader and gs.remainder > 0):
            return data

        def drop(x):
            return x[: gs.remainder] if x.ndim else x

        try:
            if tensors:
                return _ops.recursively_apply(drop, data)
            return data[: gs.remainder]
        except (TypeError, IndexError) as e:
            logger.warning("gather_for_metrics could not drop the %d duplicate tail samples "
                           "(%s); returning the full data.", gs.remainder, e)
            return data

    # -- checkpointing ---------------------------------------------------

    def register_for_checkpointing(self, *objects):
        """Track stateful objects (with ``state_dict`` / ``load_state_dict``)
        for :meth:`save_state` / :meth:`load_state`."""
        invalid = [o for o in objects
                   if not (hasattr(o, "state_dict") and hasattr(o, "load_state_dict"))]
        if invalid:
            raise ValueError(f"Objects {invalid} lack state_dict/load_state_dict")
        self._custom_objects.extend(objects)

    def register_save_state_pre_hook(self, hook: Callable):
        import uuid

        key = uuid.uuid4().hex
        self._save_model_state_pre_hooks[key] = hook
        return key

    def register_load_state_pre_hook(self, hook: Callable):
        import uuid

        key = uuid.uuid4().hex
        self._load_model_state_pre_hooks[key] = hook
        return key

    def save_state(self, output_dir: Optional[str] = None, train_state=None, **save_kwargs):
        """Checkpoint everything (``checkpointing.save_accelerator_state``):
        the train state, data loader positions, RNG streams, schedulers,
        goodput and custom objects; automatic naming and retention under
        ``ProjectConfiguration``; ``async_save=True`` returns once the
        train state is snapshotted.  In a world of several processes the save
        is collective (every rank calls it): under a parallelism config each
        rank writes its own ranges of the train state (sharded, tp or ep
        split, or replicated: the first rank holding each range writes it)
        and rank 0 one index of the global layout; each rank writes its RNG
        streams; rank 0 publishes once every rank's files are written, and
        every rank confirms the publish (after an ``async_save``, at the
        next save or load, ``wait_for_checkpoint`` or ``end_training``).
        :meth:`load_state` restores onto any plan and process count."""
        from .checkpointing import save_accelerator_state

        return save_accelerator_state(self, output_dir, train_state=train_state, **save_kwargs)

    def load_state(self, input_dir: Optional[str] = None, train_state=None, **load_kwargs):
        from .checkpointing import load_accelerator_state

        return load_accelerator_state(self, input_dir, train_state=train_state, **load_kwargs)

    def wait_for_checkpoint(self):
        """Block until an in-flight ``save_state(async_save=True)`` write has
        committed and is published."""
        from .checkpointing import wait_for_pending_checkpoint

        wait_for_pending_checkpoint(self)

    def end_training(self):
        """Flush a pending async save and release the writer thread; write
        the timeline's Chrome trace to ``<export_dir>/train_timeline.json``
        when the plugin names a directory; finish the trackers."""
        from .checkpointing import close_async_checkpointer

        try:
            close_async_checkpointer(self)
        finally:
            # a failed flush must not also drop the trackers' metrics
            export_dir = self.telemetry_plugin.export_dir
            if self.timeline is not None and export_dir and self.is_main_process:
                try:
                    os.makedirs(export_dir, exist_ok=True)
                    self.timeline.write_chrome_trace(
                        os.path.join(export_dir, "train_timeline.json"))
                except OSError as e:
                    logger.warning("timeline export to %s failed: %s", export_dir, e)
            for tracker in self.trackers:
                tracker.finish()

    def save_model(self, train_state_or_params, save_directory: str,
                   max_shard_size: str = "10GB", safe_serialization: bool = True):
        from .checkpointing import save_model

        return save_model(self, train_state_or_params, save_directory, max_shard_size,
                          safe_serialization)

    def skip_first_batches(self, dataloader, num_batches: int = 0):
        return skip_first_batches(dataloader, num_batches=num_batches)

    # -- preemption / auto-resume -----------------------------------------

    def install_preemption_handler(self, signals=None):
        """Arm graceful-stop handling: the listed signals (default the
        plugin's, ``SIGTERM``) set a flag, and the prepared train step exits
        at the next step boundary through :meth:`_preemption_exit`
        (emergency checkpoint + ``SystemExit(75)``).  Idempotent."""
        if self._preemption is None:
            from .resilience.preemption import PreemptionHandler

            self._preemption = PreemptionHandler(
                signals or self.resilience_plugin.preemption_signals).install()
        return self._preemption

    def uninstall_preemption_handler(self):
        """Restore the signal handlers in place before
        :meth:`install_preemption_handler`."""
        if self._preemption is not None:
            self._preemption.uninstall()
            self._preemption = None

    @property
    def preemption_requested(self) -> bool:
        return self._preemption is not None and self._preemption.requested

    def _agreed_preemption(self) -> bool:
        """The graceful stop agreed across the processes: True when ANY
        rank's handler saw the signal, so the whole gang stops at the same
        step boundary (the emergency checkpoint is collective).  An int32
        all-gather, only in a world of several processes, paced by
        ``ResiliencePlugin.preemption_check_every``: whether to enter it
        depends only on the lockstep ``step_count``, never on the local
        flag, or ranks would disagree on entering the collective."""
        requested = self._preemption.requested
        if self.num_processes <= 1:
            return requested
        every = max(1, int(self.resilience_plugin.preemption_check_every))
        if self.step_count % every != 0:
            return False
        flag = torch.tensor([int(bool(requested))], dtype=torch.int32, device=self.device)
        return bool(_ops.gather(flag).sum() > 0)

    def _preemption_exit(self, train_state=None):
        """The graceful-stop tail: drain the in-flight async save, write an
        emergency checkpoint of the boundary state through the verified
        path, and exit with the resume code — which stays the resume code
        when the drain or the save fails."""
        rp = self.resilience_plugin
        logger.warning("preemption requested: stopping at step boundary (step_count=%d)",
                       self.step_count)
        # counted before the emergency save, so the persisted counters
        # include the event that wrote them
        self.goodput.record_preemption()
        try:
            self.wait_for_checkpoint()
            if rp.emergency_checkpoint and train_state is not None:
                try:
                    ckpt = self.save_state(train_state=train_state)
                    logger.warning("emergency checkpoint written to %s", ckpt)
                except ValueError as e:
                    # no project_dir / output_dir: nothing to save into
                    logger.warning("no emergency checkpoint written: %s", e)
        except Exception as e:
            logger.error(
                "emergency checkpoint failed (%s: %s); exiting with the resume code "
                "anyway — resume will fall back to the newest valid periodic checkpoint",
                type(e).__name__, e,
            )
        raise SystemExit(rp.resume_exit_code)

    @property
    def resume_requested(self) -> bool:
        """True when the process was launched to resume
        (``ACCELERATE_AUTO_RESUME``): call :meth:`maybe_resume` before the
        first step."""
        return parse_flag_from_env("ACCELERATE_AUTO_RESUME")

    def maybe_resume(self, train_state=None, **load_kwargs):
        """Auto-resume: restore the newest *valid* checkpoint under the
        project dir, or return None when none exists (a fresh start).
        Restores RNG streams, data loader positions and step counters — and
        the train state when a ``train_state`` template is given (returned
        restored).  Counts the restart in :attr:`goodput`."""
        from .checkpointing import list_checkpoints

        if not list_checkpoints(self.project_dir or "."):
            return None
        restored = self.load_state(None, train_state=train_state, **load_kwargs)
        self.goodput.record_restart()
        logger.warning("resumed from checkpoint at step_count=%d (restart #%d)",
                       self.step_count, self.goodput.restarts)
        return restored

    @property
    def peer_snapshotter(self):
        """The buddy-rank host-RAM snapshotter, or None until the prepared
        step arms it (``ResiliencePlugin.peer_snapshot_every > 0``, after
        its first update)."""
        return self._peer_snapshotter

    def recover(self, train_state=None, *, lost_local: bool = False, **load_kwargs):
        """Walk the recovery ladder after a fault (``RankLostError``, a
        restarted rank, a torn snapshot): the newest consistent **peer-RAM**
        wave, else the newest **verified disk** checkpoint, else a **fresh
        start**.

        Collective in a world of several processes: every rank calls it
        together.  ``lost_local=True`` marks THIS rank's own state as gone
        (the ``rank_loss`` fault): its own waves are dropped first, so the
        buddy's copy is what restores it.

        Returns ``(train_state_or_None, report)``, ``report`` holding
        ``restore_path`` (``"peer"`` / ``"disk"`` / ``"fresh"``),
        ``restored_step``, ``steps_recomputed``, ``peer_snapshot_bytes``
        and ``restore_time_s``; records the measured
        ``recovery.restore_time_s`` twin."""
        from .telemetry import twin_registry

        t0 = time.perf_counter()
        prev_step = self.step_count
        report = {"restore_path": "fresh", "restored_step": 0, "steps_recomputed": 0,
                  "peer_snapshot_bytes": 0, "restore_time_s": 0.0}
        restored = None
        snap = self._peer_snapshotter
        if snap is not None and train_state is not None:
            if lost_local:
                snap.forget_local()
            got = snap.recover(train_state)
            if got is not None:
                restored, step = got
                self.step_count = int(step)
                report["restore_path"] = "peer"
                report["restored_step"] = int(step)
                report["peer_snapshot_bytes"] = snap.schema["snapshot_bytes"]
                self.goodput.record_restart(steps_recomputed=max(0, prev_step - int(step)))
        if restored is None:
            # the disk rung: the newest VERIFIED checkpoint (corrupt ones
            # fall through inside load_state's fallback scan)
            try:
                restored = self.maybe_resume(train_state=train_state, **load_kwargs)
            except Exception as e:  # corrupt beyond the fallback: fresh
                logger.error("disk recovery failed (%s: %s); starting fresh",
                             type(e).__name__, e)
                restored = None
            if restored is not None or self.step_count != prev_step:
                report["restore_path"] = "disk"
                report["restored_step"] = int(self.step_count)
                self.goodput.steps_recomputed += max(0, prev_step - self.step_count)
            else:
                self.step_count = 0
                self.goodput.record_restart(steps_recomputed=prev_step)
        report["steps_recomputed"] = max(0, prev_step - report["restored_step"])
        report["restore_time_s"] = round(time.perf_counter() - t0, 6)
        twin_registry().record_measured("recovery.restore_time_s", report["restore_time_s"],
                                        source="Accelerator.recover")
        logger.warning("recovered via %s rung at step %d (replaying %d steps, %.3fs)",
                       report["restore_path"], report["restored_step"],
                       report["steps_recomputed"], report["restore_time_s"])
        return restored, report
