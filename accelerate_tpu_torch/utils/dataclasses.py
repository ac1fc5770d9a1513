"""Plugin dataclasses of the port (mirrors ``accelerate_tpu/utils/
dataclasses.py``: ``GradSyncKwargs`` :155, ``GradientAccumulationPlugin``
:269, ``FullyShardedDataParallelPlugin`` :292, ``ResiliencePlugin`` :400,
``ServingPlugin`` :487, ``LoraPlugin`` :720, ``FP8RecipeKwargs`` :970,
``DataLoaderConfiguration`` :1008, ``ProjectConfiguration`` :1023,
``DistributedType`` :50, ``LoggerType`` :106, ``AutocastKwargs`` :147,
``InitProcessGroupKwargs`` :201, ``ProfileKwargs`` :212,
``TelemetryPlugin`` :855)."""

from __future__ import annotations

import enum
import os
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Callable, Optional


class BaseEnum(str, enum.Enum):
    """A string enum whose members print as their value."""

    def __str__(self):
        return self.value

    @classmethod
    def list(cls):
        return list(map(str, cls))


class DistributedType(BaseEnum):
    """The process / device topology of the run (JAX :50).  One process
    drives one card: a world of one process is ``NO``, a world of several
    ``MULTI_HOST`` (the JAX package's name for a multi-process world)."""

    NO = "NO"
    MULTI_DEVICE = "MULTI_DEVICE"
    MULTI_HOST = "MULTI_HOST"


class ShardingStrategy(BaseEnum):
    """How parameters and optimizer state are laid out across ``dp_shard``
    (JAX :72): NO_SHARD (DDP), SHARD_GRAD_OP (ZeRO-2: the optimizer state
    only), FULL_SHARD (ZeRO-3), HYBRID_SHARD (shard within a replica,
    replicate across ``dp_replicate``)."""

    NO_SHARD = "NO_SHARD"
    SHARD_GRAD_OP = "SHARD_GRAD_OP"
    FULL_SHARD = "FULL_SHARD"
    HYBRID_SHARD = "HYBRID_SHARD"


class DistributedOperationException(Exception):
    """A collective whose operands disagree across processes (JAX :66),
    raised under ``ACCELERATE_DEBUG_MODE`` instead of a hang."""


class LoggerType(BaseEnum):
    """The experiment trackers ``tracking.py`` knows by name (JAX :106)."""

    ALL = "all"
    TENSORBOARD = "tensorboard"
    WANDB = "wandb"
    COMETML = "comet_ml"
    MLFLOW = "mlflow"
    AIM = "aim"
    CLEARML = "clearml"
    DVCLIVE = "dvclive"
    SWANLAB = "swanlab"
    TRACKIO = "trackio"


@dataclass
class AutocastKwargs:
    """Compute-dtype context knobs (JAX :147).  The prepared train and eval
    steps apply the accelerator's policy themselves, so
    ``Accelerator.autocast`` changes nothing inside them, and neither knob
    can be turned off: ``enabled=False`` or ``cache_enabled=False`` raises
    (choose ``mixed_precision="no"`` for f32 compute)."""

    enabled: bool = True
    cache_enabled: bool = True

    def __post_init__(self):
        if not (self.enabled and self.cache_enabled):
            raise ValueError(
                "AutocastKwargs: the prepared steps apply the mixed-precision policy "
                "themselves, so autocast cannot be disabled (enabled / cache_enabled "
                "must stay True); pass mixed_precision='no' for f32 compute")


@dataclass
class InitProcessGroupKwargs:
    """Process-group knobs (JAX :201): ``coordinator_address`` (``host:port``
    or a ``file://`` / ``tcp://`` init method), the world's size and this
    process's rank, and the timeout.  ``state.PartialState`` initialises the
    ``torch.distributed`` group from them; several processes without an
    address raise."""

    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    timeout: timedelta = field(default_factory=lambda: timedelta(seconds=1800))
    initialization_timeout: Optional[int] = None


@dataclass
class ProfileKwargs:
    """A step-scheduled ``torch.profiler`` window (JAX :212; engine
    ``utils/profiler.py``).  ``wait`` / ``warmup`` / ``active`` are the
    steps of one cycle, counted by ``profiler.step()``: each cycle traces
    steps ``[wait + warmup, wait + warmup + active)``; ``repeat`` bounds
    the cycles (0: until the block ends; cycle ``i > 0`` writes under
    ``cycle_<i>/``).  With no schedule (``wait``, ``warmup`` and
    ``repeat`` 0, ``active`` None) the whole ``with`` block is one window,
    ``step()`` or not.  ``profile_memory``: the card's allocator counters
    at the window's edges in ``profiler.summary['memory']``;
    ``with_flops``: the FLOPs ``torch.profiler`` counts in the window, in
    ``summary['flops']``.  ``on_trace_ready(trace_dir)`` runs at the end
    of each cycle that wrote a trace.  ``create_perfetto_link=True``
    raises: ``torch.profiler`` serves no Perfetto link (open
    ``trace.json`` in the Perfetto UI instead)."""

    wait: int = 0
    warmup: int = 0
    active: Optional[int] = None
    repeat: int = 0
    output_trace_dir: Optional[str] = None
    with_flops: bool = False
    profile_memory: bool = False
    create_perfetto_link: bool = False
    on_trace_ready: Optional[Callable] = None

    def __post_init__(self):
        if self.create_perfetto_link:
            raise ValueError(
                "ProfileKwargs.create_perfetto_link: torch.profiler serves no Perfetto "
                "link; open the window's trace.json in the Perfetto UI instead")
        if self.active is not None and self.active < 1:
            raise ValueError(
                f"ProfileKwargs.active must be >= 1 when set (got {self.active}); "
                "leave it at None for a single continuous trace window"
            )

    def has_schedule(self) -> bool:
        return bool(self.wait or self.warmup or self.repeat or self.active is not None)


@dataclass
class GradSyncKwargs:
    """How gradients are formed and reduced (the JAX package's fields).
    ``grad_dtype="bf16"`` differentiates with respect to the compute-width
    copy of the params, so every gradient is born bf16.  ``comm_dtype``
    casts the gradients before the data-parallel reduction;
    ``average_grads=False`` hands the optimizer the sum over the
    data-parallel ranks in place of their mean.  ``compression="powersgd"``
    runs the DDP PowerSGD step at ``rank`` (``parallel/powersgd.py``);
    ``hierarchical`` (None: wherever it can) reduces over a ``dcn`` axis
    with the intra-node / inter-node schedule, whose inter-node hop
    ``dcn_compression="powersgd"`` compresses
    (``parallel/hierarchical.py``)."""

    comm_dtype: Optional[str] = None     # None | "bf16" | "fp16"
    average_grads: bool = True
    grad_dtype: Optional[str] = None     # None | "bf16"
    compression: Optional[str] = None    # None | "powersgd"
    rank: int = 4
    hierarchical: Optional[bool] = None  # True requires a dcn axis
    dcn_compression: Optional[str] = None  # None | "powersgd"


@dataclass
class GradientAccumulationPlugin:
    """Gradient accumulation: ``in_step`` splits each batch into
    ``num_steps`` microbatches inside one train step and sums their
    gradients in f32.  ``across_steps`` (the sum carried between calls)
    carries the f32 sum in the train state between calls and updates on
    every ``num_steps``-th call, as in JAX."""

    num_steps: int = 1
    adjust_scheduler: bool = True
    sync_with_dataloader: bool = True
    sync_each_batch: bool = False
    mode: str = "in_step"  # "in_step" | "across_steps"

    def __post_init__(self):
        if self.mode not in ("in_step", "across_steps"):
            raise ValueError(f"invalid gradient accumulation mode {self.mode!r}")
        if self.num_steps < 1:
            raise ValueError("gradient_accumulation num_steps must be >= 1")


@dataclass
class FullyShardedDataParallelPlugin:
    """The ZeRO-offload and int8-state knobs of the JAX plugin (JAX :292;
    reference FSDP plugin / DeepSpeed ``offload_optimizer``):

    - ``cpu_offload``: the optimizer state lives in pinned host memory, the
      gradients stream device-to-host and the update runs on the host
      (env default ``FSDP_OFFLOAD_PARAMS``);
    - ``offload_params``: the stored params live there too and each step
      fetches the compute-width copy (default: follows ``cpu_offload``);
    - ``host_update_chunk_gib``: split the host update into leaf groups of
      at most this many GiB of f32 params (``ops/streaming.chunk_groups``),
      None for one update over every leaf;
    - ``host_update_pipeline``: with chunks, stage chunk k+1's gradients
      device-to-host while chunk k updates (default True, env
      ``ACCELERATE_HOST_UPDATE_PIPELINE``); bitwise the serial schedule;
    - ``int8_state_block_size``: the -sr8 recipes' scale granularity
      (default 128, env ``ACCELERATE_INT8_STATE_BLOCK``), read by
      ``Accelerator.prepare_optimizer``.

    - ``sharding_strategy``: how the parameters and optimizer state lie
      across the data-parallel ranks (:class:`ShardingStrategy`; default
      env ``FSDP_SHARDING_STRATEGY`` or FULL_SHARD), read under a
      parallelism config (``parallel/sharding.py``);
    - ``min_weight_size``: leaves of fewer elements stay replicated;
    - ``reshard_after_forward``: under FULL_SHARD / HYBRID_SHARD the
      forward gathers each unit's weights (an embedding, a decoder block,
      the head) just before the unit and frees them after it, and the
      backward gathers them again (``True``, ZeRO-3, JAX's default); with
      ``False`` a unit's gathered weights stay until its backward.  Either
      way each unit's gradient is reduced in its backward
      (``parallel/fsdp.py``).  No effect where the parameters are whole.

    ``collective_matmul`` other than ``"off"`` needs a tensor-parallel
    mesh: the Accelerator raises for it (ROADMAP A13).  Activation
    checkpointing is ``LlamaConfig.remat``."""

    sharding_strategy: Optional[ShardingStrategy] = None
    reshard_after_forward: bool = True
    min_weight_size: int = 2**12
    cpu_offload: Optional[bool] = None
    offload_params: Optional[bool] = None
    host_update_chunk_gib: Optional[float] = None
    host_update_pipeline: Optional[bool] = None
    int8_state_block_size: Optional[int] = None
    collective_matmul: Optional[str] = None

    def __post_init__(self):
        # the environment supplies defaults only: an explicit argument wins
        env = os.environ
        if self.sharding_strategy is None:
            self.sharding_strategy = ShardingStrategy(env.get("FSDP_SHARDING_STRATEGY",
                                                              "FULL_SHARD"))
        elif isinstance(self.sharding_strategy, str):
            self.sharding_strategy = ShardingStrategy(self.sharding_strategy)
        if self.cpu_offload is None:
            self.cpu_offload = parse_flag_from_env("FSDP_OFFLOAD_PARAMS")
        if self.offload_params is None:
            self.offload_params = self.cpu_offload
        if self.host_update_pipeline is None:
            self.host_update_pipeline = parse_flag_from_env("ACCELERATE_HOST_UPDATE_PIPELINE",
                                                            default=True)
        if self.int8_state_block_size is None:
            self.int8_state_block_size = int(env.get("ACCELERATE_INT8_STATE_BLOCK", 128))
        if self.int8_state_block_size < 1:
            raise ValueError(
                f"int8_state_block_size must be >= 1, got {self.int8_state_block_size}")
        if self.collective_matmul is None:
            self.collective_matmul = env.get("ACCELERATE_COLLECTIVE_MATMUL", "off")
        mode = _COLLECTIVE_MATMUL_MODES.get(str(self.collective_matmul).strip().lower())
        if mode is None:
            raise ValueError(f"collective_matmul mode {self.collective_matmul!r} not one of "
                             f"{sorted(_COLLECTIVE_MATMUL_MODES)}")
        self.collective_matmul = mode


# the JAX package's collective-matmul mode names and their canonical forms
_COLLECTIVE_MATMUL_MODES = {"off": "off", "false": "off", "0": "off", "none": "off", "": "off",
                            "on": "ring", "ring": "ring", "true": "ring", "1": "ring",
                            "uni": "ring", "bidir": "bidir", "bidirectional": "bidir"}


@dataclass
class TensorParallelConfig:
    """Tensor parallelism's knobs (JAX :918): ``plan`` names the rule table
    the sharding plan applies (``parallel/sharding.get_tp_rules``:
    ``"auto"`` / ``"transformer"``, ``"none"``); ``async_matmul`` is
    carried for the signature (the ring collective matmul is the
    ``FullyShardedDataParallelPlugin.collective_matmul`` knob)."""

    tp_size: int = 1
    plan: str = "auto"
    async_matmul: bool = True


@dataclass
class ContextParallelConfig:
    """Ring attention's knobs (JAX :932): ``rotate_method`` ``"allgather"``
    gathers every rank's K / V once, ``"alltoall"`` passes them around the
    ring; ``load_balance`` is the zigzag layout."""

    cp_size: int = 1
    rotate_method: str = "allgather"
    load_balance: bool = True

    def __post_init__(self):
        if self.rotate_method not in ("allgather", "alltoall"):
            raise ValueError(f"invalid cp rotate method {self.rotate_method!r}")


@dataclass
class SequenceParallelConfig:
    """Ulysses attention's knobs (JAX :949): two all_to_alls swap the
    sequence split for a head split around attention."""

    sp_size: int = 1
    seq_length: Optional[int] = None
    attn_implementation: str = "native"


@dataclass
class FP8RecipeKwargs:
    """The fp8 recipe (JAX :970; reference TE ``DelayedScaling``): the
    amax history length (env ``ACCELERATE_FP8_AMAX_HISTORY_LEN``, default
    16) and the scale margin (env ``ACCELERATE_FP8_MARGIN``, default 0) of
    the delayed scaling the train state carries (``ops/fp8.py``).  The
    operands are always the hybrid pairing, e4m3 forward and e5m2
    backward, on every dense layer."""

    amax_history_len: Optional[int] = None
    amax_compute_algo: str = "max"
    margin: Optional[int] = None

    def __post_init__(self):
        env = os.environ
        if self.amax_history_len is None:
            self.amax_history_len = int(env.get("ACCELERATE_FP8_AMAX_HISTORY_LEN", 16))
        if self.margin is None:
            self.margin = int(env.get("ACCELERATE_FP8_MARGIN", 0))
        if self.amax_history_len < 1:
            raise ValueError(f"amax_history_len must be >= 1, got {self.amax_history_len}")
        if self.margin < 0:
            raise ValueError(f"margin must be >= 0, got {self.margin}")
        if self.amax_compute_algo != "max":
            raise ValueError("amax_compute_algo: only 'max' is implemented "
                             f"(got {self.amax_compute_algo!r})")


def _str_to_bool(value: str) -> bool:
    value = value.lower()
    if value in ("y", "yes", "t", "true", "on", "1"):
        return True
    if value in ("n", "no", "f", "false", "off", "0"):
        return False
    raise ValueError(f"invalid truth value {value!r}")


def parse_flag_from_env(key: str, default: bool = False) -> bool:
    return _str_to_bool(os.environ.get(key, str(default)))


@dataclass
class ResiliencePlugin:
    """Preemption-safe training knobs (``accelerate_tpu_torch/resilience/``):
    the JAX package's fields, defaults and environment defaults.

    ``ACCELERATE_RESILIENCE=1`` arms the NaN guard and preemption handling
    by default; ``ACCELERATE_NAN_GUARD`` / ``ACCELERATE_PREEMPTION``
    override each.  Checkpoint verification and bounded I/O retry are on
    regardless.  ``preemption_check_every`` paces the cross-rank agreement
    of the preemption stop in a multi-process run; ``peer_snapshot_every``
    arms buddy-rank host-RAM snapshots every that many steps, the newest
    ``peer_snapshot_keep`` kept (``resilience/peer_ckpt.py``, the first
    rung of ``Accelerator.recover``)."""

    nan_guard: Optional[bool] = None        # skip a step whose loss or grad norm
                                            # is non-finite; counters persist in
                                            # TrainState.guard_state.  Default:
                                            # env ACCELERATE_NAN_GUARD, else
                                            # ACCELERATE_RESILIENCE
    max_consecutive_nan_skips: int = 3      # NanGuardAbort after this many
                                            # consecutive skips; 0 disables the
                                            # abort only
    handle_preemption: Optional[bool] = None  # install the SIGTERM-at-step-
                                            # boundary handler at construction.
                                            # Default: env ACCELERATE_PREEMPTION,
                                            # else ACCELERATE_RESILIENCE
    preemption_signals: tuple = ("SIGTERM",)
    preemption_check_every: int = 1
    emergency_checkpoint: bool = True       # checkpoint at the stop boundary
    resume_exit_code: int = 75              # EX_TEMPFAIL: "re-run me"
    verify_checkpoints: bool = True         # manifest on save, verify + valid
                                            # fallback on load
    io_retries: int = 3                     # bounded retry budget for
                                            # checkpoint I/O + host transfers
    io_backoff_s: float = 0.05              # first backoff; doubles per retry
    peer_snapshot_every: int = 0            # 0: no peer snapshots
    peer_snapshot_keep: int = 2

    def __post_init__(self):
        armed = parse_flag_from_env("ACCELERATE_RESILIENCE")
        if self.nan_guard is None:
            self.nan_guard = parse_flag_from_env("ACCELERATE_NAN_GUARD", default=armed)
        if self.handle_preemption is None:
            self.handle_preemption = parse_flag_from_env("ACCELERATE_PREEMPTION", default=armed)
        if isinstance(self.preemption_signals, str):
            self.preemption_signals = (self.preemption_signals,)
        else:
            self.preemption_signals = tuple(self.preemption_signals)
        if self.max_consecutive_nan_skips < 0:
            raise ValueError(
                "max_consecutive_nan_skips must be >= 0 (0 disables the "
                f"abort), got {self.max_consecutive_nan_skips}"
            )
        if self.io_retries < 0:
            raise ValueError(f"io_retries must be >= 0, got {self.io_retries}")
        if self.peer_snapshot_every < 0:
            raise ValueError(
                "peer_snapshot_every must be >= 0 (0 disables peer "
                f"snapshots), got {self.peer_snapshot_every}"
            )
        if self.peer_snapshot_keep < 1:
            raise ValueError(
                f"peer_snapshot_keep must be >= 1, got {self.peer_snapshot_keep}"
            )


@dataclass
class DataLoaderConfiguration:
    """How ``Accelerator.prepare`` wraps a data loader (the JAX package's
    fields and defaults).  ``prefetch_size >= 2`` stages batches through the
    native ring on a producer thread; ``dispatch_batches`` moot on one
    process but kept; ``use_stateful_dataloader`` is accepted as in JAX
    (the prepared loaders are stateful either way)."""

    split_batches: bool = False
    dispatch_batches: Optional[bool] = None
    even_batches: bool = True
    use_seedable_sampler: bool = False
    data_seed: Optional[int] = None
    non_blocking: bool = True
    use_stateful_dataloader: bool = False
    prefetch_size: int = 2


@dataclass
class ProjectConfiguration:
    """The project and checkpoint directories: ``automatic_checkpoint_naming``
    writes ``<project_dir>/checkpoints/checkpoint_<i>`` and ``total_limit``
    keeps the newest ones (the JAX package's fields)."""

    project_dir: Optional[str] = None
    logging_dir: Optional[str] = None
    automatic_checkpoint_naming: bool = False
    total_limit: Optional[int] = None
    iteration: int = 0
    save_on_each_node: bool = False

    def set_directories(self, project_dir: Optional[str] = None):
        self.project_dir = project_dir
        if self.logging_dir is None:
            self.logging_dir = project_dir

    def __post_init__(self):
        self.set_directories(self.project_dir)


@dataclass
class ServingPlugin:
    """Serving-core knobs (engine: ``accelerate_tpu_torch/serving/`` — paged
    KV cache + continuous batching).

    The same fields, defaults and ``ACCELERATE_SERVE_*`` environment
    defaults as the JAX package's plugin (explicit arguments always win).
    ``decode_kernel="auto"`` resolves to ``"flash"``: the hand-written paged
    kernels on a CUDA tensor and their plain versions on a CPU tensor;
    ``"native"`` (gather + dense attention) runs only when asked for.
    ``kv_dtype`` ``"int8"`` / ``"fp8"`` serves from quantized pages;
    ``speculate`` ``"ngram"`` / ``"draft"`` decodes speculatively and
    ``prefix_cache="on"`` shares cached prompt pages.  The overload knobs
    bound the waiting line (``max_queue``), shed on predicted KV pressure
    (``kv_shed_watermark``), stamp a deadline on requests that carry none
    (``default_deadline_ticks``) and size the degradation ladder's
    admission reserve (``ladder_reserve_frac``).
    """

    num_slots: Optional[int] = None          # concurrent decode lanes
                                             # (env ACCELERATE_SERVE_SLOTS, default 8)
    page_size: Optional[int] = None          # tokens per KV page
                                             # (env ACCELERATE_SERVE_PAGE_SIZE, default 16)
    pages_per_slot: Optional[int] = None     # block-table width = per-sequence KV
                                             # ceiling in pages (env
                                             # ACCELERATE_SERVE_PAGES_PER_SLOT, default 8)
    num_pages: Optional[int] = None          # pool size; default num_slots *
                                             # pages_per_slot // 2 (env
                                             # ACCELERATE_SERVE_PAGES)
    prefill_chunk: Optional[int] = None      # max prompt tokens prefilled per engine
                                             # tick (env ACCELERATE_SERVE_PREFILL_CHUNK,
                                             # default 64)
    prefill_buckets: Optional[tuple] = None  # pad-to-bucket prefill widths; default
                                             # powers of two from 16 up to prefill_chunk
    decode_kernel: str = ""                  # "auto" | "native" | "flash"
                                             # (env ACCELERATE_SERVE_KERNEL)
    speculate: str = ""                      # "off" | "ngram" | "draft"
                                             # (env ACCELERATE_SERVE_SPECULATE)
    speculate_k: Optional[int] = None        # env ACCELERATE_SERVE_SPECULATE_K, default 4
    speculate_buckets: Optional[tuple] = None  # default (speculate_k,)
    speculate_draft_window: Optional[int] = None  # env ACCELERATE_SERVE_SPECULATE_DRAFT,
                                             # default 32
    prefix_cache: str = ""                   # "off" | "on"
                                             # (env ACCELERATE_SERVE_PREFIX_CACHE)
    max_queue: Optional[int] = None          # 0 = unbounded (env ACCELERATE_SERVE_MAX_QUEUE)
    kv_shed_watermark: Optional[float] = None  # 0.0 = off (env ACCELERATE_SERVE_KV_WATERMARK)
    default_deadline_ticks: Optional[int] = None  # 0 = none (env ACCELERATE_SERVE_DEADLINE)
    ladder_reserve_frac: Optional[float] = None  # env ACCELERATE_SERVE_LADDER_RESERVE,
                                             # default 0.125
    kv_dtype: str = ""                       # "bf16" | "int8" | "fp8"
                                             # (env ACCELERATE_SERVE_KV_DTYPE, default bf16)

    def __post_init__(self):
        env = os.environ
        if self.num_slots is None:
            self.num_slots = int(env.get("ACCELERATE_SERVE_SLOTS", 8))
        if self.page_size is None:
            self.page_size = int(env.get("ACCELERATE_SERVE_PAGE_SIZE", 16))
        if self.pages_per_slot is None:
            self.pages_per_slot = int(env.get("ACCELERATE_SERVE_PAGES_PER_SLOT", 8))
        if self.num_pages is None:
            env_pages = env.get("ACCELERATE_SERVE_PAGES")
            self.num_pages = (int(env_pages) if env_pages
                              else max(self.pages_per_slot,
                                       self.num_slots * self.pages_per_slot // 2))
        if self.prefill_chunk is None:
            self.prefill_chunk = int(env.get("ACCELERATE_SERVE_PREFILL_CHUNK", 64))
        if not self.decode_kernel:
            self.decode_kernel = env.get("ACCELERATE_SERVE_KERNEL", "auto")
        if self.decode_kernel not in ("auto", "native", "flash"):
            raise ValueError(
                f"decode_kernel must be 'auto', 'native' or 'flash', got "
                f"{self.decode_kernel!r}"
            )
        if isinstance(self.speculate, bool):
            self.speculate = "ngram" if self.speculate else "off"
        if not self.speculate:
            self.speculate = env.get("ACCELERATE_SERVE_SPECULATE", "off")
        self.speculate = {"1": "ngram", "on": "ngram", "0": "off",
                          "": "off"}.get(self.speculate.lower(),
                                         self.speculate.lower())
        if self.speculate not in ("off", "ngram", "draft"):
            raise ValueError(
                f"speculate must be 'off', 'ngram' or 'draft' (or 'on'/'1' "
                f"for ngram), got {self.speculate!r}"
            )
        if self.speculate_k is None:
            self.speculate_k = int(env.get("ACCELERATE_SERVE_SPECULATE_K", 4))
        if self.speculate_draft_window is None:
            self.speculate_draft_window = int(
                env.get("ACCELERATE_SERVE_SPECULATE_DRAFT", 32)
            )
        if self.speculate != "off" and self.speculate_k < 1:
            raise ValueError(
                f"speculate_k must be >= 1 with speculation on, got "
                f"{self.speculate_k}"
            )
        if self.speculate_buckets is None:
            self.speculate_buckets = (self.speculate_k,)
        else:
            self.speculate_buckets = tuple(
                sorted(int(b) for b in self.speculate_buckets)
            )
            if not self.speculate_buckets or \
                    self.speculate_buckets[-1] < self.speculate_k:
                raise ValueError(
                    f"speculate_buckets {self.speculate_buckets} must include "
                    f"a bucket >= speculate_k={self.speculate_k}"
                )
            if self.speculate_buckets[0] < 1:
                raise ValueError("speculate_buckets entries must be >= 1")
        if isinstance(self.prefix_cache, bool):
            self.prefix_cache = "on" if self.prefix_cache else "off"
        if not self.prefix_cache:
            self.prefix_cache = env.get("ACCELERATE_SERVE_PREFIX_CACHE", "off")
        self.prefix_cache = {"1": "on", "true": "on", "0": "off",
                             "false": "off", "": "off"}.get(
            self.prefix_cache.lower(), self.prefix_cache.lower()
        )
        if self.prefix_cache not in ("off", "on"):
            raise ValueError(
                f"prefix_cache must be 'off' or 'on' (or '1'/'true' for on), "
                f"got {self.prefix_cache!r}"
            )
        if self.max_queue is None:
            self.max_queue = int(env.get("ACCELERATE_SERVE_MAX_QUEUE", 0))
        if self.kv_shed_watermark is None:
            self.kv_shed_watermark = float(
                env.get("ACCELERATE_SERVE_KV_WATERMARK", 0.0)
            )
        if self.default_deadline_ticks is None:
            self.default_deadline_ticks = int(env.get("ACCELERATE_SERVE_DEADLINE", 0))
        if self.ladder_reserve_frac is None:
            self.ladder_reserve_frac = float(
                env.get("ACCELERATE_SERVE_LADDER_RESERVE", 0.125)
            )
        if self.max_queue < 0:
            raise ValueError(f"max_queue must be >= 0 (0 = unbounded), got {self.max_queue}")
        if not 0.0 <= self.kv_shed_watermark <= 1.0:
            raise ValueError(
                f"kv_shed_watermark must be in [0, 1] (0 = off), got "
                f"{self.kv_shed_watermark}"
            )
        if self.default_deadline_ticks < 0:
            raise ValueError(
                f"default_deadline_ticks must be >= 0 (0 = none), got "
                f"{self.default_deadline_ticks}"
            )
        if not 0.0 < self.ladder_reserve_frac < 1.0:
            raise ValueError(
                f"ladder_reserve_frac must be in (0, 1), got "
                f"{self.ladder_reserve_frac}"
            )
        for name in ("num_slots", "page_size", "pages_per_slot", "num_pages",
                     "prefill_chunk"):
            if getattr(self, name) < 1:
                raise ValueError(f"ServingPlugin.{name} must be >= 1, got {getattr(self, name)}")
        if self.num_pages < self.pages_per_slot:
            raise ValueError(
                f"num_pages={self.num_pages} must cover at least one sequence "
                f"(pages_per_slot={self.pages_per_slot})"
            )
        if not self.kv_dtype:
            self.kv_dtype = env.get("ACCELERATE_SERVE_KV_DTYPE", "bf16")
        self.kv_dtype = self.kv_dtype.lower()
        if self.kv_dtype not in ("bf16", "int8", "fp8"):
            raise ValueError(
                f"kv_dtype must be 'bf16', 'int8' or 'fp8', got "
                f"{self.kv_dtype!r}"
            )
        if self.prefill_buckets is None:
            buckets, b = [], 16
            while b < self.prefill_chunk:
                buckets.append(b)
                b *= 2
            buckets.append(self.prefill_chunk)
            self.prefill_buckets = tuple(buckets)
        else:
            self.prefill_buckets = tuple(sorted(int(b) for b in self.prefill_buckets))
            if not self.prefill_buckets or self.prefill_buckets[-1] < self.prefill_chunk:
                raise ValueError(
                    f"prefill_buckets {self.prefill_buckets} must include a bucket "
                    f">= prefill_chunk={self.prefill_chunk}"
                )


@dataclass
class LoraPlugin:
    """Multi-tenant batched-LoRA knobs (``serving/adapters.py`` +
    ``ops/lora.py``): the same fields, defaults, ``ACCELERATE_LORA_*``
    environment defaults and validation as the JAX package's plugin
    (explicit arguments always win).

    A fixed-size device pool holds the hot adapters as stacked A/B factors
    (slot 0 is the null adapter, the base model), cold adapters hot-swap in
    from host memory, and every row routes through its adapter by id.
    ``kernel``: ``"auto"`` (kernel #10 at T = 1, the gathered product
    otherwise), ``"native"`` or ``"bgmv"``.  ``optimizer`` names the
    per-adapter fine-tuning recipe of ``LoraTrainer``."""

    rank: Optional[int] = None               # env ACCELERATE_LORA_RANK, default 8
    alpha: Optional[float] = None            # folded into stored B as alpha / rank
                                             # (env ACCELERATE_LORA_ALPHA, default 16.0)
    pool_slots: Optional[int] = None         # resident adapters besides the null slot
                                             # (env ACCELERATE_LORA_POOL_SLOTS, default 4)
    targets: Optional[tuple] = None          # env ACCELERATE_LORA_TARGETS, comma-separated,
                                             # default q_proj,v_proj
    kernel: str = ""                         # env ACCELERATE_LORA_KERNEL, default auto
    max_bypass_age: Optional[int] = None     # ticks a swap-blocked head of line lets
                                             # younger requests admit past it
                                             # (env ACCELERATE_LORA_BYPASS_AGE, default
                                             # 16; 0 = strict FIFO)
    optimizer: str = ""                      # env ACCELERATE_LORA_OPTIMIZER, default lion-sr8

    def __post_init__(self):
        env = os.environ
        if self.rank is None:
            self.rank = int(env.get("ACCELERATE_LORA_RANK", 8))
        if self.alpha is None:
            self.alpha = float(env.get("ACCELERATE_LORA_ALPHA", 16.0))
        if self.pool_slots is None:
            self.pool_slots = int(env.get("ACCELERATE_LORA_POOL_SLOTS", 4))
        if self.targets is None:
            raw = env.get("ACCELERATE_LORA_TARGETS", "q_proj,v_proj")
            self.targets = tuple(t.strip() for t in raw.split(",") if t.strip())
        elif isinstance(self.targets, str):
            self.targets = tuple(t.strip() for t in self.targets.split(",") if t.strip())
        else:
            self.targets = tuple(self.targets)
        if not self.kernel:
            self.kernel = env.get("ACCELERATE_LORA_KERNEL", "auto")
        from ..ops.lora import normalize_lora_kernel

        self.kernel = normalize_lora_kernel(self.kernel)
        if self.max_bypass_age is None:
            self.max_bypass_age = int(env.get("ACCELERATE_LORA_BYPASS_AGE", 16))
        if not self.optimizer:
            self.optimizer = env.get("ACCELERATE_LORA_OPTIMIZER", "lion-sr8")
        if self.rank < 1:
            raise ValueError(f"LoraPlugin.rank must be >= 1, got {self.rank}")
        if self.alpha <= 0:
            raise ValueError(f"LoraPlugin.alpha must be > 0, got {self.alpha}")
        if self.pool_slots < 1:
            raise ValueError(
                f"LoraPlugin.pool_slots must be >= 1, got {self.pool_slots}"
            )
        if self.max_bypass_age < 0:
            raise ValueError(
                f"LoraPlugin.max_bypass_age must be >= 0, got {self.max_bypass_age}"
            )
        if not self.targets:
            raise ValueError("LoraPlugin.targets must name at least one module")


@dataclass
class TelemetryPlugin:
    """Telemetry knobs (JAX :855), each defaulting from its
    ``ACCELERATE_TELEMETRY*`` environment variable (explicit arguments
    win): ``enabled`` (the master switch), ``trace_requests`` (request
    spans on the serving engine), ``timeline`` (the training timeline on
    the ``Accelerator``), ``ring_capacity`` (span ring size, default 4096),
    ``slo`` (``SLOMonitor`` thresholds for the train step, or None) and
    ``export_dir`` (where ``end_training`` writes ``train_timeline.json``).
    All host-side: the loss is bitwise the same with telemetry on."""

    enabled: Optional[bool] = None
    trace_requests: Optional[bool] = None
    timeline: Optional[bool] = None
    ring_capacity: Optional[int] = None
    slo: Optional[dict] = None
    export_dir: Optional[str] = None

    def __post_init__(self):
        env = os.environ
        if self.enabled is None:
            self.enabled = parse_flag_from_env("ACCELERATE_TELEMETRY")
        if self.trace_requests is None:
            self.trace_requests = parse_flag_from_env(
                "ACCELERATE_TELEMETRY_TRACE_REQUESTS", default=self.enabled)
        if self.timeline is None:
            self.timeline = parse_flag_from_env("ACCELERATE_TELEMETRY_TIMELINE",
                                                default=self.enabled)
        if self.ring_capacity is None:
            self.ring_capacity = int(env.get("ACCELERATE_TELEMETRY_RING", 4096))
        if self.ring_capacity < 1:
            raise ValueError(
                f"TelemetryPlugin.ring_capacity must be >= 1, got {self.ring_capacity}")
        if self.export_dir is None:
            self.export_dir = env.get("ACCELERATE_TELEMETRY_DIR") or None
        if self.slo is not None and not isinstance(self.slo, dict):
            raise ValueError(
                f"TelemetryPlugin.slo must be a thresholds dict, got {type(self.slo).__name__}")
