"""Plugin dataclasses of the port (mirrors ``accelerate_tpu/utils/
dataclasses.py``: ``GradSyncKwargs`` :155, ``GradientAccumulationPlugin``
:269, ``ServingPlugin`` :487)."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional


@dataclass
class GradSyncKwargs:
    """How gradients are formed and reduced (the JAX package's fields).
    ``grad_dtype="bf16"`` differentiates with respect to the compute-width
    copy of the params, so every gradient is born bf16.  ``comm_dtype``
    casts the gradients before the (single-device, so absent) reduction;
    ``average_grads`` is moot on one device.  The compression and
    hierarchical knobs are multi-GPU reductions, ROADMAP item A13: the
    train step raises when one is set."""

    comm_dtype: Optional[str] = None     # None | "bf16" | "fp16"
    average_grads: bool = True
    grad_dtype: Optional[str] = None     # None | "bf16"
    compression: Optional[str] = None    # "powersgd" (A13)
    rank: int = 4
    hierarchical: Optional[bool] = None  # True requires a dcn axis (A13)
    dcn_compression: Optional[str] = None


@dataclass
class GradientAccumulationPlugin:
    """Gradient accumulation: ``in_step`` splits each batch into
    ``num_steps`` microbatches inside one train step and sums their
    gradients in f32.  ``across_steps`` (the sum carried between calls)
    parses as in JAX; the Accelerator raises ``NotImplementedError`` for it."""

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
class ServingPlugin:
    """Serving-core knobs (engine: ``accelerate_tpu_torch/serving/`` — paged
    KV cache + continuous batching).

    The same fields, defaults and ``ACCELERATE_SERVE_*`` environment
    defaults as the JAX package's plugin (explicit arguments always win).
    ``decode_kernel="auto"`` resolves to ``"flash"``: the hand-written paged
    kernels on a CUDA tensor and their plain versions on a CPU tensor;
    ``"native"`` (gather + dense attention) runs only when asked for.  The
    speculation, prefix-cache, quantized-page and overload knobs parse as in
    JAX; the engine raises ``NotImplementedError`` when one is switched on.
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
