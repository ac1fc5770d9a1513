"""Serving core of the port: paged KV cache + continuous batching (mirrors
``accelerate_tpu/serving/``).

- :mod:`.paged_cache` — the page allocator over the pool built by
  :func:`accelerate_tpu_torch.models.llama.init_paged_cache`;
- :mod:`.scheduler` — the deterministic continuous-batching policy;
- :mod:`.engine` — the prefill/decode/release steps and the host loop;
- :mod:`.harness` — seeded traffic replay and the serving metrics;
- :mod:`.adapters` — the multi-tenant LoRA adapter pool (hot-swap, LRU,
  refcount pinning) and its accounting;
- :mod:`.speculate` — speculative decode's draft providers and acceptance
  arithmetic;
- :mod:`.prefix_cache` — the content-addressed copy-on-write prefix cache;
- :mod:`.overload` — the degradation ladder and the serving resource
  contract's checker;
- :mod:`.transfer` — the disaggregated prefill -> decode pair and the KV
  page transport between its engines;
- :mod:`.router` — N replicas (engines or pairs) behind prefix- and
  adapter-affinity routing, with drain and respawn.
"""

from .adapters import (
    AdapterPoolFullError,
    AdapterStore,
    LoraTrainer,
    adapter_pool_accounting,
    predicted_adapter_hit_rate,
)
from .engine import ServingEngine
from .harness import (
    chaos_replay,
    predicted_pool_utilization,
    predicted_prefix_hit_rate,
    replay,
    static_batching_report,
    synthesize_trace,
)
from .overload import DegradationLadder, verify_serving_invariants
from .paged_cache import (
    allocate,
    kv_page_bytes,
    kv_pool_accounting,
    pages_for,
    push_pages,
    release,
)
from .prefix_cache import (
    PrefixCache,
    block_hashes,
    prefix_cache_accounting,
    unbounded_prefix_hit_rate,
)
from .router import FleetRouter, fleet_chaos_replay, fleet_replay
from .scheduler import ContinuousBatchingScheduler, Request, SlotState
from .speculate import (
    DraftModelDraft,
    NgramDraft,
    Speculator,
    make_draft_provider,
    predicted_acceptance,
    speculative_page_need,
)
from .transfer import DisaggregatedPair, PagedKVTransport, page_bytes, transfer_accounting

__all__ = [
    "AdapterPoolFullError",
    "AdapterStore",
    "ContinuousBatchingScheduler",
    "DegradationLadder",
    "DisaggregatedPair",
    "DraftModelDraft",
    "FleetRouter",
    "LoraTrainer",
    "NgramDraft",
    "PagedKVTransport",
    "PrefixCache",
    "Request",
    "ServingEngine",
    "SlotState",
    "Speculator",
    "adapter_pool_accounting",
    "allocate",
    "block_hashes",
    "chaos_replay",
    "fleet_chaos_replay",
    "fleet_replay",
    "kv_page_bytes",
    "kv_pool_accounting",
    "make_draft_provider",
    "page_bytes",
    "pages_for",
    "predicted_acceptance",
    "predicted_adapter_hit_rate",
    "predicted_pool_utilization",
    "predicted_prefix_hit_rate",
    "prefix_cache_accounting",
    "push_pages",
    "release",
    "replay",
    "speculative_page_need",
    "static_batching_report",
    "synthesize_trace",
    "transfer_accounting",
    "unbounded_prefix_hit_rate",
    "verify_serving_invariants",
]
