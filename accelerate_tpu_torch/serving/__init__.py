"""Serving core of the port: paged KV cache + continuous batching (mirrors
``accelerate_tpu/serving/``).

- :mod:`.paged_cache` — the page allocator over the pool built by
  :func:`accelerate_tpu_torch.models.llama.init_paged_cache`;
- :mod:`.scheduler` — the deterministic continuous-batching policy;
- :mod:`.engine` — the prefill/decode/release steps and the host loop;
- :mod:`.harness` — seeded traffic replay and the serving metrics;
- :mod:`.adapters` — the multi-tenant LoRA adapter pool (hot-swap, LRU,
  refcount pinning) and its accounting.
"""

from .adapters import (
    AdapterPoolFullError,
    AdapterStore,
    LoraTrainer,
    adapter_pool_accounting,
    predicted_adapter_hit_rate,
)
from .engine import ServingEngine
from .harness import replay, synthesize_trace
from .paged_cache import (
    allocate,
    kv_page_bytes,
    kv_pool_accounting,
    pages_for,
    push_pages,
    release,
)
from .scheduler import ContinuousBatchingScheduler, Request, SlotState

__all__ = [
    "AdapterPoolFullError",
    "AdapterStore",
    "ContinuousBatchingScheduler",
    "LoraTrainer",
    "Request",
    "ServingEngine",
    "SlotState",
    "adapter_pool_accounting",
    "allocate",
    "kv_page_bytes",
    "kv_pool_accounting",
    "pages_for",
    "predicted_adapter_hit_rate",
    "push_pages",
    "release",
    "replay",
    "synthesize_trace",
]
