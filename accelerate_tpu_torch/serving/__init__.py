"""Serving core of the port: paged KV cache + continuous batching (mirrors
``accelerate_tpu/serving/``).

- :mod:`.paged_cache` — the page allocator over the pool built by
  :func:`accelerate_tpu_torch.models.llama.init_paged_cache`;
- :mod:`.scheduler` — the deterministic continuous-batching policy;
- :mod:`.engine` — the prefill/decode/release steps and the host loop;
- :mod:`.harness` — seeded traffic replay and the serving metrics.
"""

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
    "ContinuousBatchingScheduler",
    "Request",
    "ServingEngine",
    "SlotState",
    "allocate",
    "kv_page_bytes",
    "kv_pool_accounting",
    "pages_for",
    "push_pages",
    "release",
    "replay",
    "synthesize_trace",
]
