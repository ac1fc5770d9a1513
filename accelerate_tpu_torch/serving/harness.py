"""Traffic replay (mirrors ``accelerate_tpu/serving/harness.py``:
``synthesize_trace`` :32, ``replay`` :263, ``_adapter_fields`` :612).

Replays a seeded request trace (Poisson arrivals in virtual engine-step
time, mixed prompt/output lengths) through a
:class:`~.engine.ServingEngine` and reports the serving metrics users feel:
tokens per second, time to first token and the per-token latency, in wall
time, and the multi-tenant adapter pool's fields.  The JAX harness's
prefix, speculation, overload and digital-twin fields belong to ROADMAP
item A11 (the twin registry to A14).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .scheduler import Request


def synthesize_trace(
    seed: int,
    n_requests: int,
    *,
    vocab_size: int = 256,
    mean_interarrival_steps: float = 2.0,
    prompt_len_range: tuple = (4, 24),
    new_tokens_range: tuple = (2, 16),
    adapters: int = 0,
) -> list[Request]:
    """A deterministic request trace: exponential gaps in virtual
    engine-step time, uniformly mixed prompt/output lengths.  With
    ``adapters=N`` each request draws a tenant ``adapter_id`` uniformly
    from ``0..N`` (id 0: the base model), after its prompt, as JAX draws
    it.  Same seed -> the same trace as the JAX package's
    ``synthesize_trace`` with its deadline and prefix options off."""
    rng = np.random.default_rng(seed)
    trace = []
    t = 0.0
    for uid in range(n_requests):
        t += rng.exponential(mean_interarrival_steps)
        p_len = int(rng.integers(prompt_len_range[0], prompt_len_range[1] + 1))
        n_new = int(rng.integers(new_tokens_range[0], new_tokens_range[1] + 1))
        prompt = tuple(int(x) for x in rng.integers(1, vocab_size, p_len))
        adapter_id = int(rng.integers(0, adapters + 1)) if adapters > 0 else 0
        trace.append(Request(uid=uid, prompt=prompt, max_new_tokens=n_new,
                             arrival_step=int(t), adapter_id=adapter_id))
    return trace


def _percentile_ms(samples: list, q: float) -> float:
    if not samples:
        return 0.0
    return float(np.percentile(np.asarray(samples), q)) * 1e3


def _adapter_fields(engine, trace: list[Request]) -> dict:
    """The multi-tenant block of the serving report (JAX
    ``_adapter_fields``, without the twin registry): the pool's measured
    hit rate beside its LRU-replay prediction, swaps and swap bytes, and the
    trace's tenant census.  Zeros without a store."""
    store = getattr(engine, "adapters", None)
    tenant_ids = [r.adapter_id for r in sorted(trace, key=lambda r: (r.arrival_step, r.uid))]
    if store is None:
        return {
            "adapters": 0, "adapter_requests": 0,
            "adapter_pool_slots": 0, "lora_rank": 0,
            "adapter_pool_hit_rate": 0.0,
            "adapter_pool_hit_rate_predicted": 0.0,
            "adapter_swaps": 0, "adapter_swap_bytes": 0,
        }
    from .adapters import predicted_adapter_hit_rate

    return {
        "adapters": len({t for t in tenant_ids if t}),
        "adapter_requests": sum(1 for t in tenant_ids if t),
        "adapter_pool_slots": store.plugin.pool_slots,
        "lora_rank": store.plugin.rank,
        "adapter_pool_hit_rate": store.hit_rate(),
        "adapter_pool_hit_rate_predicted": predicted_adapter_hit_rate(
            tenant_ids, store.plugin.pool_slots),
        "adapter_swaps": store.swaps,
        "adapter_swap_bytes": store.swap_bytes,
    }


def replay(engine, trace: list[Request]) -> dict:
    """Run the trace through the engine (warming it first) and compose the
    serving report; every field is present, zeros on an empty trace.

    Wall times are host clocks around work that ends in a device sync:
    every decode tick fetches its tokens, and the run ends with a
    ``torch.cuda.synchronize`` on a GPU engine."""
    if not engine.warmed_up:
        engine.warmup()
    t0 = time.perf_counter()
    results = engine.run(trace)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    wall_s = time.perf_counter() - t0
    m = engine.metrics
    p = engine.plugin
    scheduled = m["scheduled_decode_slots"] + m["prefill_scheduled_tokens"]
    useful = m["useful_decode_tokens"] + m["prefill_useful_tokens"]
    work_steps = m["decode_steps"] + m["prefill_steps"]
    total_steps = work_steps + m["idle_steps"]
    gen = m["generated_tokens"]
    return {
        "device": str(engine.device),
        "requests": len(trace),
        "completed": len(results),
        "prompt_tokens": m["prompt_tokens"],
        "generated_tokens": gen,
        "wall_s": wall_s,
        "tokens_per_sec": gen / wall_s if wall_s > 0 else 0.0,
        "p50_token_latency_ms": _percentile_ms(engine.token_gaps_s, 50),
        "p99_token_latency_ms": _percentile_ms(engine.token_gaps_s, 99),
        "ttft_p50_ms": _percentile_ms(engine.ttft_s, 50),
        "ttft_p50_ticks": (float(np.percentile(np.asarray(engine.ttft_ticks), 50))
                           if engine.ttft_ticks else 0.0),
        "kv_pool_utilization": m["page_step_sum"] / max(total_steps, 1) / p.num_pages,
        "kv_pool_peak_utilization": m["peak_used_pages"] / p.num_pages,
        "padding_waste_frac": 1.0 - useful / scheduled if scheduled else 0.0,
        "scheduler_occupancy": work_steps / max(total_steps, 1),
        "engine_steps": total_steps,
        "decode_steps": m["decode_steps"],
        "prefill_steps": m["prefill_steps"],
        "idle_steps": m["idle_steps"],
        "evictions": m["evictions"],
        "num_slots": p.num_slots,
        **_adapter_fields(engine, trace),
    }
