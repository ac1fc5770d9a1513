"""Traffic replay (mirrors ``accelerate_tpu/serving/harness.py``:
``synthesize_trace`` :32, ``replay`` :263).

Replays a seeded request trace (Poisson arrivals in virtual engine-step
time, mixed prompt/output lengths) through a
:class:`~.engine.ServingEngine` and reports the serving metrics users feel:
tokens per second, time to first token and the per-token latency, in wall
time.  The JAX harness's prefix, speculation, adapter and digital-twin
fields belong to later slices.
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
) -> list[Request]:
    """A deterministic request trace: exponential gaps in virtual
    engine-step time, uniformly mixed prompt/output lengths.  Same seed ->
    the same trace as the JAX package's ``synthesize_trace`` with its
    adapter, deadline and prefix options off."""
    rng = np.random.default_rng(seed)
    trace = []
    t = 0.0
    for uid in range(n_requests):
        t += rng.exponential(mean_interarrival_steps)
        p_len = int(rng.integers(prompt_len_range[0], prompt_len_range[1] + 1))
        n_new = int(rng.integers(new_tokens_range[0], new_tokens_range[1] + 1))
        prompt = tuple(int(x) for x in rng.integers(1, vocab_size, p_len))
        trace.append(Request(uid=uid, prompt=prompt, max_new_tokens=n_new,
                             arrival_step=int(t)))
    return trace


def _percentile_ms(samples: list, q: float) -> float:
    if not samples:
        return 0.0
    return float(np.percentile(np.asarray(samples), q)) * 1e3


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
    }
