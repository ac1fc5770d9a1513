"""Traffic replay (mirrors ``accelerate_tpu/serving/harness.py``:
``synthesize_trace`` :32, ``predicted_prefix_hit_rate`` :183, ``replay``
:263, ``_prefix_fields`` :482, ``_speculate_fields`` :541,
``_adapter_fields`` :612).

Replays a seeded request trace (Poisson arrivals in virtual engine-step
time, mixed prompt/output lengths, optionally shared system preambles)
through a :class:`~.engine.ServingEngine` and reports the serving metrics
users feel: tokens per second, time to first token and the per-token
latency, in wall time; the speculative-decode fields (acceptance, tokens
per step, rollbacks), the prefix cache's (hit rate, shared pages, skipped
prefill) and the adapter pool's, each measured rate beside its predicted
twin, recorded in :func:`~accelerate_tpu_torch.telemetry.twin_registry`.
The JAX harness's overload and chaos fields (``predicted_pool_utilization``,
``chaos_replay``, ``static_batching_report``) are ROADMAP item A11d.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..telemetry import twin_registry
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
    prefix_share: float = 0.0,
    shared_prefixes: int = 2,
    shared_prefix_len: int = 0,
) -> list[Request]:
    """A deterministic request trace: exponential gaps in virtual
    engine-step time, uniformly mixed prompt/output lengths.  With
    ``adapters=N`` each request draws a tenant ``adapter_id`` uniformly
    from ``0..N`` (id 0: the base model), after its prompt, as JAX draws
    it.  With ``prefix_share=P`` each request opens, with probability
    ``P``, with one of ``shared_prefixes`` seeded system preambles of
    ``shared_prefix_len`` tokens (default: the middle of
    ``prompt_len_range``) before its own unique tail — the
    shared-system-prompt traffic the prefix cache serves.  Same seed -> the
    same trace as the JAX package's ``synthesize_trace`` with its deadline
    option off."""
    rng = np.random.default_rng(seed)
    if prefix_share and not shared_prefix_len:
        shared_prefix_len = (prompt_len_range[0] + prompt_len_range[1]) // 2
    preambles = [tuple(int(x) for x in rng.integers(1, vocab_size, shared_prefix_len))
                 for _ in range(shared_prefixes if prefix_share else 0)]
    trace = []
    t = 0.0
    for uid in range(n_requests):
        t += rng.exponential(mean_interarrival_steps)
        p_len = int(rng.integers(prompt_len_range[0], prompt_len_range[1] + 1))
        n_new = int(rng.integers(new_tokens_range[0], new_tokens_range[1] + 1))
        prompt = tuple(int(x) for x in rng.integers(1, vocab_size, p_len))
        if preambles and rng.random() < prefix_share:
            prompt = preambles[int(rng.integers(0, len(preambles)))] + prompt
        adapter_id = int(rng.integers(0, adapters + 1)) if adapters > 0 else 0
        trace.append(Request(uid=uid, prompt=prompt, max_new_tokens=n_new,
                             arrival_step=int(t), adapter_id=adapter_id))
    return trace


def _percentile_ms(samples: list, q: float) -> float:
    if not samples:
        return 0.0
    return float(np.percentile(np.asarray(samples), q)) * 1e3


class _AnyAdapters:
    """Adapter stand-in for the prediction replay: every tenant is known,
    pin-able and free — the replay models page arithmetic, not adapter-pool
    contention, but keeps tenant ids flowing so the prefix hash chain stays
    adapter-keyed."""

    def known(self, tid):
        return True

    def can_pin(self, tid):
        return True

    def pin(self, tid):
        return 0, False

    def unpin(self, tid):
        return None

    def prefetch(self, tid):
        return None


def predicted_prefix_hit_rate(trace: list[Request], *, num_slots: int, num_pages: int,
                              page_size: int, pages_per_slot: int,
                              prefill_chunk: int) -> float:
    """The predicted twin of the measured prefix hit rate: a model-free
    replay of the real scheduler arithmetic over the trace with a virtual
    :class:`~.prefix_cache.PrefixCache` (slot concurrency, reclaim under
    pool pressure and eviction churn replay exactly; insertions use
    synthetic page ids), every request running to its ``max_new_tokens``.
    Its error against the measured rate is what the virtual clock cannot
    see: EOS early exits and injected flushes."""
    if not trace:
        return 0.0
    from .prefix_cache import PrefixCache
    from .scheduler import ContinuousBatchingScheduler

    prefix = PrefixCache(page_size)
    sched = ContinuousBatchingScheduler(num_slots, num_pages, page_size, pages_per_slot,
                                        prefill_chunk, (prefill_chunk,), prefix=prefix)
    sched.adapters = _AnyAdapters()
    pending = [dataclasses.replace(r, deadline_ticks=0)
               for r in sorted(trace, key=lambda r: (r.arrival_step, r.uid))]
    next_page = [0]

    def insert(st):
        hashes = prefix.block_hashes(st.request.prompt, st.request.adapter_id)
        k = len(st.shared_pages)
        if len(hashes) > k:
            ids = list(range(next_page[0], next_page[0] + len(hashes) - k))
            next_page[0] += len(ids)
            st.shared_pages.extend(prefix.insert_owned(hashes[k:], ids))

    i, steps = 0, 0
    while True:
        while i < len(pending) and pending[i].arrival_step <= steps:
            sched.submit(pending[i])
            i += 1
        if sched.idle() and i >= len(pending):
            break
        sched.admit()
        prefix.pending_free.clear()  # no device: the push is virtual
        action = sched.next_action()
        if action[0] == "prefill":
            slot, chunk = action[1], action[3]
            survived, _ = sched.plan_prefill_evictions(slot, chunk)
            if survived:
                sched.note_prefill(slot, chunk)
                st = sched.slots[slot]
                if st.prefill_done:
                    insert(st)
                    st.tokens.append(0)
                    if len(st.tokens) >= st.request.max_new_tokens:
                        sched.finish(slot)
        elif action[0] == "decode":
            active, _ = sched.plan_evictions(action[1])
            if active:
                sched.note_decode(sched.decode_page_need(active), active)
                done = []
                for s in active:
                    st = sched.slots[s]
                    st.tokens.append(0)
                    if len(st.tokens) >= st.request.max_new_tokens:
                        done.append(s)
                for s in done:
                    sched.finish(s)
        prefix.pending_free.clear()
        steps += 1
        if steps > 1_000_000:  # pragma: no cover - trace arithmetic safety net
            break
    return prefix.hit_rate()


def _prefix_fields(engine, trace: list[Request]) -> dict:
    """The prefix-cache block of the serving report (zeros with the cache
    off): the measured hit rate (index-served cacheable pages over those
    demanded at admission, each request counted once) beside
    :func:`predicted_prefix_hit_rate`, the peak of pages aliased by more
    than one holder, copy-on-write forks, prompt tokens never recomputed
    and index reclaims."""
    prefix = getattr(engine, "prefix", None)
    fields = {
        "prefix_cache": "on" if prefix is not None else "off",
        "prefix_hit_rate": 0.0, "prefix_hit_rate_predicted": 0.0,
        "pages_shared_peak": 0, "cow_forks": 0, "prefill_tokens_skipped": 0,
        "prefix_evictions": 0,
    }
    if prefix is None:
        return fields
    rep = prefix.report()
    p = engine.plugin
    predicted = predicted_prefix_hit_rate(
        trace, num_slots=p.num_slots, num_pages=p.num_pages, page_size=p.page_size,
        pages_per_slot=p.pages_per_slot, prefill_chunk=p.prefill_chunk)
    fields.update(prefix_hit_rate=rep["prefix_hit_rate"], prefix_hit_rate_predicted=predicted,
                  pages_shared_peak=rep["pages_shared_peak"], cow_forks=rep["cow_forks"],
                  prefill_tokens_skipped=rep["prefill_tokens_skipped"],
                  prefix_evictions=rep["prefix_evictions"])
    twin_registry().record("prefix_cache.hit_rate", predicted=predicted,
                           measured=rep["prefix_hit_rate"],
                           source="serving/harness._prefix_fields")
    return fields


def _speculate_fields(engine, trace: list[Request], results: dict, wall_s: float,
                      draft_before: float = 0.0) -> dict:
    """The speculative-decode block of the serving report (zeros with
    speculation off): the measured accept rate (accepted / drafted) and
    tokens per slot per decode or verify pass, each beside the model-free
    replay of :func:`~.speculate.predicted_acceptance` over the measured
    streams (host-side providers only: a draft model's replay would decode
    the whole trace again, so its twin records the measured side alone),
    the draft time's share of this replay's wall time, and the pages rolled
    back off rejected drafts."""
    m = engine.metrics
    lanes = m["decode_lane_passes"]
    measured_tps = round(m["decode_emitted_tokens"] / lanes, 4) if lanes else 0.0
    drafted = m["draft_tokens"]
    measured_accept = round(m["accepted_draft_tokens"] / drafted, 4) if drafted else 0.0
    sp = engine.speculator
    fields = {
        "speculate": engine.speculate_mode, "speculate_k": sp.k if sp is not None else 0,
        "accept_rate": measured_accept, "accept_rate_predicted": 0.0,
        "tokens_per_step": measured_tps, "tokens_per_step_predicted": 0.0,
        "draft_overhead_frac": 0.0, "speculative_rollbacks": m["speculative_rollbacks"],
        "verify_steps": m["verify_steps"], "drafted_tokens": drafted,
        "accepted_draft_tokens": m["accepted_draft_tokens"],
    }
    if sp is None:
        return fields
    from .speculate import predicted_acceptance

    draft_s = sp.draft_time_s - draft_before
    fields["draft_overhead_frac"] = round(min(1.0, draft_s / wall_s), 6) if wall_s > 0 else 0.0
    reg = twin_registry()
    source = "serving/harness._speculate_fields"
    if sp.provider.programs == 0:  # model-free drafting: the replay is free
        pred = predicted_acceptance(trace, results, sp.provider, sp.k)
        fields["accept_rate_predicted"] = pred["accept_rate"]
        fields["tokens_per_step_predicted"] = pred["tokens_per_step"]
        reg.record("speculate.accept_rate", predicted=pred["accept_rate"],
                   measured=measured_accept, source=source)
        reg.record("speculate.tokens_per_step", predicted=pred["tokens_per_step"],
                   measured=measured_tps, source=source)
    else:
        reg.record("speculate.accept_rate", measured=measured_accept, source=source)
        reg.record("speculate.tokens_per_step", measured=measured_tps, source=source)
    return fields


def _adapter_fields(engine, trace: list[Request]) -> dict:
    """The multi-tenant block of the serving report (JAX
    ``_adapter_fields``): the pool's measured hit rate beside its
    LRU-replay prediction (both recorded as the ``adapter_pool.hit_rate``
    twin), swaps and swap bytes, and the trace's tenant census.  Zeros
    without a store."""
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

    predicted_hit = predicted_adapter_hit_rate(tenant_ids, store.plugin.pool_slots)
    twin_registry().record("adapter_pool.hit_rate", predicted=predicted_hit,
                           measured=store.hit_rate(), source="serving/harness._adapter_fields")
    return {
        "adapters": len({t for t in tenant_ids if t}),
        "adapter_requests": sum(1 for t in tenant_ids if t),
        "adapter_pool_slots": store.plugin.pool_slots,
        "lora_rank": store.plugin.rank,
        "adapter_pool_hit_rate": store.hit_rate(),
        "adapter_pool_hit_rate_predicted": predicted_hit,
        "adapter_swaps": store.swaps,
        "adapter_swap_bytes": store.swap_bytes,
    }


def replay(engine, trace: list[Request], *, verify_invariants: bool = False) -> dict:
    """Run the trace through the engine (warming it first) and compose the
    serving report; every field is present, zeros on an empty trace.

    Wall times are host clocks around work that ends in a device sync:
    every decode tick fetches its tokens, and the run ends with a
    ``torch.cuda.synchronize`` on a GPU engine.  With the engine's request
    tracing on, ``telemetry_overhead_frac`` / ``trace_spans`` are measured.
    ``verify_invariants=True`` checks the resource contract
    (:func:`~.overload.verify_serving_invariants`) after the run and raises
    on a violation."""
    if not engine.warmed_up:
        engine.warmup()
    tracer = engine.trace
    overhead_before = tracer.recorder.overhead_s if tracer is not None else 0.0
    sp = engine.speculator
    draft_before = sp.draft_time_s if sp is not None else 0.0
    t0 = time.perf_counter()
    results = engine.run(trace)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    wall_s = time.perf_counter() - t0
    if verify_invariants:
        from .overload import verify_serving_invariants

        problems = verify_serving_invariants(engine)
        if problems:
            raise RuntimeError("serving invariants violated after replay: "
                               + "; ".join(problems))
    m = engine.metrics
    p = engine.plugin
    scheduled = m["scheduled_decode_slots"] + m["prefill_scheduled_tokens"]
    useful = m["useful_decode_tokens"] + m["prefill_useful_tokens"]
    work_steps = m["decode_steps"] + m["verify_steps"] + m["prefill_steps"]
    total_steps = work_steps + m["idle_steps"]
    gen = m["generated_tokens"]
    overhead_s = tracer.recorder.overhead_s - overhead_before if tracer is not None else 0.0
    return {
        "device": str(engine.device),
        "requests": len(trace),
        "completed": len(results),
        "interrupted": engine.interrupted,
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
        **_speculate_fields(engine, trace, results, wall_s, draft_before=draft_before),
        **_prefix_fields(engine, trace),
        "telemetry_overhead_frac": (round(min(1.0, overhead_s / wall_s), 6)
                                    if wall_s > 0 else 0.0),
        "trace_spans": tracer.recorder.recorded if tracer is not None else 0,
        **_adapter_fields(engine, trace),
    }
