"""Traffic replay (mirrors ``accelerate_tpu/serving/harness.py``:
``synthesize_trace`` :32, ``predicted_pool_utilization`` :98,
``predicted_prefix_hit_rate`` :183, ``replay`` :263, ``_overload_fields``
:426, ``_prefix_fields`` :482, ``_speculate_fields`` :541,
``_adapter_fields`` :612, ``chaos_replay`` :647, ``static_batching_report``
:771).

Replays a seeded request trace (Poisson arrivals in virtual engine-step
time, mixed prompt/output lengths, optionally shared system preambles and
per-request deadlines) through a :class:`~.engine.ServingEngine` and
reports the serving metrics users feel: tokens per second, time to first
token and the per-token latency, in wall time; the KV pool's utilization,
the speculative-decode fields (acceptance, tokens per step, rollbacks),
the prefix cache's (hit rate, shared pages, skipped prefill), the adapter
pool's and the overload block (sheds, deadline misses, cancels, pages
reclaimed, request goodput, the ladder's stage), each measured rate beside
its predicted twin in :func:`~accelerate_tpu_torch.telemetry.twin_registry`.
:func:`chaos_replay` soaks an engine under a fault plan of serving faults
and holds the survivors' tokens to a fault-free replay of the survivors.

The JAX harness's ``strict_compiles`` and ``compiles_*`` fields count XLA
compiles after warmup; eager PyTorch compiles no program, so the port's
reports leave them out.
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
    deadline_range=None,
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
    shared-system-prompt traffic the prefix cache serves.  With
    ``deadline_range=(lo, hi)`` each request draws a ``deadline_ticks``
    uniformly from it.  Same seed -> the same trace as the JAX package's
    ``synthesize_trace``."""
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
        deadline = (int(rng.integers(deadline_range[0], deadline_range[1] + 1))
                    if deadline_range is not None else 0)
        trace.append(Request(uid=uid, prompt=prompt, max_new_tokens=n_new,
                             arrival_step=int(t), adapter_id=adapter_id,
                             deadline_ticks=deadline))
    return trace


def _percentile_ms(samples: list, q: float) -> float:
    if not samples:
        return 0.0
    return float(np.percentile(np.asarray(samples), q)) * 1e3


def predicted_pool_utilization(trace: list[Request], *, num_slots: int, num_pages: int,
                               page_size: int, pages_per_slot: int,
                               prefill_chunk: int) -> float:
    """The predicted twin of the measured KV-pool utilization: a model-free
    replay of the scheduler arithmetic over the trace, every request
    running to its full ``max_new_tokens`` (the error against the measured
    twin is the EOS early-exit traffic the trace cannot know about)."""
    if not trace:
        return 0.0
    from .scheduler import ContinuousBatchingScheduler

    sched = ContinuousBatchingScheduler(num_slots, num_pages, page_size, pages_per_slot,
                                        prefill_chunk, (prefill_chunk,))
    # page arithmetic only: adapter routing plays no part, so the replay
    # strips tenant ids
    pending = [dataclasses.replace(r, adapter_id=0)
               for r in sorted(trace, key=lambda r: (r.arrival_step, r.uid))]
    i, steps, page_step_sum = 0, 0, 0
    while True:
        while i < len(pending) and pending[i].arrival_step <= steps:
            sched.submit(pending[i])
            i += 1
        if sched.idle() and i >= len(pending):
            break
        sched.admit()
        action = sched.next_action()
        if action[0] == "prefill":
            slot, chunk = action[1], action[3]
            survived, _ = sched.plan_prefill_evictions(slot, chunk)
            if survived:
                sched.note_prefill(slot, chunk)
                st = sched.slots[slot]
                if st.prefill_done:
                    st.tokens.append(0)
                    if len(st.tokens) >= st.request.max_new_tokens:
                        sched.finish(slot)
        elif action[0] == "decode":
            active, _ = sched.plan_evictions(action[1])
            if active:
                sched.note_decode(sched.decode_page_need(active))
                done = []
                for s in active:
                    st = sched.slots[s]
                    st.tokens.append(0)
                    if len(st.tokens) >= st.request.max_new_tokens:
                        done.append(s)
                for s in done:
                    sched.finish(s)
        page_step_sum += sched.used_pages
        steps += 1
        if steps > 1_000_000:  # pragma: no cover - trace arithmetic safety net
            break
    return round(page_step_sum / max(steps, 1) / num_pages, 4)


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
        sched.tick = steps
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
    and index reclaims; and the pages and bytes a
    :class:`~.transfer.PagedKVTransport` streamed out of or into this
    engine (zeros without one)."""
    m = engine.metrics
    prefix = getattr(engine, "prefix", None)
    fields = {
        "prefix_cache": "on" if prefix is not None else "off",
        "prefix_hit_rate": 0.0, "prefix_hit_rate_predicted": 0.0,
        "pages_shared_peak": 0, "cow_forks": 0, "prefill_tokens_skipped": 0,
        "prefix_evictions": 0, "page_transfers": m["page_transfers"],
        "page_transfer_pages": m["page_transfer_pages"],
        "page_transfer_bytes": m["page_transfer_bytes"],
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


def _overload_fields(engine, trace: list[Request]) -> dict:
    """The overload block of the serving report (zeros on a clean run):
    sheds, deadline misses, cancels, pages reclaimed by cancels, request
    goodput (completed over completed plus deliberately retired), the
    adapter path's absorbed transfer retries and the ladder's standing.
    The ``serving.*`` twins always record their measured side; the
    predicted side is the clean-run model (no events, goodput 1.0), and
    records only when nothing could legitimately shed or expire: no fault
    plan, no overload knob armed, no deadline in the trace."""
    from ..resilience.faults import active_fault_plan

    sched = engine.sched
    completed = len(engine.results)
    retired = len(sched.retired_uids)
    goodput = round(completed / (completed + retired), 4) if completed + retired else 0.0
    store = getattr(engine, "adapters", None)
    retries = int(store.stats.transfer_retries) if store is not None else 0
    reg = twin_registry()
    measured = {
        "serving.requests_shed": sched.requests_shed,
        "serving.deadline_misses": sched.deadline_misses,
        "serving.cancelled": sched.cancelled,
        "serving.pages_reclaimed_on_cancel": sched.pages_reclaimed_on_cancel,
        "serving.request_goodput_frac": goodput,
    }
    clean_predictions = (
        active_fault_plan() is None
        and not sched.max_queue and not sched.kv_shed_watermark
        and not sched.default_deadline_ticks and not sched.shed_armed
        and not any(r.deadline_ticks for r in trace)
    )
    for name, value in measured.items():
        reg.record_measured(name, value, source="serving/harness._overload_fields")
        if clean_predictions:
            pred = 1.0 if name.endswith("request_goodput_frac") and trace else 0.0
            reg.record_predicted(name, pred, source="serving/harness clean-run model")
    return {
        "requests_shed": sched.requests_shed,
        "deadline_misses": sched.deadline_misses,
        "cancelled": sched.cancelled,
        "pages_reclaimed_on_cancel": sched.pages_reclaimed_on_cancel,
        "request_goodput_frac": goodput,
        "transfer_retries": retries,
        "ladder_stage": engine.ladder.stage,
        "ladder_engagements": engine.ladder.engagements,
    }


def replay(engine, trace: list[Request], *, slo_monitor=None,
           verify_invariants: bool = False) -> dict:
    """Run the trace through the engine (warming it first) and compose the
    serving report; every field is present, zeros on an empty trace.

    Wall times are host clocks around work that ends in a device sync:
    every decode tick fetches its tokens, and the run ends with a
    ``torch.cuda.synchronize`` on a GPU engine.  With the engine's request
    tracing on, ``telemetry_overhead_frac`` / ``trace_spans`` are measured.
    An :class:`~accelerate_tpu_torch.telemetry.SLOMonitor` passed as
    ``slo_monitor`` is fed the replay's per-token latency and TTFT samples
    (unless it is attached to the engine already, and saw them live).
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
    predicted_util = predicted_pool_utilization(
        trace, num_slots=p.num_slots, num_pages=p.num_pages, page_size=p.page_size,
        pages_per_slot=p.pages_per_slot, prefill_chunk=p.prefill_chunk)
    measured_util = m["page_step_sum"] / max(total_steps, 1) / p.num_pages
    twin_registry().record("kv_pool.utilization", predicted=predicted_util,
                           measured=measured_util, source="serving/harness.replay")
    if slo_monitor is not None and engine.slo is not slo_monitor:
        slo_monitor.observe_many("token_latency_s", engine.token_gaps_s)
        slo_monitor.observe_many("ttft_s", engine.ttft_s)
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
        "kv_pool_utilization": measured_util,
        "kv_pool_utilization_predicted": predicted_util,
        "kv_pool_peak_utilization": m["peak_used_pages"] / p.num_pages,
        "padding_waste_frac": 1.0 - useful / scheduled if scheduled else 0.0,
        "scheduled_token_efficiency": useful / scheduled if scheduled else 0.0,
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
        **_overload_fields(engine, trace),
        **_adapter_fields(engine, trace),
    }


def chaos_replay(engine_factory, trace: list[Request], plan, *, max_restarts: int = 8,
                 verify_invariants: bool = True, baseline_parity: bool = True) -> dict:
    """Seeded chaos soak: replay ``trace`` under a
    :class:`~accelerate_tpu_torch.resilience.FaultPlan` of serving faults
    (cancellation storms, deadline storms, adapter-transfer failures,
    preempts at a tick or mid-verify), building a fresh engine after every
    drain, until every request is completed, shed or cancelled.

    The pin: the survivors' greedy tokens equal a fault-free replay of the
    same surviving set — faults change which requests complete, never what
    a completed request says.  After every engine life the resource
    contract runs (:func:`~.overload.verify_serving_invariants`).
    ``engine_factory`` builds a fresh engine per life (warmed here unless
    it comes warm).  Returns the
    surviving ``results``, ``token_parity``, restart, fault and retirement
    counters,
    ``ladder_stages`` (the stages each life's ladder entered, in order)
    and ``invariant_problems``."""
    from ..resilience.faults import fault_plan as _fault_plan
    from .overload import verify_serving_invariants

    results: dict[int, list] = {}
    restarts = 0
    invariant_problems: list[str] = []
    ladder_stages: list[list[str]] = []
    counters = {"requests_shed": 0, "deadline_misses": 0, "cancelled": 0,
                "pages_reclaimed_on_cancel": 0, "transfer_retries": 0}
    pending = sorted(trace, key=lambda r: (r.arrival_step, r.uid))
    with _fault_plan(plan):
        while pending:
            engine = engine_factory()
            if not engine.warmed_up:
                engine.warmup()
            engine.run(pending)
            results.update(engine.results)
            sched = engine.sched
            for key in ("requests_shed", "deadline_misses", "cancelled",
                        "pages_reclaimed_on_cancel"):
                counters[key] += getattr(sched, key)
            store = getattr(engine, "adapters", None)
            if store is not None:
                counters["transfer_retries"] += int(store.stats.transfer_retries)
            ladder_stages.append([ev[1] for ev in sched.events if ev[0] == "ladder"])
            if verify_invariants:
                invariant_problems.extend(verify_serving_invariants(engine))
            if not engine.interrupted:
                break
            # drained: a fresh engine serves the rest (arrivals rebased —
            # the drain used up the virtual clock they were keyed on)
            pending = [dataclasses.replace(r, arrival_step=0)
                       for r in engine.remaining_requests()]
            restarts += 1
            if restarts > max_restarts:
                raise RuntimeError(f"chaos replay exceeded {max_restarts} restarts with "
                                   f"{len(pending)} requests still pending")
    if invariant_problems:
        raise RuntimeError("serving invariants violated during the chaos soak: "
                           + "; ".join(invariant_problems))
    token_parity = True
    if baseline_parity and results:
        # a fault-free replay of the surviving set, deadlines dropped and
        # admission control disarmed: the baseline measures what the
        # survivors say, not which of them a policy would keep
        survivors = [dataclasses.replace(r, arrival_step=0, deadline_ticks=0)
                     for r in sorted(trace, key=lambda r: r.uid) if r.uid in results]
        baseline = engine_factory()
        baseline.sched.max_queue = 0
        baseline.sched.kv_shed_watermark = 0.0
        baseline.sched.default_deadline_ticks = 0
        baseline.warmup()
        token_parity = baseline.run(survivors) == results
    total = len(trace)
    twin_registry().record_measured(
        "serving.request_goodput_frac", round(len(results) / total, 4) if total else 0.0,
        source="serving/harness.chaos_replay")
    return {
        "requests": total,
        "completed": len(results),
        "survivor_frac": round(len(results) / total, 4) if total else 0.0,
        "restarts": restarts,
        "faults_fired": len(plan.fired),
        "token_parity": token_parity,
        "invariant_problems": invariant_problems,
        "ladder_stages": ladder_stages,
        **counters,
        "results": results,
    }


def static_batching_report(per_request: list, num_slots: int) -> dict:
    """Slot arithmetic of the fixed-batch schedule ``generate()`` implies.

    ``per_request``: ``(prompt_len, generated_len)`` pairs in arrival order
    (the measured lengths of the continuous run, so both schedules account
    identical work).  Batches of ``num_slots`` run start to finish: prompts
    pad to the batch's longest, decode runs until its longest generation
    finishes, and every batch is ``num_slots`` wide."""
    if not per_request:
        return {"padding_waste_frac": 0.0, "scheduled_token_efficiency": 0.0,
                "scheduled_token_slots": 0, "useful_tokens": 0, "batches": 0}
    scheduled = useful = 0
    batches = [per_request[i:i + num_slots] for i in range(0, len(per_request), num_slots)]
    for batch in batches:
        max_prompt = max(p for p, _ in batch)
        max_gen = max(g for _, g in batch)
        scheduled += (max_prompt + max_gen) * num_slots
        useful += sum(p + g for p, g in batch)
    return {
        "padding_waste_frac": round(1.0 - useful / scheduled, 4),
        "scheduled_token_efficiency": round(useful / scheduled, 4),
        "scheduled_token_slots": scheduled,
        "useful_tokens": useful,
        "batches": len(batches),
    }
