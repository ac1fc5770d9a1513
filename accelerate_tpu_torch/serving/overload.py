"""Overload control: the degradation ladder and the serving resource
contract (mirrors ``accelerate_tpu/serving/overload.py``:
``DegradationLadder`` :45, ``verify_serving_invariants`` :145,
``_verify_refcounted`` :239).

When p99 per-token latency, TTFT or occupancy breaches its SLO, the engine
sheds pressure in a deterministic order that costs the least quality
first, using only the steps :meth:`ServingEngine.warmup` already ran.  The
four stages, in escalation order:

1. **despeculate** — speculative verify passes stop; decode falls back to
   the plain single-token step (kernel #4 / #5).
2. **shrink_prefill** — prefill chunks clamp to the smallest prefill
   bucket, so long prompts stop monopolising ticks (kernel #6 / #7 runs at
   a width the buckets already have).
3. **tighten_admission** — admission keeps a free-page reserve
   (``ladder_reserve_frac`` of the pool) while the pool is contended, so
   in-flight sequences stop being evicted to make room for newcomers.
4. **shed** — the waiting line clamps to ``num_slots`` and sheds by the
   deterministic policy (oldest-beyond-deadline first, then the newcomer).

:func:`verify_serving_invariants` checks, exactly, that the host free-page
mirror equals the device allocator, that every physical page is free or
owned (with the prefix cache armed: shared pages counted once, refcounts
balancing the index and slot holds, no referenced page on the free stack),
that device sequence lengths match the host's, that slot accounting is
exact and that adapter refcounts balance the in-flight census.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

from .paged_cache import kv_pool_accounting, pages_for


def refuse_tensor_parallel(what: str, *engines) -> None:
    """Raise ``NotImplementedError`` naming ROADMAP item A13h.7 where any
    of ``engines`` serves a tp rank's module (``ServingEngine.tp`` > 1):
    ``what`` is not ported under tensor parallelism."""
    if any(e.tp > 1 for e in engines):
        raise NotImplementedError(f"{what} on a tensor-parallel engine is not ported yet "
                                  "(ROADMAP item A13h.7)")


class DegradationLadder:
    """Deterministic graceful-degradation state machine for one engine.

    Escalation is one stage per :meth:`escalate` call (an SLO trip, a
    deadline-storm fault, or an operator action); :meth:`relax` steps back
    down one stage, restoring that stage's knob.  Every transition appends
    ``("ladder", stage)`` to the scheduler's event log.  Wire an
    :class:`~accelerate_tpu_torch.telemetry.SLOMonitor` with
    :meth:`attach`: trips escalate, recoveries relax.
    """

    STAGES = ("normal", "despeculate", "shrink_prefill", "tighten_admission",
              "shed")

    def __init__(self, engine, *, reserve_frac: Optional[float] = None):
        self.engine = engine
        self.level = 0
        self.engagements = 0
        frac = (reserve_frac if reserve_frac is not None
                else engine.plugin.ladder_reserve_frac)
        self._reserve_pages = max(1, int(engine.plugin.num_pages * frac))
        self._saved_prefill_chunk = engine.plugin.prefill_chunk

    @property
    def stage(self) -> str:
        return self.STAGES[self.level]

    def escalate(self, metric=None, quantile=None, value=None) -> str:
        """Move one stage up (no-op at the top).  The optional arguments
        match the :class:`SLOMonitor` trip-callback signature."""
        refuse_tensor_parallel("the overload ladder", self.engine)
        if self.level >= len(self.STAGES) - 1:
            return self.stage
        self.level += 1
        self.engagements += 1
        self._set(self.level, True)
        self.engine.sched.events.append(("ladder", self.stage))
        return self.stage

    def relax(self, metric=None, quantile=None, value=None) -> str:
        """Step one stage down, restoring that stage's knob (no-op at
        normal)."""
        if self.level == 0:
            return self.stage
        self._set(self.level, False)
        self.level -= 1
        self.engine.sched.events.append(("ladder", self.stage))
        return self.stage

    def _set(self, level: int, on: bool) -> None:
        eng, sched = self.engine, self.engine.sched
        if level == 1:
            eng.despeculated = on
        elif level == 2:
            sched.prefill_chunk = (min(eng.plugin.prefill_buckets) if on
                                   else self._saved_prefill_chunk)
        elif level == 3:
            sched.admission_reserve_pages = self._reserve_pages if on else 0
        elif level == 4:
            sched.shed_armed = on

    def attach(self, monitor) -> None:
        """Wire an SLO monitor: trips escalate one stage, recoveries relax
        one.  Callbacks the monitor already carries keep firing — the
        ladder chains in front of them."""
        monitor.on_trip = _chained(self.escalate, monitor.on_trip)
        monitor.on_recover = _chained(self.relax, monitor.on_recover)

    def report(self) -> dict:
        return {"stage": self.stage, "level": self.level,
                "engagements": self.engagements}


def _chained(first, then):
    """A monitor callback that calls ``first`` and then ``then`` (the
    callback the monitor carried before, if any)."""
    def call(metric, quantile, value):
        first(metric, quantile, value)
        if then is not None:
            then(metric, quantile, value)
    return call


def verify_serving_invariants(engine) -> list[str]:
    """The serving resource contract, checked exactly (the reusable
    extension of ``ServingEngine.free_page_mirror_in_sync``).  Returns a
    list of violations — empty means every invariant holds:

    - host free-page mirror == device ``free_top``;
    - host page conservation: free + Σ ``pages_for(kv_tokens)`` over
      occupied slots == ``num_pages``;
    - device page conservation: the live free-stack entries are unique, and
      together with every live sequence's block-table prefix they cover the
      physical pages exactly once (zero leaked pages, zero double-owners);
      with prefix caching armed this becomes the REFCOUNTED contract
      (:func:`_verify_refcounted`): shared pages count once however many
      rows alias them, refcounts balance the index + slot holds exactly,
      the host shared-prefix mirror matches the device block-table rows,
      and no referenced page ever sits on the free stack (the double-free
      exclusion);
    - device ``seq_lens`` match the host ``kv_tokens`` per occupied slot and
      read 0 for free slots;
    - slot accounting: ``free_slots`` ∪ occupied == all slots, disjoint;
    - adapter refcounts balance the in-flight census per tenant;
    - the KV pool's bytes are :func:`~.paged_cache.kv_pool_accounting`'s
      at the engine's kv heads (a tp rank's: its heads' pages only).

    One host sync (the cache fetch) — a test/replay-time checker, never
    called from the hot path.
    """
    problems: list[str] = []
    sched = engine.sched
    cache = engine.cache
    page = sched.page_size
    prefix = getattr(engine, "prefix", None)
    free_top = int(cache["free_top"])
    if free_top != sched.free_pages:
        problems.append(
            f"free-page mirror diverged: device free_top={free_top} vs "
            f"host free_pages={sched.free_pages}"
        )
    stack = cache["free_stack"].cpu().numpy()[:max(free_top, 0)].tolist()
    if len(set(stack)) != len(stack):
        problems.append("free stack holds duplicate physical pages")
    seq_lens = cache["seq_lens"].cpu().numpy()
    block_tables = cache["block_tables"].cpu().numpy()
    if prefix is None:
        held = sum(int(pages_for(st.kv_tokens, page))
                   for st in sched.slots.values())
        if sched.free_pages + held != sched.num_pages:
            problems.append(
                f"host page conservation broken: free={sched.free_pages} + "
                f"held={held} != num_pages={sched.num_pages}"
            )
        owned: list[int] = []
        for slot in range(seq_lens.shape[0]):
            n = int(pages_for(int(seq_lens[slot]), page))
            owned.extend(int(p) for p in block_tables[slot, :n])
        if sorted(owned + stack) != list(range(sched.num_pages)):
            leaked = set(range(sched.num_pages)) - set(owned) - set(stack)
            doubled = [p for p, c in Counter(owned + stack).items() if c > 1]
            problems.append(
                f"device page conservation broken: leaked={sorted(leaked)} "
                f"double-owned={sorted(doubled)}"
            )
    else:
        problems.extend(_verify_refcounted(engine, stack, seq_lens,
                                           block_tables))
    for slot, st in sched.slots.items():
        if int(seq_lens[slot]) != st.kv_tokens:
            problems.append(
                f"slot {slot}: device seq_len={int(seq_lens[slot])} vs host "
                f"kv_tokens={st.kv_tokens}"
            )
    for slot in range(sched.num_slots):
        if slot not in sched.slots and int(seq_lens[slot]) != 0:
            problems.append(
                f"free slot {slot} still carries device seq_len="
                f"{int(seq_lens[slot])}"
            )
    if sorted(sched.free_slots + list(sched.slots)) != list(range(sched.num_slots)):
        problems.append(
            f"slot accounting broken: free={sched.free_slots} "
            f"occupied={sorted(sched.slots)}"
        )
    if engine.adapters is not None:
        in_flight = Counter(
            st.request.adapter_id for st in sched.slots.values()
            if st.request.adapter_id
        )
        for tid in set(in_flight) | set(engine.adapters.refcount):
            want, got = in_flight.get(tid, 0), engine.adapters.refcount.get(tid, 0)
            if want != got:
                problems.append(
                    f"adapter {tid}: refcount={got} vs {want} in-flight holds"
                )
    layers = cache["layers"]
    if layers:
        pages = layers[0]["k_pages"]
        kv_dtype = "" if "k_scales" not in layers[0] else (
            "int8" if pages.dtype == torch.int8 else "fp8")
        pool = sum(t.numel() * t.element_size() for layer in layers for t in layer.values())
        want = kv_pool_accounting(engine.model.config, sched.num_pages, page,
                                  pages.element_size(), kv_dtype,
                                  num_kv_heads=engine.kv_heads)["pool_bytes"]
        if pool != want:
            problems.append(f"KV pool of {pool} B vs kv_pool_accounting's {want} B at the "
                            f"engine's {engine.kv_heads} kv heads")
    return problems


def _verify_refcounted(engine, stack, seq_lens, block_tables) -> list[str]:
    """The refcounted page-conservation contract (prefix caching armed):

    - **mirror exact**: each occupied slot's host ``shared_pages`` list
      equals its device block-table row prefix (the COW release keep-count
      arithmetic depends on it);
    - **refcounts exact**: ``refcount[p] == (index holds p) + (slots
      listing p)`` — no phantom or missing holds;
    - **no referenced page on the free stack** — THE double-free a refcount
      bug causes (the host-side twin is ``PrefixCache.pop_pending``'s
      assertion);
    - **conservation**: free stack ∪ refcounted shared pages ∪ per-slot
      private pages covers the pool exactly once (zero leaks, zero double
      owners — a shared page counts ONCE however many rows alias it);
    - **drained**: no page stuck in ``pending_free`` across a tick boundary.
    """
    problems: list[str] = []
    sched = engine.sched
    prefix = engine.prefix
    page = sched.page_size
    slot_holds: Counter = Counter()
    private: list[int] = []
    for slot, st in sched.slots.items():
        k = len(st.shared_pages)
        total = int(pages_for(st.kv_tokens, page))
        row = [int(p) for p in block_tables[slot, :total]]
        if row[:k] != [int(p) for p in st.shared_pages]:
            problems.append(
                f"slot {slot}: shared-prefix mirror diverged — host "
                f"{st.shared_pages} vs device row {row[:k]}"
            )
        slot_holds.update(int(p) for p in st.shared_pages)
        private.extend(row[k:])
    index_pages = set(prefix.index.values())
    for p in set(slot_holds) | index_pages | set(prefix.refcount):
        want = slot_holds.get(p, 0) + (1 if p in index_pages else 0)
        got = prefix.refcount.get(p, 0)
        if want != got:
            problems.append(
                f"page {p}: refcount={got} vs {want} holds "
                f"(index={p in index_pages}, slots={slot_holds.get(p, 0)})"
            )
    shared = set(prefix.refcount)
    referenced_on_stack = shared & set(stack)
    if referenced_on_stack:
        problems.append(
            f"referenced pages on the free stack (double-free): "
            f"{sorted(referenced_on_stack)}"
        )
    if prefix.pending_free:
        problems.append(
            f"pending_free not drained across the tick boundary: "
            f"{prefix.pending_free}"
        )
    dup_private = [p for p, c in Counter(private).items() if c > 1]
    if dup_private:
        problems.append(f"private pages double-owned: {sorted(dup_private)}")
    cover = sorted(list(shared) + private + stack)
    if cover != list(range(sched.num_pages)):
        counts = Counter(list(shared) + private + stack)
        leaked = set(range(sched.num_pages)) - set(counts)
        doubled = [p for p, c in counts.items() if c > 1]
        problems.append(
            f"refcounted page conservation broken: free={len(stack)} + "
            f"shared={len(shared)} + private={len(private)} vs "
            f"pool={sched.num_pages}; leaked={sorted(leaked)} "
            f"double-class={sorted(doubled)}"
        )
    return problems


__all__ = ["DegradationLadder", "verify_serving_invariants"]
