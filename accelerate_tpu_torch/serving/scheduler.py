"""Continuous-batching scheduler (mirrors ``accelerate_tpu/serving/
scheduler.py``): iteration-level admission, chunked prefill and
page-pressure eviction.

Pure host-side, deterministic bookkeeping — the port keeps its own copy of
the JAX package's numpy logic.  Given the same request trace and plugin
knobs every decision (admission order, chunk sizes, interleave, evictions)
replays identically, and the ``events`` log equals the JAX scheduler's.
The host mirrors the device allocator's free count with the same
arithmetic (``paged_cache.pages_for``), so it evicts before a device-side
pop could underflow.

Policy:

- **Admission**: FIFO, with a **bounded-age adapter bypass** in
  multi-tenant mode.  A waiting request is admitted when a decode slot is
  free and the pool has pages for its whole prompt; a request carrying an
  ``adapter_id`` must also have its adapter pin-able in the
  :class:`~.adapters.AdapterStore` (admission pins it).  When the head of
  the line is blocked on adapter-pool contention, younger requests whose
  adapters are resident (or who carry none) may admit past it for at most
  ``max_bypass_age`` engine ticks; after that the line holds until the
  head admits.  The first two waiting requests' adapters, and a blocked
  head's, are prefetched each tick.
- **Chunked prefill**: admitted prompts prefill in chunks of at most
  ``prefill_chunk`` tokens, padded up to the smallest shape bucket.
- **Interleave**: prefill and decode alternate whenever both have work.
- **Eviction**: when a step needs more fresh pages than the pool has, the
  youngest admitted sequence is preempted — its pages are released and the
  request requeues at the head of the line (recompute-on-readmit).
- **Speculative reservations** (``speculate_k`` > 0): admission also
  demands the worst-case pages of the request's first verify pass, and a
  verify pass under page pressure first zeroes draft depths,
  youngest-admitted first (a ``("despeculate", slots)`` event), before it
  evicts anyone.  Page arithmetic follows the device's KV length
  (``SlotState.kv_tokens``), which a verify pass advances by the accepted
  drafts plus one.
- **Prefix reuse** (with a :class:`~.prefix_cache.PrefixCache`): admission
  matches the prompt's full-page prefix against the index, strikes the hit
  from the page demand, takes one refcount per hit page and starts chunked
  prefill at the hit boundary.  Page pressure reclaims index-only pages
  (least recently used first) before it evicts a live sequence, and a
  page some slot still shares is never a victim.  Every release path goes
  through ``_release_slot_pages``: private pages free by count, shared
  pages drop one refcount and free at zero.
- **Overload control**: the waiting line is bounded (``max_queue``) and
  sheds when the bound or the predicted KV pressure (used pages plus every
  queued prompt's admission demand, as a pool fraction, against
  ``kv_shed_watermark``) is exceeded.  The victim is deterministic: the
  oldest request beyond its deadline first, else the youngest arrival.
  Shedding never touches admitted sequences.  The degradation ladder
  (``serving/overload.py``) tightens admission with a free-page reserve
  and, at its top stage, clamps the line to ``num_slots``.
- **Deadlines**: a request carrying ``deadline_ticks`` expires that many
  engine ticks after ``arrival_step``; an expired queued request sheds
  (reason ``"deadline"``) and the engine cancels an expired in-flight one
  through :meth:`cancel_slot`.  Both count as ``deadline_misses``.
- **Cancellation**: :meth:`cancel_queued` / :meth:`cancel_slot` retire a
  request at any stage and release everything it holds (its pages through
  ``_release_slot_pages``, its slot, its adapter hold); ``retired_uids``
  records deliberate retirements so a drain never hands one back.

Every decision appends to ``events`` — ``("shed", uid, reason)``,
``("cancel", uid, stage, reason)`` and ``("ladder", stage)`` included.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

from .paged_cache import pages_for


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request.  ``arrival_step`` is in virtual engine-step
    time.  ``adapter_id`` is the requesting tenant's LoRA adapter (0 = the
    base model); admission maps it to a pool slot through the
    :class:`~.adapters.AdapterStore`.  ``deadline_ticks`` is the request's
    latency budget in the same virtual time: it expires ``deadline_ticks``
    ticks after ``arrival_step`` (0 = no deadline)."""

    uid: int
    prompt: tuple  # int token ids
    max_new_tokens: int
    arrival_step: int = 0
    adapter_id: int = 0
    deadline_ticks: int = 0

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)


@dataclasses.dataclass
class SlotState:
    """Host-side record of one occupied decode slot."""

    request: Request
    admit_seq: int                 # monotone admission counter (eviction order)
    prefilled: int = 0             # prompt tokens written so far
    tokens: Optional[list] = None  # generated token ids
    adapter_slot: int = 0          # device pool slot the request decodes with
    shared_pages: Optional[list] = None  # prefix-cache page ids this slot
                                   # holds a refcount on: always a
                                   # contiguous block-table row prefix
                                   # (adopted prefix + own inserted pages)
    kv_len: Optional[int] = None   # the device's KV length once a verify
                                   # pass set it (an EOS inside an accepted
                                   # window retires the host stream short of
                                   # the KV the pass wrote)
    finished: bool = False         # finished, pages held for a KV transfer
                                   # (a prefill-role engine's parked slot)

    def __post_init__(self):
        if self.tokens is None:
            self.tokens = []
        if self.shared_pages is None:
            self.shared_pages = []

    @property
    def prefill_done(self) -> bool:
        return self.prefilled >= self.request.prompt_len

    @property
    def seq_len(self) -> int:
        # tokens written into the KV cache (prompt prefix + decoded tokens;
        # the latest sampled token is written by the NEXT decode step)
        return self.prefilled + max(0, len(self.tokens) - 1)

    @property
    def kv_tokens(self) -> int:
        """Tokens resident in the device KV cache: ``seq_len`` unless a
        verify pass pinned ``kv_len``.  All page arithmetic (evict, finish,
        need) keys off this, so the host mirror follows the allocator."""
        return self.kv_len if self.kv_len is not None else self.seq_len


class ContinuousBatchingScheduler:
    """Deterministic admit/prefill/decode/evict policy over a fixed slot set.

    The engine asks :meth:`admit` each tick, then :meth:`next_action`; it
    reports executed work back through ``note_*`` so the host page mirror
    stays exact.  ``events`` is the decision log."""

    def __init__(self, num_slots: int, num_pages: int, page_size: int,
                 pages_per_slot: int, prefill_chunk: int, prefill_buckets: tuple,
                 adapters=None, max_bypass_age: int = 16, speculate_k: int = 0,
                 max_queue: int = 0, kv_shed_watermark: float = 0.0,
                 default_deadline_ticks: int = 0, prefix=None):
        self.num_slots = num_slots
        self.num_pages = num_pages
        self.page_size = page_size
        self.pages_per_slot = pages_per_slot
        self.prefill_chunk = prefill_chunk
        self.prefill_buckets = tuple(sorted(prefill_buckets))
        self.adapters = adapters             # AdapterStore (multi-tenant mode)
        self.prefix = prefix                 # PrefixCache (COW prefix reuse)
        self.max_bypass_age = max_bypass_age
        self.speculate_k = speculate_k       # admission reserves verify pages
        self.max_queue = max_queue           # waiting-line bound (0 = unbounded)
        self.kv_shed_watermark = kv_shed_watermark  # predicted-pressure shed (0 = off)
        self.default_deadline_ticks = default_deadline_ticks
        self.waiting: deque[Request] = deque()
        self.slots: dict[int, SlotState] = {}
        self.free_slots: list[int] = list(range(num_slots))
        self.free_pages = num_pages          # host mirror of the device stack
        self.tick = 0                        # virtual engine time (the engine
                                             # sets it each step)
        self._admit_counter = 0
        self._last_was_prefill = False
        self._head_block_age = 0             # ticks the line head has been
        self._head_block_uid = None          # adapter-blocked (fairness bound)
        self.events: list[tuple] = []        # the determinism log
        # overload and cancellation: the ladder sets the two knobs, the
        # counters feed the serving report
        self.admission_reserve_pages = 0     # tightened-admission free floor
        self.shed_armed = False              # the ladder's shed stage
        self.requests_shed = 0
        self.deadline_misses = 0
        self.cancelled = 0
        self.pages_reclaimed_on_cancel = 0
        self.retired_uids: set[int] = set()  # shed or cancelled: never
                                             # handed back by a drain
        self._force_expired: set[int] = set()  # the deadline storm's uids
        self.evicted_keep: dict[int, int] = {}  # slot -> shared-prefix page
                                             # count parked by evict() for
                                             # the engine's COW release
        self._prefix_counted: set[int] = set()  # uids already counted in
                                             # the hit-rate twin (readmits
                                             # skip the rate counters)

    # -- queueing -----------------------------------------------------------

    def submit(self, request: Request) -> None:
        if request.adapter_id:
            if self.adapters is None:
                raise ValueError(
                    f"request {request.uid} carries adapter_id="
                    f"{request.adapter_id} but the engine has no AdapterStore"
                )
            if not self.adapters.known(request.adapter_id):
                raise ValueError(
                    f"request {request.uid}: adapter {request.adapter_id} "
                    "was never published to the AdapterStore"
                )
        total = request.prompt_len + request.max_new_tokens
        cap = min(self.pages_per_slot, self.num_pages) * self.page_size
        if request.prompt_len < 1:
            raise ValueError(f"request {request.uid}: empty prompt")
        if request.max_new_tokens < 1:
            raise ValueError(
                f"request {request.uid}: max_new_tokens must be >= 1 "
                f"(got {request.max_new_tokens})"
            )
        if total > cap:
            raise ValueError(
                f"request {request.uid}: prompt+max_new_tokens={total} exceeds "
                f"the per-sequence KV capacity {cap} "
                f"(min(pages_per_slot={self.pages_per_slot}, "
                f"num_pages={self.num_pages}) * page_size={self.page_size})"
            )
        if request.deadline_ticks < 0:
            raise ValueError(
                f"request {request.uid}: deadline_ticks must be >= 0 "
                f"(got {request.deadline_ticks})"
            )
        if request.deadline_ticks == 0 and self.default_deadline_ticks:
            request = dataclasses.replace(request,
                                          deadline_ticks=self.default_deadline_ticks)
        self.waiting.append(request)
        self.events.append(("submit", request.uid))
        # backpressure at the door: the bound holds between ticks too
        if self.max_queue:
            while len(self.waiting) > self.max_queue:
                self._shed(self._shed_victim(), "queue")

    def requeue_front(self, request: Request) -> None:
        self.waiting.appendleft(request)

    def mark_prefix_counted(self, uids) -> None:
        """Pre-seed the once-only offered-traffic set behind the prefix
        hit-rate twin: a request already counted as offered traffic
        elsewhere does not count a second lookup at its admission here."""
        self._prefix_counted.update(uids)

    # -- deadlines / shedding / cancellation ---------------------------------

    def request_expired(self, req: Request) -> bool:
        """Has ``req``'s deadline passed at the current :attr:`tick`?  The
        deadline-storm fault force-expires live uids
        (:meth:`force_expire_all`)."""
        if req.uid in self._force_expired:
            return True
        return bool(req.deadline_ticks) and \
            self.tick >= req.arrival_step + req.deadline_ticks

    def force_expire_all(self) -> None:
        """Deadline storm: every live request (queued and in flight)
        expires now — queued ones shed on the next policy pass, in-flight
        ones are cancelled by the engine's deadline sweep."""
        self._force_expired.update(req.uid for req in self.waiting)
        self._force_expired.update(st.request.uid for st in self.slots.values())

    def _shed_victim(self) -> int:
        """Index into ``waiting`` of the shed victim: the oldest request
        beyond its deadline first (earliest arrival, uid breaking ties),
        else the youngest arrival — the newcomer backs off."""
        def age(i):
            return (self.waiting[i].arrival_step, self.waiting[i].uid)

        expired = [i for i, req in enumerate(self.waiting) if self.request_expired(req)]
        if expired:
            return min(expired, key=age)
        return max(range(len(self.waiting)), key=age)

    def _shed(self, idx: int, reason: str) -> Request:
        req = self.waiting[idx]
        del self.waiting[idx]
        self.requests_shed += 1
        # an expired victim is a deadline miss whatever triggered the shed
        if reason == "deadline" or self.request_expired(req):
            self.deadline_misses += 1
        self.retired_uids.add(req.uid)
        self._force_expired.discard(req.uid)
        self.events.append(("shed", req.uid, reason))
        return req

    def predicted_kv_pressure(self) -> float:
        """Predicted pool pressure if the whole waiting line admitted: used
        pages plus every queued prompt's admission demand, as a fraction of
        the pool (the ``kv_shed_watermark`` comparand)."""
        demand = sum(self.admission_page_need(r) for r in self.waiting)
        return (self.used_pages + demand) / self.num_pages

    def _enforce_queue_policy(self) -> None:
        """The per-tick admission-control pass, in order: (1) expired queued
        requests shed, (2) the queue bound holds, (3) predicted KV pressure
        sheds down to the watermark, (4) the ladder's shed stage clamps the
        line to ``num_slots``."""
        i = 0
        while i < len(self.waiting):
            if self.request_expired(self.waiting[i]):
                self._shed(i, "deadline")
            else:
                i += 1
        if self.max_queue:
            while len(self.waiting) > self.max_queue:
                self._shed(self._shed_victim(), "queue")
        if self.kv_shed_watermark:
            while self.waiting and self.predicted_kv_pressure() > self.kv_shed_watermark:
                self._shed(self._shed_victim(), "kv_pressure")
        if self.shed_armed:
            while len(self.waiting) > self.num_slots:
                self._shed(self._shed_victim(), "overload")

    def cancel_queued(self, uid: int, reason: str = "cancel") -> bool:
        """Retire a still-queued request.  Returns False when ``uid`` is not
        in the waiting line (the engine's cancel retries at whatever stage
        the request is in)."""
        for i, req in enumerate(self.waiting):
            if req.uid == uid:
                del self.waiting[i]
                self._retire_cancelled(req, "queued", reason, 0)
                return True
        return False

    def cancel_slot(self, slot: int, reason: str = "cancel") -> Request:
        """Retire an admitted request at whatever stage it is in (mid
        prefill or decoding): its slot, its pages (``_release_slot_pages``,
        the arithmetic finish and evict use; the engine releases the device
        side with the same keep counts first) and its adapter hold."""
        st = self.slots.pop(slot)
        freed = self._release_slot_pages(st)
        self.free_slots.append(slot)
        self.free_slots.sort()
        if self.adapters is not None:
            self.adapters.unpin(st.request.adapter_id)
        stage = "decode" if st.prefill_done else "prefill"
        self._retire_cancelled(st.request, stage, reason, freed)
        return st.request

    def _retire_cancelled(self, req: Request, stage: str, reason: str, freed: int) -> None:
        self.pages_reclaimed_on_cancel += freed
        if reason == "deadline":
            self.deadline_misses += 1
        else:
            self.cancelled += 1
        self.retired_uids.add(req.uid)
        self._force_expired.discard(req.uid)
        self.events.append(("cancel", req.uid, stage, reason))

    def _release_slot_pages(self, st: SlotState) -> int:
        """The one host-side page-release arithmetic (finish, evict and
        cancel all route through it): private pages — everything past the slot's
        shared prefix — free at once (the engine's COW release pushes
        exactly those); shared pages drop one refcount each, and only those
        reaching zero join the free count (they queue for the engine's
        ``push_free_step``).  Returns the pages added to the free mirror."""
        total = int(pages_for(st.kv_tokens, self.page_size))
        shared = len(st.shared_pages)
        freed = total - shared
        if shared and self.prefix is not None:
            freed += self.prefix.unref_pages(st.shared_pages)
        self.free_pages += freed
        return freed

    # -- admission ----------------------------------------------------------

    def _adapter_ready(self, req: Request) -> bool:
        return (self.adapters is None or req.adapter_id == 0
                or self.adapters.can_pin(req.adapter_id))

    def _pick_admissible(self) -> Optional[int]:
        """Index into ``waiting`` of the next request admission may take:
        the head when its adapter is pin-able, else — within the bounded
        bypass age — the first younger request that is.  ``None`` holds the
        line."""
        if self._adapter_ready(self.waiting[0]):
            return 0
        if self._head_block_age > self.max_bypass_age:
            return None  # fairness: the starved head gets the next free slot
        for i in range(1, len(self.waiting)):
            if self._adapter_ready(self.waiting[i]):
                return i
        return None

    def admit(self) -> list[int]:
        """Admit while a slot is free and the pool can hold the whole prompt
        (``submit`` already guarantees a lone sequence can never outgrow the
        pool): FIFO, except that a head blocked on adapter-pool contention
        is bypassed by adapter-ready requests for at most
        ``max_bypass_age`` ticks.  Admission pins the request's adapter and,
        with the prefix cache, adopts the prompt's cached prefix (one
        refcount per page; prefill starts at the hit boundary).  The
        admission-control pass (deadline expiry, queue bound, KV-pressure
        watermark) runs first, and a tightened ladder
        (:attr:`admission_reserve_pages`) keeps a free-page floor while
        any slot is occupied.  Returns the admitted slot ids."""
        self._enforce_queue_policy()
        if self.adapters is not None:
            # start the next arrivals' adapter uploads under this tick's work
            for req in list(self.waiting)[:2]:
                if req.adapter_id:
                    self.adapters.prefetch(req.adapter_id)
        if self.waiting and not self._adapter_ready(self.waiting[0]):
            head = self.waiting[0]
            # one fairness tick per engine step the head stays blocked
            if self._head_block_uid != head.uid:
                self._head_block_uid = head.uid
                self._head_block_age = 0
            self._head_block_age += 1
            if self.adapters is not None and head.adapter_id:
                # stream the starved tenant's adapter now, so its pin is a
                # hit the moment a pool slot frees
                self.adapters.prefetch(head.adapter_id)
        else:
            self._head_block_uid = None
            self._head_block_age = 0
        admitted = []
        while self.waiting and self.free_slots:
            idx = self._pick_admissible()
            if idx is None:
                break
            req = self.waiting[idx]
            hashes = hit = ()
            # the ladder's reserve applies only while the pool is contended:
            # an empty engine admits its head regardless (no idle spin)
            reserve = self.admission_reserve_pages if self.slots else 0
            if self.prefix is not None:
                hashes = self.prefix.block_hashes(req.prompt, req.adapter_id)
                hit = self.prefix.match(hashes)
                # anti-thrash headroom: a hit makes readmission almost free,
                # so an evicted request could take the pages a running slot
                # needs to grow, and the two evict each other forever; one
                # page of headroom per occupied slot (none when empty)
                reserve += len(self.slots)
            need = self.admission_page_need(req, hit_pages=len(hit))
            if need > self.free_pages - reserve:
                # index-only cached pages are the cheapest capacity: reclaim
                # them before refusing, but never the pages this admission
                # just matched, nor a page a live slot references
                self._reclaim(need + reserve, protect=frozenset(hit))
                if need > self.free_pages - reserve:
                    break
            del self.waiting[idx]
            adapter_slot = 0
            if self.adapters is not None and req.adapter_id:
                adapter_slot, swapped = self.adapters.pin(req.adapter_id)
                if swapped:
                    self.events.append(("swap", req.adapter_id, adapter_slot))
            if idx > 0:
                self.events.append(("bypass", req.uid, self.waiting[0].uid))
            slot = self.free_slots.pop(0)
            shared: list = []
            hit_tokens = 0
            if hashes:
                # commit the hit: a refcount on every shared page, prefill
                # from the hit boundary; a readmission skips the hit-rate
                # counters (the twin's predicted replay cannot see
                # recompute churn)
                shared = self.prefix.adopt(hashes, count=req.uid not in self._prefix_counted)
                self._prefix_counted.add(req.uid)
                hit_tokens = len(shared) * self.page_size
                if shared:
                    self.events.append(("prefix_hit", req.uid, hit_tokens))
                    if len(shared) < len(hashes):
                        self.events.append(("cow_fork", req.uid))
            self.slots[slot] = SlotState(req, self._admit_counter, adapter_slot=adapter_slot,
                                         shared_pages=shared, prefilled=hit_tokens)
            self._admit_counter += 1
            admitted.append(slot)
            self.events.append(("admit", req.uid, slot))
        return admitted

    def _reclaim(self, demand: int, protect: frozenset = frozenset()) -> int:
        """Free least recently used index-only prefix pages until
        ``free_pages >= demand`` (best effort).  Freed ids queue in the
        prefix cache's ``pending_free`` for the engine's next push; the host
        mirror counts them at once.  ``protect`` exempts matched but not yet
        adopted pages.  Returns the pages reclaimed."""
        freed = 0
        while self.free_pages < demand and self.prefix is not None:
            page = self.prefix.reclaim_one(protect)
            if page is None:
                break
            self.free_pages += 1
            freed += 1
            self.events.append(("prefix_evict", page))
        return freed

    def admission_page_need(self, req: Request, hit_pages: Optional[int] = None) -> int:
        """Pages admission demands before scheduling ``req``: its prompt,
        plus, with speculation, the worst-case pages of its first verify
        pass (positions ``prompt_len .. prompt_len + depth``, the depth
        clamped to the request's own budget, so the demand stays within
        what ``submit`` guaranteed).  With the prefix cache, the cached
        prefix's ``hit_pages`` come from the index, not the free pool
        (``None`` probes the index)."""
        if hit_pages is None:
            hit_pages = 0
            if self.prefix is not None:
                hit_pages = len(self.prefix.match(
                    self.prefix.block_hashes(req.prompt, req.adapter_id)))
        if not self.speculate_k:
            return pages_for(req.prompt_len, self.page_size) - hit_pages
        depth = min(self.speculate_k, req.max_new_tokens - 1)
        return pages_for(req.prompt_len + 1 + depth, self.page_size) - hit_pages

    # -- the per-tick decision ----------------------------------------------

    def prefilling_slots(self) -> list[int]:
        return sorted(
            (s for s, st in self.slots.items() if not st.prefill_done),
            key=lambda s: self.slots[s].admit_seq,
        )

    def decoding_slots(self) -> list[int]:
        return sorted(s for s, st in self.slots.items()
                      if st.prefill_done and not st.finished)

    def next_action(self):
        """``("prefill", slot, start, chunk_len, bucket)`` or
        ``("decode", slots)`` or ``("idle",)`` — prefill and decode
        alternate when both have work."""
        pre = self.prefilling_slots()
        dec = self.decoding_slots()
        do_prefill = bool(pre) and not (dec and self._last_was_prefill)
        if do_prefill:
            slot = pre[0]
            st = self.slots[slot]
            start = st.prefilled
            chunk = min(self.prefill_chunk, st.request.prompt_len - start)
            self._last_was_prefill = True
            return ("prefill", slot, start, chunk, self.bucket_for(chunk))
        self._last_was_prefill = False
        if dec:
            return ("decode", dec)
        return ("idle",)

    def bucket_for(self, chunk_len: int) -> int:
        for b in self.prefill_buckets:
            if b >= chunk_len:
                return b
        return self.prefill_buckets[-1]

    # -- page-pressure eviction ---------------------------------------------

    def decode_page_need(self, slots: list[int]) -> list[int]:
        """Slots whose next decode token crosses a page boundary (needs a
        fresh page this step)."""
        return [s for s in slots if self.slots[s].kv_tokens % self.page_size == 0]

    def verify_page_need(self, slots: list[int], spec_lens: dict) -> dict:
        """Worst-case fresh pages per slot for one verify pass: page starts
        among the written positions ``[kv, kv + spec_len]`` (the device pops
        them before the acceptance exists; it rolls the rejected ones
        back)."""
        from .speculate import speculative_page_need

        return {s: speculative_page_need(self.slots[s].kv_tokens, spec_lens.get(s, 0),
                                         self.page_size)
                for s in slots}

    def plan_speculative_evictions(self, slots: list[int],
                                   spec_lens: dict) -> tuple[list[int], list[int]]:
        """Fit the verify pass's worst-case page demand, degrading before
        evicting: under pressure, zero draft depths in ``spec_lens``
        (in place; the engine builds the pass from it), youngest-admitted
        first, down to the plain-decode floor (a depth-0 lane is plain
        decode), and only then run the shared evict-until-fit loop.
        Returns ``(surviving_slots, evicted_slots)``."""
        active = list(slots)

        def over():
            return sum(self.verify_page_need(active, spec_lens).values()) > self.free_pages

        degraded = []
        while over():
            victims = [s for s in sorted(active, key=lambda s: -self.slots[s].admit_seq)
                       if spec_lens.get(s, 0) > 0]
            if not victims:
                break
            spec_lens[victims[0]] = 0
            degraded.append(victims[0])
        if degraded:
            self.events.append(("despeculate", tuple(degraded)))
        evicted = self._evict_until(
            active,
            lambda a: sum(self.verify_page_need(a, spec_lens).values()) <= self.free_pages,
        )
        return active, evicted

    def _evict_until(self, active: list[int], fits) -> list[int]:
        """The one evict-until-fit loop (plain and speculative decode share
        it): reclaim one index-only prefix page and test again, else evict
        the youngest-admitted sequence — removing it from ``active`` when
        it was scheduled this tick — until ``fits(active)``.  Returns the
        evicted slots."""
        evicted = []
        while not fits(active):
            if self._reclaim(self.free_pages + 1):
                continue
            # a finished slot parked for a KV transfer is never a victim
            victims = sorted((s for s in self.slots if not self.slots[s].finished),
                             key=lambda s: -self.slots[s].admit_seq)
            if not victims:  # pragma: no cover - submit() capacity guard
                break
            victim = victims[0]
            self.evict(victim)
            evicted.append(victim)
            if victim in active:
                active.remove(victim)
        return evicted

    def plan_evictions(self, slots: list[int]) -> tuple[list[int], list[int]]:
        """Evict youngest-admitted sequences until this decode step's fresh
        pages fit the pool.  Returns ``(surviving_decode_slots,
        evicted_slots)``; the evicted requests are requeued at the front."""
        active = list(slots)
        evicted = self._evict_until(
            active, lambda a: len(self.decode_page_need(a)) <= self.free_pages
        )
        return active, evicted

    def plan_prefill_evictions(self, slot: int, chunk_len: int) -> tuple[bool, list[int]]:
        """Make room for one prefill chunk's fresh pages.  Prefers evicting
        OTHER sequences (youngest first); falls back to evicting the
        prefilling slot itself when it is the only tenant left.  Returns
        ``(slot_survived, evicted_slots)``."""
        evicted = []
        while True:
            st = self.slots.get(slot)
            if st is None:
                return False, evicted
            needed = (pages_for(st.prefilled + chunk_len, self.page_size)
                      - pages_for(st.prefilled, self.page_size))
            if needed <= self.free_pages:
                return True, evicted
            if self._reclaim(needed):  # index-only pages first, always
                continue
            victims = sorted(
                (s for s in self.slots if s != slot and not self.slots[s].finished),
                key=lambda s: -self.slots[s].admit_seq,
            ) or [slot]
            self.evict(victims[0])
            evicted.append(victims[0])

    def evict(self, slot: int) -> Request:
        st = self.slots.pop(slot)
        # the engine's COW release runs after this pop: park the keep count
        # so the release still skips the shared prefix
        if self.prefix is not None:
            self.evicted_keep[slot] = len(st.shared_pages)
        self._release_slot_pages(st)
        self.free_slots.append(slot)
        self.free_slots.sort()
        if self.adapters is not None:
            # drop this request's hold only: the adapter stays hot while
            # other in-flight requests share it
            self.adapters.unpin(st.request.adapter_id)
        self.requeue_front(st.request)
        self.events.append(("evict", st.request.uid, slot))
        return st.request

    # -- execution feedback (keeps the host page mirror exact) ---------------

    def note_prefill(self, slot: int, chunk_len: int) -> None:
        st = self.slots[slot]
        before = pages_for(st.prefilled, self.page_size)
        st.prefilled += chunk_len
        self.free_pages -= pages_for(st.prefilled, self.page_size) - before
        self.events.append(("prefill", st.request.uid, slot, st.prefilled))

    def note_decode(self, slots_needing_pages: list[int],
                    active_slots: Optional[list] = None) -> None:
        self.free_pages -= len(slots_needing_pages)
        for s in active_slots or ():
            # a slot whose kv_len an earlier verify pass set advances it: a
            # despeculated plain decode writes one KV position
            st = self.slots.get(s)
            if st is not None and st.kv_len is not None:
                st.kv_len += 1
        self.events.append(("decode", tuple(sorted(slots_needing_pages))))

    def note_verify(self, accepted: dict) -> None:
        """Execution feedback for one verify pass: ``accepted`` maps each
        dispatched slot to its accepted draft count ``m`` (the pass emitted
        ``m + 1`` tokens and kept the pages covering them; the rest rolled
        back on the device).  Advancing ``kv_len`` by ``m + 1`` keeps the
        host mirror exact."""
        consumed = 0
        for slot in sorted(accepted):
            m = int(accepted[slot])
            st = self.slots[slot]
            kv = st.kv_tokens
            consumed += int(pages_for(kv + m + 1, self.page_size) - pages_for(kv, self.page_size))
            st.kv_len = kv + m + 1
        self.free_pages -= consumed
        self.events.append(("verify", tuple((s, int(accepted[s])) for s in sorted(accepted))))

    def finish(self, slot: int) -> SlotState:
        """Retire a finished sequence: free its pages and its slot."""
        st = self.slots.pop(slot)
        st.finished = True
        self._release_slot_pages(st)
        self.free_slots.append(slot)
        self.free_slots.sort()
        if self.adapters is not None:
            self.adapters.unpin(st.request.adapter_id)
        self._force_expired.discard(st.request.uid)
        self.events.append(("finish", st.request.uid, slot))
        return st

    @property
    def used_pages(self) -> int:
        return self.num_pages - self.free_pages

    def idle(self) -> bool:
        return not self.waiting and not self.slots
