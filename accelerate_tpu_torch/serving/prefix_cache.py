"""Content-addressed prefix cache: copy-on-write shared KV pages with
refcounted eviction (mirrors ``accelerate_tpu/serving/prefix_cache.py``:
``block_hashes`` :61, ``PrefixCache`` :109, ``unbounded_prefix_hit_rate``
:322, ``prefix_cache_accounting`` :345; ``hashlib`` only).

- **Content addressing**: every full page of a prompt gets a chained block
  hash, ``h_j = H(adapter_id, h_{j-1}, tokens[j*page:(j+1)*page])``, so a
  hash names the whole prefix up to that block.  The chain is seeded with
  the tenant's ``adapter_id`` (a LoRA tenant's K/V depends on its adapter:
  cross-tenant prompts never alias) and, for quantized pools, the
  ``kv_dtype``.  The bytes are the JAX package's, hash for hash.
- **Copy-on-write at page granularity**: only full pages are shared, and a
  match is capped at ``(prompt_len - 1) // page_size`` pages, so the last
  prompt token is always prefilled; writes land past the shared boundary
  only, so no copy ever runs.  A request that shares a proper prefix, then
  writes its own pages, counts as a **cow_fork**.
- **Refcounts**: ``refcount[page] = (1 if the index holds it) + (1 per
  occupied slot listing it in its shared prefix)``.  A page returns to the
  device free stack only when its refcount reaches zero; only index-only
  pages (refcount 1) are reclaimable, least recently used first.
- **Mirror discipline**: the scheduler owns the free-page count; this
  cache owns the page ids of the shared class.  Pages freed by refcount
  death or reclaim queue in :attr:`PrefixCache.pending_free` until the
  engine pushes them onto the device free stack (``push_free_step``);
  :meth:`PrefixCache.pop_pending` refuses to hand over a page that still
  holds a reference.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence

from .paged_cache import pages_for


def _block_digest(parent: bytes, tokens: Sequence[int], adapter_id: int) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(parent)
    h.update(adapter_id.to_bytes(8, "little", signed=False))
    for t in tokens:
        h.update(int(t).to_bytes(8, "little", signed=True))
    return h.digest()


def block_hashes(prompt: Sequence[int], page_size: int,
                 adapter_id: int = 0, kv_dtype: str = "") -> list[bytes]:
    """The prompt's chained block-hash ladder, one entry per CACHEABLE full
    page.  Capped at ``(len(prompt) - 1) // page_size``: the last page is
    never cacheable even when the prompt is page-aligned, so a fully-cached
    admission still prefills at least one real token (the decode loop needs
    the prompt's last-token logits — the COW contract's "first
    partially-filled page is always private" extends to "the last prompt
    token is always prefilled").

    ``kv_dtype`` seeds the chain: a quantized pool's page *content* is
    codes + scales, not bf16 rows, so an int8 pool's hashes must never
    collide with a bf16 or fp8 pool's — the scales are part of what the
    hash addresses."""
    full = max(0, (len(prompt) - 1)) // page_size
    out: list[bytes] = []
    parent = b"prefix-cache-v1"
    if kv_dtype and kv_dtype != "bf16":
        parent += b":kv=" + kv_dtype.encode("ascii")
    for j in range(full):
        parent = _block_digest(
            parent, prompt[j * page_size:(j + 1) * page_size], adapter_id
        )
        out.append(parent)
    return out


class PrefixCache:
    """Host-side content-addressed index + per-physical-page refcounts.

    Pure deterministic bookkeeping (no device access): the scheduler asks
    :meth:`match` during admission feasibility, :meth:`adopt` pins the hit
    pages when a request actually admits, the engine registers a completed
    prefill's new full pages via :meth:`insert_owned`, and every release
    path funnels through :meth:`unref_pages`.  Pages whose refcount hits
    zero queue in :attr:`pending_free` for the engine's next
    ``push_free_step``.
    """

    def __init__(self, page_size: int, kv_dtype: str = ""):
        self.page_size = page_size
        self.kv_dtype = kv_dtype  # seeds the hash chain: codes+scales content
        self.index: dict[bytes, int] = {}        # chain hash -> physical page
        self.page_hash: dict[int, bytes] = {}    # reverse map
        self.refcount: dict[int, int] = {}       # page -> index hold + slot holds
        self.pending_free: list[int] = []        # refcount-0 pages awaiting the
                                                 # engine's push_free program
        self._lru_clock = 0
        self._last_use: dict[bytes, int] = {}    # hash -> LRU stamp
        self.stats = {
            "lookup_pages": 0,          # cacheable pages demanded at admission
            "hit_pages": 0,             # of those, served from the index
            "admission_hits": 0,        # admissions with hit_pages > 0
            "admission_lookups": 0,     # admissions with cacheable pages > 0
            "cow_forks": 0,             # proper-prefix hits (shared then diverged)
            "prefill_tokens_skipped": 0,
            "pages_shared_peak": 0,     # peak pages with refcount >= 2
            "prefix_evictions": 0,      # LRU reclaims + flush drops
            "inserted_pages": 0,
        }

    # -- hashing / lookup ----------------------------------------------------

    def block_hashes(self, prompt: Sequence[int], adapter_id: int = 0) -> list[bytes]:
        return block_hashes(prompt, self.page_size, adapter_id, self.kv_dtype)

    def match(self, hashes: Sequence[bytes]) -> list[int]:
        """Physical page ids of the longest indexed prefix of ``hashes``.
        Pure lookup — no refcount or stats mutation (admission feasibility
        probes may call it repeatedly; :meth:`adopt` commits)."""
        out: list[int] = []
        for h in hashes:
            page = self.index.get(h)
            if page is None:
                break
            out.append(page)
        return out

    def hit_tokens(self, prompt: Sequence[int], adapter_id: int = 0) -> int:
        """Prefill tokens the longest cached prefix would skip (a pure
        probe — the scheduler's admission-need arithmetic)."""
        return len(self.match(self.block_hashes(prompt, adapter_id))) * self.page_size

    # -- refcount lifecycle --------------------------------------------------

    def _touch(self, h: bytes) -> None:
        self._lru_clock += 1
        self._last_use[h] = self._lru_clock

    def _note_shared_peak(self) -> None:
        shared = sum(1 for c in self.refcount.values() if c >= 2)
        if shared > self.stats["pages_shared_peak"]:
            self.stats["pages_shared_peak"] = shared

    def adopt(self, hashes: Sequence[bytes], count: bool = True) -> list[int]:
        """Commit an admission's longest-prefix hit: ref every hit page (one
        slot hold each), stamp LRU, and account the hit/miss/cow-fork
        stats.  Returns the adopted page ids (the slot's shared prefix).

        ``count=False`` skips the hit-RATE counters (an evicted request's
        readmission re-hits its own inserted pages — real prefill saved,
        so ``prefill_tokens_skipped`` still accrues, but the hit-rate twin
        counts each request's OFFERED traffic once: its predicted side is
        a trace replay that cannot see recompute-on-readmit churn)."""
        hit = self.match(hashes)
        if hashes and count:
            self.stats["admission_lookups"] += 1
            self.stats["lookup_pages"] += len(hashes)
        if not hit:
            return []
        self.stats["prefill_tokens_skipped"] += len(hit) * self.page_size
        if count:
            self.stats["admission_hits"] += 1
            self.stats["hit_pages"] += len(hit)
            if len(hit) < len(hashes):
                # shared a proper prefix, then writes its own divergent
                # pages — the copy-on-write fork (the fork point is a page
                # boundary, so no copy ever runs; the first partial page is
                # private already)
                self.stats["cow_forks"] += 1
        for h, page in zip(hashes, hit):
            self.refcount[page] = self.refcount.get(page, 0) + 1
            self._touch(h)
        self._note_shared_peak()
        return hit

    def ref_pages(self, pages: Sequence[int]) -> None:
        for p in pages:
            self.refcount[p] = self.refcount.get(p, 0) + 1
        self._note_shared_peak()

    def unref_pages(self, pages: Sequence[int]) -> int:
        """Drop one hold per page (a releasing slot's shared prefix, or an
        index entry letting go).  Pages reaching refcount zero leave the
        refcount map and queue in :attr:`pending_free`; returns how many
        did (the scheduler adds them to its free-page mirror — the device
        push is the engine's next ``push_free`` dispatch)."""
        freed = 0
        for p in pages:
            c = self.refcount.get(p)
            if c is None:
                raise RuntimeError(
                    f"unref of page {p} which holds no reference — a "
                    "refcount bug (double release?)"
                )
            if c == 1:
                del self.refcount[p]
                self.pending_free.append(p)
                freed += 1
            else:
                self.refcount[p] = c - 1
        return freed

    def insert_owned(self, hashes: Sequence[bytes], pages: Sequence[int]) -> list[int]:
        """Register a completed prefill's NEW full pages (hash -> page),
        taking BOTH the index hold and the inserting slot's hold (the page
        was the slot's private page; it is shared-class from here on).
        Insertion stops at the first already-indexed hash so every slot's
        shared set stays a contiguous block-table row prefix (a concurrent
        identical prefill that lost the race keeps its duplicate page
        private — correctness over hit rate).  Returns the page ids
        actually inserted."""
        out: list[int] = []
        for h, p in zip(hashes, pages):
            if h in self.index:
                break
            self.index[h] = int(p)
            self.page_hash[int(p)] = h
            # index hold + the inserting slot's hold
            self.refcount[int(p)] = self.refcount.get(int(p), 0) + 2
            self._touch(h)
            out.append(int(p))
        self.stats["inserted_pages"] += len(out)
        self._note_shared_peak()
        return out

    # -- eviction ------------------------------------------------------------

    def reclaim_one(self, protect: frozenset = frozenset()) -> Optional[int]:
        """LRU-evict ONE index-only page (refcount == 1: held by the index
        and no live slot — the AdapterStore rule: a shared hot page is
        never an eviction victim).  ``protect`` exempts page ids the caller
        has matched but not yet adopted (admission must not reclaim the
        very pages it is about to pin — the match→adopt window).  Returns
        the freed page id (already in :attr:`pending_free`) or ``None``
        when nothing is reclaimable."""
        victim = None
        for h in sorted(self.index, key=lambda h: self._last_use.get(h, 0)):
            page = self.index[h]
            if page not in protect and self.refcount.get(page, 0) == 1:
                victim = h
                break
        if victim is None:
            return None
        page = self._drop_entry(victim)
        self.stats["prefix_evictions"] += 1
        return page

    def _drop_entry(self, h: bytes) -> Optional[int]:
        page = self.index.pop(h)
        self.page_hash.pop(page, None)
        self._last_use.pop(h, None)
        freed = self.unref_pages([page])
        return page if freed else None

    def flush(self) -> int:
        """Drop EVERY index hold (the ``prefix`` fault: a cache-invalidation
        storm).  Entries still referenced by live slots keep their slot
        holds — their pages free later through the normal release path;
        index-only pages queue for the device push now.  Returns how many
        pages freed immediately."""
        freed = 0
        for h in list(self.index):
            if self._drop_entry(h) is not None:
                freed += 1
            self.stats["prefix_evictions"] += 1
        return freed

    def pop_pending(self) -> list[int]:
        """Drain the pages owed to the device free stack.  Hard-asserts the
        double-free exclusion: a page id queued here must hold ZERO
        references — pushing a still-referenced page is exactly the
        corruption a refcount bug causes (two owners of one physical page),
        and it must fail loudly at the host boundary, never reach the
        device."""
        out, self.pending_free = self.pending_free, []
        for p in out:
            if self.refcount.get(p, 0) != 0:
                self.pending_free = out  # leave state inspectable
                raise RuntimeError(
                    f"page {p} queued for the free stack while still "
                    f"referenced (refcount={self.refcount[p]}) — refcount "
                    "double-free guard"
                )
        return out

    # -- reporting -----------------------------------------------------------

    @property
    def shared_pages(self) -> int:
        """Pages currently in the shared class (refcount > 0)."""
        return len(self.refcount)

    def hit_rate(self) -> float:
        """Measured hit rate: index-served cacheable pages over cacheable
        pages demanded, across every admission so far."""
        lk = self.stats["lookup_pages"]
        return round(self.stats["hit_pages"] / lk, 4) if lk else 0.0

    def report(self) -> dict:
        return {
            "prefix_hit_rate": self.hit_rate(),
            "pages_shared_peak": self.stats["pages_shared_peak"],
            "cow_forks": self.stats["cow_forks"],
            "prefill_tokens_skipped": self.stats["prefill_tokens_skipped"],
            "prefix_evictions": self.stats["prefix_evictions"],
            "indexed_pages": len(self.index),
            "shared_pages": self.shared_pages,
        }


def unbounded_prefix_hit_rate(trace, page_size: int) -> float:
    """The capacity-free UPPER model of the prefix hit rate: the
    content-addressed matching replayed over the trace in arrival order
    with an unbounded index, no pool pressure, and every request's
    cacheable pages visible the moment it arrives.  This is the dedup
    ceiling :func:`prefix_cache_accounting` reports; the registered twin's
    predicted side is the *scheduler replay*
    (:func:`~.harness.predicted_prefix_hit_rate`), which models slot
    concurrency and LRU reclaim exactly."""
    seen: set[bytes] = set()
    lookups = hits = 0
    for r in sorted(trace, key=lambda r: (r.arrival_step, r.uid)):
        hashes = block_hashes(r.prompt, page_size, r.adapter_id)
        lookups += len(hashes)
        for h in hashes:
            if h in seen:
                hits += 1
            else:
                break
        seen.update(hashes)
    return round(hits / lookups, 4) if lookups else 0.0


def prefix_cache_accounting(config, trace, page_size: int,
                            dtype_bytes: int = 2) -> dict:
    """Predicted prefix-reuse envelope for a trace + pool geometry: unique
    vs total cacheable pages (the dedup the index can deliver), prefill
    tokens skippable, and the HBM those shared pages pin (the
    ``kv_pool_accounting`` bytes/page unit)."""
    per_page = (2 * config.num_hidden_layers * page_size
                * config.num_key_value_heads * config.head_dim * dtype_bytes)
    total = unique = skippable = 0
    seen: set[bytes] = set()
    for r in sorted(trace, key=lambda r: (r.arrival_step, r.uid)):
        hashes = block_hashes(r.prompt, page_size, r.adapter_id)
        total += len(hashes)
        matched = 0
        for h in hashes:
            if h in seen:
                matched += 1
            else:
                break
        skippable += matched * page_size
        unique += sum(1 for h in hashes if h not in seen)
        seen.update(hashes)
    return {
        "page_size_tokens": page_size,
        "cacheable_pages_total": total,
        "cacheable_pages_unique": unique,
        "dedup_frac": round(1.0 - unique / total, 4) if total else 0.0,
        "prefill_tokens_skippable": skippable,
        "bytes_per_page": per_page,
        "shared_bytes_peak_upper": unique * per_page,
        "hit_rate_upper": unbounded_prefix_hit_rate(trace, page_size),
    }


__all__ = [
    "PrefixCache", "block_hashes", "unbounded_prefix_hit_rate",
    "prefix_cache_accounting",
]
