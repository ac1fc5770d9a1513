"""Multi-tenant adapter management: the device pool, hot-swap streaming and
LRU (mirrors ``accelerate_tpu/serving/adapters.py:59-400``).

:class:`AdapterStore` keeps a fixed-size device pool of stacked A/B
factors (``ops/lora.py`` geometry, slot 0 the null adapter) and hot-swaps
cold adapters in on demand:

- **cold tier**: each published adapter lives in host memory (pinned on a
  machine with a card) or, with ``offload_dir=``, in an
  :class:`~accelerate_tpu_torch.big_modeling.OffloadStore` of disk memmaps;
  publishing costs no device memory;
- **hot-swap streaming**: uploads go through
  :class:`~accelerate_tpu_torch.ops.streaming.LayerPrefetcher` (``depth=0``
  plus explicit :meth:`AdapterStore.prefetch`): on the card a pinned-host
  copy with ``non_blocking=True`` on a side stream, so the scheduler's
  prefetches for the waiting queue fly under the current step, and
  :meth:`AdapterStore.pin` makes the compute stream wait on the copy's
  event before the insert;
- **pool discipline**: the insert writes the slot in place
  (``pool[name][f][slot].copy_``), so a model handed ``store.pool`` always
  reads the current slots;
- **pinning**: every in-flight request holding tenant *t* keeps a refcount
  on its slot; LRU eviction only considers refcount-0 tenants.

Slots, evictions, hits, swaps and ``swap_bytes`` follow the JAX store
exactly over the same publish / prefetch / pin / unpin sequence.
``LoraTrainer`` (per-adapter fine-tuning) is ROADMAP item A11e.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.lora import (
    DEFAULT_LORA_TARGETS,
    adapter_param_count,
    init_adapter_params,
    init_lora_pool,
    lora_spec,
)
from ..ops.streaming import LayerPrefetcher, StreamStats, predicted_overlap, stage_tree
from ..resilience.faults import maybe_fail_transfer
from ..resilience.retry import DEFAULT_POLICY, with_retries
from ..utils.dataclasses import LoraPlugin

_FACTORS = ("a", "b")


class AdapterPoolFullError(RuntimeError):
    """Every pool slot is pinned by an in-flight request (admission checks
    :meth:`AdapterStore.can_pin` first, so seeing this raised means a
    scheduling bug, not an operational condition)."""


class AdapterStore:
    """Fixed-size device adapter pool with LRU hot-swap over a cold tier.

    >>> store = AdapterStore(model, LoraPlugin(pool_slots=4))
    >>> store.publish(7, adapter)              # cold tier, no device memory
    >>> slot, swapped = store.pin(7)           # resident + refcounted
    >>> model(ids, adapter_ids=slots, lora=store.pool)
    >>> store.unpin(7)                         # eligible for LRU eviction

    ``model`` gives the target modules (:func:`~..ops.lora.lora_spec`) and
    the device; ``pool`` is ``{module name: {"a": [P+1, d_in, r], "b":
    [P+1, r, d_out]}}`` on that device, updated in place.  An adapter is
    ``{module name: {"a": [d_in, r], "b": [r, d_out]}}``.
    """

    def __init__(self, model, plugin: Optional[LoraPlugin] = None, *,
                 dtype=torch.bfloat16, offload_dir: Optional[str] = None, device=None):
        self.plugin = plugin or LoraPlugin()
        p = self.plugin
        self.device = torch.device(device) if device is not None else model.device
        self.spec = lora_spec(model, p.targets or DEFAULT_LORA_TARGETS)
        self.dtype = dtype
        self.pool = init_lora_pool(self.spec, p.pool_slots, p.rank, dtype, self.device)
        self._offload = None
        if offload_dir is not None:
            from ..big_modeling import OffloadStore

            self._offload = OffloadStore(offload_dir, autoflush=False)
        self._host: dict[int, dict] = {}
        self._tids: list[int] = []           # registration order (prefetch index)
        self._idx_of: dict[int, int] = {}
        self.slot_of: dict[int, int] = {}    # resident tenant -> pool slot
        self.tid_of: dict[int, int] = {}     # pool slot -> tenant
        self.free_slots: list[int] = list(range(1, p.pool_slots + 1))
        self.refcount: dict[int, int] = {}
        self._last_use: dict[int, int] = {}
        self._use_seq = 0
        self.stats = StreamStats()
        self.hits = 0
        self.swaps = 0
        self._prefetcher: Optional[LayerPrefetcher] = None

    # -- cold tier ----------------------------------------------------------

    def _host_leaf(self, leaf) -> torch.Tensor:
        t = torch.as_tensor(leaf).detach().to("cpu").contiguous()
        if self.device.type == "cuda":
            t = t.pin_memory()   # the side-stream copy reads it asynchronously
        return t

    def publish(self, tid: int, tree: dict) -> None:
        """Register tenant ``tid``'s adapter (``{path: {"a", "b"}}`` in the
        store's :attr:`spec` schema) in the cold tier, in the dtype it
        comes in.  Re-publishing a known tenant drops any staged copy of the
        old weights and refreshes a resident slot in place at once."""
        if tid < 1:
            raise ValueError(f"adapter id must be >= 1 (0 is the null adapter), got {tid}")
        have = {f"{path}/{f}" for path, fac in tree.items()
                for f in (fac if isinstance(fac, dict) else ())}
        want = {f"{path}/{f}" for path in self.spec for f in _FACTORS}
        if have != want:
            raise ValueError(
                f"adapter {tid} tree does not match the store spec: "
                f"missing {sorted(want - have)[:3]}, extra {sorted(have - want)[:3]}"
            )
        if self._offload is not None:
            for path in self.spec:
                for f in _FACTORS:
                    self._offload.save(f"adapter_{tid}/{path}/{f}", tree[path][f])
            self._offload.flush()
        else:
            self._host[tid] = {path: {f: self._host_leaf(tree[path][f]) for f in _FACTORS}
                               for path in self.spec}
        if tid not in self._idx_of:
            self._idx_of[tid] = len(self._tids)
            self._tids.append(tid)
            self._prefetcher = None  # registry grew: rebuild lazily
        else:
            if self._prefetcher is not None:
                self._prefetcher.invalidate(self._idx_of[tid])
            if tid in self.slot_of:
                self._insert(self._ensure_prefetcher().get(self._idx_of[tid]),
                             self.slot_of[tid])

    def publish_random(self, tid: int, generator: torch.Generator, *,
                       init_b: str = "normal") -> dict:
        """Publish a seeded random adapter (benches and tests)."""
        tree = init_adapter_params(generator, self.spec, self.plugin.rank,
                                   alpha=self.plugin.alpha, dtype=self.dtype, init_b=init_b)
        self.publish(tid, tree)
        return tree

    def known(self, tid: int) -> bool:
        return tid in self._idx_of

    def _host_tree(self, tid: int) -> dict:
        if self._offload is not None:
            def attempt():
                maybe_fail_transfer("adapter_memmap")
                return {path: {f: self._offload.load_tensor(f"adapter_{tid}/{path}/{f}")
                               for f in _FACTORS} for path in self.spec}

            return with_retries(attempt, policy=DEFAULT_POLICY,
                                site=f"adapter_memmap[{tid}]", on_retry=self._on_retry)
        return self._host[tid]

    def _on_retry(self, site, attempt, exc) -> None:
        self.stats.transfer_retries += 1

    # -- hot-swap streaming -------------------------------------------------

    def _ensure_prefetcher(self) -> LayerPrefetcher:
        if self._prefetcher is None or self._prefetcher.n_layers != len(self._tids):
            def fetch(idx):
                maybe_fail_transfer("adapter_transfer")
                return stage_tree(self._host_tree(self._tids[idx]), self.device)

            self._prefetcher = LayerPrefetcher(fetch, max(1, len(self._tids)), depth=0,
                                               stats=self.stats)
        return self._prefetcher

    def _insert(self, staged: dict, slot: int) -> None:
        """Write one adapter into pool slot ``slot`` in place (cast to the
        pool's dtype), on the current stream."""
        for path, fac in self.pool.items():
            for f in _FACTORS:
                fac[f][slot].copy_(staged[path][f])

    def warmup_insert(self) -> None:
        """One zeros insert into the null slot (zeros over zeros: the slot-0
        invariant holds), as JAX's warmup runs its insert program once."""
        self._insert({path: {f: torch.zeros_like(fac[f][0]) for f in _FACTORS}
                      for path, fac in self.pool.items()}, 0)

    def prefetch(self, tid: int) -> bool:
        """Start tenant ``tid``'s upload now (no wait), so a later
        :meth:`pin` finds it in flight.  No pool slot is taken yet."""
        if tid == 0 or tid in self.slot_of or not self.known(tid):
            return False
        return self._ensure_prefetcher().prefetch(self._idx_of[tid])

    # -- pinning / LRU ------------------------------------------------------

    def resident(self, tid: int) -> bool:
        return tid == 0 or tid in self.slot_of

    def _evictable(self) -> Optional[int]:
        """The LRU resident tenant no in-flight request holds (oldest last
        use, tid breaking ties)."""
        candidates = [t for t in self.slot_of if self.refcount.get(t, 0) == 0]
        if not candidates:
            return None
        return min(candidates, key=lambda t: (self._last_use.get(t, 0), t))

    def can_pin(self, tid: int) -> bool:
        """Could :meth:`pin` succeed right now (resident, or a free / LRU-
        evictable slot exists)?  The admission gate."""
        if tid == 0 or tid in self.slot_of:
            return True
        return self.known(tid) and bool(self.free_slots or self._evictable() is not None)

    def pin(self, tid: int) -> tuple[int, bool]:
        """Make tenant ``tid``'s adapter resident and hold it (refcount).
        Returns ``(pool_slot, swapped)``; ``swapped`` is True when a cold
        adapter was streamed in.  Id 0 pins nothing and maps to slot 0."""
        if tid == 0:
            return 0, False
        self._use_seq += 1
        self._last_use[tid] = self._use_seq
        if tid in self.slot_of:
            self.refcount[tid] = self.refcount.get(tid, 0) + 1
            self.hits += 1
            return self.slot_of[tid], False
        if not self.known(tid):
            raise KeyError(f"adapter {tid} was never published")
        if self.free_slots:
            slot = self.free_slots.pop(0)
        else:
            victim = self._evictable()
            if victim is None:
                raise AdapterPoolFullError(
                    f"adapter {tid}: all {self.plugin.pool_slots} pool slots "
                    "are pinned by in-flight requests"
                )
            slot = self.slot_of.pop(victim)
            del self.tid_of[slot]
        self._insert(self._ensure_prefetcher().get(self._idx_of[tid]), slot)
        self.slot_of[tid] = slot
        self.tid_of[slot] = tid
        self.refcount[tid] = self.refcount.get(tid, 0) + 1
        self.swaps += 1
        return slot, True

    def unpin(self, tid: int) -> None:
        """Release one in-flight hold on ``tid`` (the adapter stays hot until
        LRU pressure claims its slot)."""
        if tid == 0:
            return
        n = self.refcount.get(tid, 0)
        if n <= 1:
            self.refcount.pop(tid, None)
        else:
            self.refcount[tid] = n - 1

    def slot(self, tid: int) -> int:
        return 0 if tid == 0 else self.slot_of[tid]

    # -- accounting ---------------------------------------------------------

    @property
    def swap_bytes(self) -> int:
        """Host-to-device bytes streamed by hot-swaps (the prefetcher's
        exact leaf accounting)."""
        return int(self.stats.h2d_bytes)

    def hit_rate(self) -> float:
        total = self.hits + self.swaps
        return round(self.hits / total, 4) if total else 0.0

    def pool_report(self) -> dict:
        return {
            "pool_slots": self.plugin.pool_slots,
            "resident": len(self.slot_of),
            "hits": self.hits,
            "swaps": self.swaps,
            "hit_rate": self.hit_rate(),
            "swap_bytes": self.swap_bytes,
        }


def predicted_adapter_hit_rate(adapter_ids, pool_slots: int) -> float:
    """Predicted twin of the measured pool hit rate: a model-free LRU replay
    over the trace's adapter ids in arrival order (one pin per request, no
    refcount pinning)."""
    resident: dict[int, int] = {}
    seq = hits = misses = 0
    for tid in adapter_ids:
        tid = int(tid)
        if tid == 0:
            continue
        seq += 1
        if tid in resident:
            hits += 1
        else:
            misses += 1
            if len(resident) >= pool_slots:
                victim = min(resident, key=lambda t: (resident[t], t))
                del resident[victim]
        resident[tid] = seq
    total = hits + misses
    return round(hits / total, 4) if total else 0.0


# the card the port serves on: an H100 with 80 GiB of HBM3 (nvidia-smi reads
# 81,559 MiB for the "NVIDIA H100 80GB HBM3")
_H100_HBM_BYTES = 80 * 2**30


def adapter_pool_accounting(spec: dict, *, rank: int, pool_slots: int,
                            dtype_bytes: int = 2, pcie_rate_gibs: float = 8.0,
                            decode_step_s: Optional[float] = None) -> dict:
    """Predicted device-pool ladder and swap-bandwidth envelope (JAX
    ``adapter_pool_accounting``).  The same fields and numbers, except that
    ``hbm_frac`` is the pool's share of one H100's 80 GB (key
    ``"h100_80GB"``) in place of JAX's three TPU memory sizes."""
    n_params = adapter_param_count(spec, rank)
    per_slot = n_params * dtype_bytes
    total = per_slot * (pool_slots + 1)  # + the null slot
    swap_s = per_slot / (pcie_rate_gibs * 2**30)
    gib = lambda b: round(b / 2**30, 6)
    out = {
        "rank": rank,
        "pool_slots": pool_slots,
        "params_per_adapter": n_params,
        "bytes_per_slot": per_slot,
        "pool_bytes": total,
        "pool_gib": gib(total),
        "hbm_frac": {"h100_80GB": round(total / _H100_HBM_BYTES, 8)},
        "swap_s_pred": round(swap_s, 9),
        "kind": "predicted",
    }
    if decode_step_s is not None:
        out["swap_overlap_frac_pred"] = round(predicted_overlap(swap_s, decode_step_s), 4)
    return out


class LoraTrainer:
    """Per-adapter LoRA fine-tuning against a frozen base model (JAX
    ``LoraTrainer``): not ported yet, ROADMAP item A11e."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "LoraTrainer (batched multi-tenant LoRA fine-tuning with per-adapter "
            "host optimizer state) is ROADMAP Queue A item A11e"
        )
