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

:class:`LoraTrainer` fine-tunes the tenants' adapters against the frozen
base: one batched forward and backward over a mixed-tenant batch, the
per-tenant optimizer updates on the card, each tenant's weights and state
parked in host memory between steps.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
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


# ---------------------------------------------------------------------------
# Fine-tuning: one batched multi-adapter step, per-tenant host state
# ---------------------------------------------------------------------------


def _jax_module_path(name: str) -> str:
    """The port's module name (``model.layers.0.self_attn.q_proj``) -> the
    JAX package's adapter path (``layers_0/self_attn/q_proj``), the key
    of JAX's adapter trees and of the ``w/`` entries of a saved adapter."""
    from ..models.hf_interop import hf_llama_key_map

    path = hf_llama_key_map(name + ".weight")
    if path is None or not path.startswith("params.") or not path.endswith(".kernel"):
        raise KeyError(f"no JAX adapter path for module {name!r}")
    return path[len("params."):-len(".kernel")].replace(".", "/")


def _state_fields(state) -> list:
    """The optimizer state's fields as ``(kind, value)``: ``"list"`` (a
    tensor per leaf), ``"hyper"`` (the hyperparameter dict), ``"tensor"``
    or ``"host"`` (a host int: the step count)."""
    out = []
    for value in state:
        if isinstance(value, torch.Tensor):
            out.append(("tensor", value))
        elif isinstance(value, (list, tuple)):
            out.append(("list", value))
        elif isinstance(value, dict):
            out.append(("hyper", value))
        else:
            out.append(("host", value))
    return out


def _state_tensors(state) -> list:
    """The state's per-leaf tensors in field order (the ``s/`` order of a
    saved adapter after the count), without the hyperparameters."""
    tensors = []
    for kind, value in _state_fields(state):
        if kind == "tensor":
            tensors.append(value)
        elif kind == "list":
            tensors.extend(value)
    return tensors


def _state_rebuilt(template, tensors: list, hyper=None, count=None):
    """``template``'s state type over ``tensors`` (in :func:`_state_tensors`
    order), with ``hyper`` for the hyperparameter dict and ``count`` for
    the host int where given."""
    it = iter(tensors)
    values = []
    for kind, value in _state_fields(template):
        if kind == "tensor":
            values.append(next(it))
        elif kind == "list":
            values.append(type(value)(next(it) for _ in value))
        elif kind == "hyper":
            values.append(value if hyper is None else hyper)
        else:
            values.append(value if count is None else type(value)(count))
    return type(template)(*values)


def _npz_safe(t: torch.Tensor) -> np.ndarray:
    """A numpy array for ``np.savez``: bf16, which numpy lacks, widens to
    f32, which holds each of its values exactly (the loader casts back,
    restoring the bits), as JAX's ``_npz_safe``."""
    t = t.detach().to("cpu")
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class LoraTrainer:
    """Fine-tune many tenants' LoRA adapters against one frozen base model
    (JAX ``LoraTrainer``).

    Each :meth:`step` takes a batch that mixes tenants (``adapter_ids``:
    one tenant id per row, 0 for the base model) and runs one batched
    forward and backward through the gathered adapter product
    (``ops/lora.py:lora_apply``, the stacked pool passed as the model's
    ``lora``): the gradients land in the stacked factors, each tenant's
    slice is taken in f32 and its :func:`~..optimizer.make_optimizer`
    update (``LoraPlugin.optimizer``, default ``lion-sr8``) runs on the
    card, leaf order and salts as JAX's.  Between steps every tenant's
    weights and optimizer state live in host memory (page-locked on a
    machine with a card): only the tenants of a step cross, both ways.
    The stack is always ``pool_slots + 1`` rows (slot 0 the null
    adapter, unused rows zeros), so its shapes never depend on how many
    tenants a batch mixes.

    ``model`` is the port's Llama; its parameters are frozen here
    (``requires_grad_(False)``).  Adapters are ``{module name: {"a", "b"}}``
    (the store's schema); :meth:`save` / :meth:`load` write JAX's file
    layout.  ``step_log`` holds the last step's host-to-device and
    device-to-host bytes and milliseconds.
    """

    def __init__(self, model, plugin: Optional[LoraPlugin] = None, *,
                 learning_rate: Optional[float] = None, seed: int = 0):
        from ..optimizer import make_optimizer

        self.model = model.requires_grad_(False)
        self.plugin = plugin or LoraPlugin()
        p = self.plugin
        self.spec = lora_spec(model, p.targets or DEFAULT_LORA_TARGETS)
        self.dtype = getattr(model.config, "dtype", torch.bfloat16)
        self.device = model.device
        self.tx = make_optimizer(p.optimizer, learning_rate, seed=seed)
        # (module name, factor) in the order JAX flattens an adapter tree:
        # the optimizer's leaf indices (its rounding salts) follow it
        self.leaves = sorted(((name, f) for name in self.spec for f in _FACTORS),
                             key=lambda nf: (*_jax_module_path(nf[0]).split("/"), nf[1]))
        self.adapters: dict[int, dict] = {}     # tid -> host adapter
        self.opt_states: dict[int, object] = {}  # tid -> host optimizer state
        self._hyper_dev: Optional[dict] = None
        self.step_log: dict = {}

    # -- host residency ------------------------------------------------------

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        t = t.detach().to("cpu").contiguous()
        return t.pin_memory() if self.device.type == "cuda" else t

    def _flat(self, tree: dict) -> list:
        return [tree[name][f] for name, f in self.leaves]

    def _tree(self, flat: list) -> dict:
        out: dict = {}
        for (name, f), t in zip(self.leaves, flat):
            out.setdefault(name, {})[f] = t
        return out

    def _park_state(self, state):
        return _state_rebuilt(state, [self._host(t) for t in _state_tensors(state)],
                              hyper=self._host_hyper(state))

    def _host_hyper(self, state):
        for kind, value in _state_fields(state):
            if kind == "hyper":
                return {k: self._host(v) if isinstance(v, torch.Tensor) else v
                        for k, v in value.items()}
        return None

    def add_adapter(self, tid: int, generator: Optional[torch.Generator] = None) -> dict:
        """A fresh adapter for tenant ``tid`` (``a`` random from a generator
        seeded with ``tid`` where JAX uses ``PRNGKey(tid)``, ``b`` zeros)
        and its optimizer state, both in host memory.  Returns the
        adapter."""
        if tid < 1:
            raise ValueError(f"adapter id must be >= 1, got {tid}")
        gen = generator if generator is not None else torch.Generator().manual_seed(tid)
        tree = init_adapter_params(gen, self.spec, self.plugin.rank, alpha=self.plugin.alpha,
                                   dtype=self.dtype)
        tree = {name: {f: self._host(fac[f]) for f in _FACTORS} for name, fac in tree.items()}
        self.adapters[tid] = tree
        self.opt_states[tid] = self._park_state(self.tx.init(self._flat(tree)))
        return tree

    # -- the batched step ----------------------------------------------------

    def _stack(self, tids: list, device_trees: Optional[dict] = None) -> dict:
        """The training pool: slot 0 null, slot ``i + 1`` tenant
        ``tids[i]``, zero rows up to ``pool_slots + 1``, on the card in
        the model's dtype.  ``device_trees``: the tenants' adapters
        already on the card."""
        p = self.plugin
        if len(tids) > p.pool_slots:
            raise ValueError(f"batch mixes {len(tids)} tenants > pool_slots={p.pool_slots}")
        pool = init_lora_pool(self.spec, p.pool_slots, p.rank, self.dtype, self.device)
        with torch.no_grad():
            for i, t in enumerate(tids):
                tree = (device_trees or {}).get(t, self.adapters[t])
                for name, fac in pool.items():
                    for f in _FACTORS:
                        fac[f][i + 1].copy_(tree[name][f], non_blocking=True)
        return pool

    def _loss(self, pool: dict, batch: dict, slot_ids: torch.Tensor):
        from ..models.llama import causal_lm_loss

        logits = self.model(batch["input_ids"], adapter_ids=slot_ids, lora=pool)
        return causal_lm_loss(logits, batch["labels"])

    def _batch(self, batch: dict) -> dict:
        return {k: torch.as_tensor(batch[k]).to(self.device) for k in ("input_ids", "labels")}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _state_on_device(self, state):
        if self.device.type != "cuda":
            return state
        if self._hyper_dev is None:
            self._hyper_dev = {k: v.to(self.device) if isinstance(v, torch.Tensor) else v
                               for k, v in (self._host_hyper(state) or {}).items()}
        return _state_rebuilt(state, [t.to(self.device, non_blocking=True)
                                      for t in _state_tensors(state)], hyper=self._hyper_dev)

    def _tenants(self, adapter_ids) -> tuple[list, dict, torch.Tensor]:
        """(the batch's tenants in slot order, tenant -> pool slot, the
        rows' slot ids on the card)."""
        ids = [int(t) for t in torch.as_tensor(adapter_ids).reshape(-1).tolist()]
        tids = sorted({t for t in ids if t != 0})
        for t in tids:
            if t not in self.adapters:
                raise KeyError(f"adapter {t} not added")
        slot_of = {t: i + 1 for i, t in enumerate(tids)}
        slot_ids = torch.tensor([slot_of.get(t, 0) for t in ids], dtype=torch.int32,
                                device=self.device)
        return tids, slot_of, slot_ids

    def _grads(self, batch, tids: list, slot_of: dict, slot_ids, dev_w: Optional[dict] = None):
        """One batched forward and backward: (loss, tenant -> its f32
        gradient slices in :attr:`leaves` order)."""
        pool = self._stack(tids, dev_w)
        leaves = [pool[name][f].requires_grad_() for name, f in self.leaves]
        loss = self._loss(pool, self._batch(batch), slot_ids)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), {t: [x[slot_of[t]].float() for x in grads] for t in tids}

    def tenant_grads(self, batch, adapter_ids) -> tuple[float, dict]:
        """The batched loss and each tenant's f32 gradients (``{module
        name: {"a", "b"}}``), without an update."""
        tids, slot_of, slot_ids = self._tenants(adapter_ids)
        loss, grads = self._grads(batch, tids, slot_of, slot_ids)
        return float(loss), {t: self._tree(g) for t, g in grads.items()}

    def step(self, batch, adapter_ids) -> float:
        """One batched multi-tenant step.  ``adapter_ids``: a tenant id per
        row (0: a base row, which adds to the loss and to no adapter's
        gradient).  Returns the mixed batch's loss."""
        tids, slot_of, slot_ids = self._tenants(adapter_ids)
        log = {"tenants": len(tids), "h2d_bytes": 0, "d2h_bytes": 0}
        # unpark: the step's tenants' weights and optimizer state to the card
        self._sync()
        t0 = time.perf_counter()
        dev_w, dev_s = {}, {}
        for t in tids:
            flat = self._flat(self.adapters[t])
            tensors = _state_tensors(self.opt_states[t])
            log["h2d_bytes"] += sum(x.numel() * x.element_size() for x in flat + tensors)
            dev_w[t] = self._tree([x.to(self.device, non_blocking=True) for x in flat])
            dev_s[t] = self._state_on_device(self.opt_states[t])
        self._sync()
        log["unpark_ms"] = (time.perf_counter() - t0) * 1e3
        loss, grads = self._grads(batch, tids, slot_of, slot_ids, dev_w)
        new = {t: self.tx.update(grads[t], dev_s[t], self._flat(dev_w[t])) for t in tids}
        # park: the new weights and state back to host memory
        self._sync()
        t1 = time.perf_counter()
        for t, (new_p, new_s) in new.items():
            if self.device.type == "cuda":
                host = self._flat(self.adapters[t]) + _state_tensors(self.opt_states[t])
                for h, x in zip(host, new_p + _state_tensors(new_s)):
                    h.copy_(x, non_blocking=True)
                    log["d2h_bytes"] += x.numel() * x.element_size()
                self.opt_states[t] = _state_rebuilt(self.opt_states[t],
                                                    _state_tensors(self.opt_states[t]),
                                                    count=new_s.count)
            else:
                self.adapters[t] = self._tree([x.detach() for x in new_p])
                self.opt_states[t] = new_s
        self._sync()
        log["park_ms"] = (time.perf_counter() - t1) * 1e3
        self.step_log = log
        return float(loss)

    def _groups(self, batch, adapter_ids) -> list:
        """The reference schedule's passes: for each id of the batch (0 the
        base rows), ``(id, its rows, their slot ids, their target
        tokens)``, the rows taken alone with that adapter alone."""
        ids = torch.as_tensor(adapter_ids).reshape(-1)
        b = self._batch(batch)
        out = []
        for t in sorted({int(x) for x in ids.tolist()}):
            rows = torch.nonzero(ids == t).reshape(-1).to(self.device)
            sub = {k: v.index_select(0, rows) for k, v in b.items()}
            slot_ids = torch.full((len(rows),), 1 if t != 0 else 0, dtype=torch.int32,
                                  device=self.device)
            out.append((t, sub, slot_ids, int((sub["labels"][:, 1:] != -100).sum())))
        return out

    def sequential_loss(self, batch, adapter_ids) -> float:
        """The reference schedule of the parity pin: the loss of each
        tenant's rows through a pass with that adapter alone, combined by
        token weight; equals :meth:`step`'s batched loss."""
        total, weight = 0.0, 0
        with torch.no_grad():
            for t, sub, slot_ids, n_tok in self._groups(batch, adapter_ids):
                total += float(self._loss(self._stack([t] if t else []), sub, slot_ids)) * n_tok
                weight += n_tok
        return total / max(weight, 1)

    def sequential_grads(self, batch, adapter_ids) -> dict:
        """The same schedule for the gradients: each tenant's f32 gradients
        (``{module name: {"a", "b"}}``) from a backward over its rows alone,
        scaled by their share of the batch's target tokens; equals
        :meth:`tenant_grads`' batched gradients."""
        groups = self._groups(batch, adapter_ids)
        weight = max(sum(n for *_, n in groups), 1)
        out = {}
        for t, sub, slot_ids, n_tok in groups:
            if t != 0:
                _, g = self._grads(sub, [t], {t: 1}, slot_ids)
                out[t] = self._tree([x * (n_tok / weight) for x in g[t]])
        return out

    # -- verified checkpointing ----------------------------------------------

    def save(self, ckpt_dir: str) -> str:
        """Atomic, verified save of every tenant's weights and optimizer
        state (JAX's layout): ``adapter_<tid>.npz`` per tenant with
        ``w/<JAX adapter path>/<a|b>`` weights and ``s/<i>`` state leaves
        (``s/0`` the step count, then the per-leaf tensors in the port's
        order, then the hyperparameters by name), staged under
        ``<dir>.tmp``, the size + crc32 manifest written last and published
        with one ``os.replace`` (``checkpointing._finalize_checkpoint``).
        A save over an existing directory (or a crashed save's ``.tmp``)
        clears it first."""
        import os
        import shutil

        from ..checkpointing import _finalize_checkpoint

        final = str(ckpt_dir)
        tmp = final + ".tmp"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for tid in sorted(self.adapters):
            w = {f"w/{_jax_module_path(name)}/{f}": _npz_safe(self.adapters[tid][name][f])
                 for name, f in self.leaves}
            np.savez(os.path.join(tmp, f"adapter_{tid}.npz"), **w,
                     **{f"s/{i}": a for i, a in enumerate(self._state_arrays(tid))})
        _finalize_checkpoint(tmp, final)
        return final

    def _state_arrays(self, tid: int) -> list:
        state = self.opt_states[tid]
        arrays = [np.asarray(state.count, dtype=np.int64)]
        arrays += [_npz_safe(t) for t in _state_tensors(state)]
        hyper = self._host_hyper(state) or {}
        arrays += [_npz_safe(v) if isinstance(v, torch.Tensor) else np.asarray(v)
                   for _, v in sorted(hyper.items())]
        return arrays

    def load(self, ckpt_dir: str) -> list:
        """Verified restore (``verify_checkpoint`` first: a torn or flipped
        shard raises ``CheckpointCorruptError``).  Returns the restored
        tenant ids."""
        import os

        from ..checkpointing import CheckpointCorruptError, verify_checkpoint
        from ..models.convert import flax_module_to_port_name

        ok, problems = verify_checkpoint(ckpt_dir)
        if not ok:
            raise CheckpointCorruptError(
                f"adapter checkpoint {ckpt_dir} failed verification: {problems}")
        restored = []
        for name in sorted(os.listdir(ckpt_dir)):
            if not (name.startswith("adapter_") and name.endswith(".npz")):
                continue
            tid = int(name[len("adapter_"):-len(".npz")])
            with np.load(os.path.join(ckpt_dir, name)) as z:
                tree: dict = {}
                for k in z.files:
                    if k.startswith("w/"):
                        module, f = k[2:].rsplit("/", 1)
                        tree.setdefault(flax_module_to_port_name(module), {})[f] = self._host(
                            torch.from_numpy(np.array(z[k])).to(self.dtype))
                arrays = [z[f"s/{i}"] for i in range(sum(1 for k in z.files
                                                         if k.startswith("s/")))]
            template = self.tx.init(self._flat(tree))
            t_tensors = _state_tensors(template)
            tensors = [self._host(torch.from_numpy(np.array(a)).to(t.dtype).reshape(t.shape))
                       for a, t in zip(arrays[1:1 + len(t_tensors)], t_tensors)]
            hyper = self._host_hyper(template)
            if hyper is not None:
                rest = arrays[1 + len(t_tensors):]
                hyper = {k: (self._host(torch.from_numpy(np.array(a)).to(v.dtype).reshape(v.shape))
                             if isinstance(v, torch.Tensor) else type(v)(a.item()))
                         for (k, v), a in zip(sorted(hyper.items()), rest)}
            self.adapters[tid] = tree
            self.opt_states[tid] = _state_rebuilt(template, tensors, hyper=hyper,
                                                  count=int(arrays[0]))
            restored.append(tid)
        return restored

    def host_state_report(self) -> dict:
        """The measured twin of :func:`~..ops.lora.adapter_state_accounting`:
        the host bytes of every tenant's weights and optimizer state."""
        def nbytes(tensors):
            return sum(t.numel() * t.element_size() for t in tensors)

        return {
            "n_adapters": len(self.adapters),
            "optimizer": self.plugin.optimizer,
            "weight_bytes": sum(nbytes(self._flat(a)) for a in self.adapters.values()),
            "state_bytes": sum(nbytes(_state_tensors(s)) for s in self.opt_states.values()),
            "kind": "measured",
        }
