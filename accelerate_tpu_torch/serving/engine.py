"""The serving engine: paged-KV decode + continuous batching over one model
(mirrors ``accelerate_tpu/serving/engine.py``).

Where :func:`~accelerate_tpu_torch.generation.generate` runs one fixed
batch start to finish, the engine keeps a fixed set of decode slots and a
fixed-size page pool busy under live traffic: requests are admitted,
chunk-prefilled, decoded and retired per step.

Each tick runs at most one model step — ``decode_step`` (one token for
every slot), ``verify_step`` (speculative decode's pass of ``bucket + 1``
lanes per slot) or ``prefill_step`` (one bucket-padded chunk of one
prompt) — beside the allocator steps (``release_step`` and, with the
prefix cache, ``adopt_step`` / ``release_cow_step`` / ``push_free_step``),
and fetches its tokens to the host once.  PyTorch runs eagerly: there is
no jit, and no donation; the KV pool, block tables and free stack are
updated **in place**.  With ``decode_kernel`` ``"flash"`` (what ``"auto"``
means) the model's attention goes through the hand-written paged kernels
on the card (``ops/flash_attention.py``): #4 / #5 for a decode step, #6 /
#7 for a prefill chunk and for a verify pass.  Greedy serving emits tokens
identical to ``generate()``.

``ServingPlugin.kv_dtype`` ``"int8"`` / ``"fp8"`` serves from quantized
pages: each layer's cache carries its per-(kv head, page) scales beside the
pages (JAX :52-68), the model quantizes on write and the paged kernels #5 /
#7 read the codes.  A model quantized with ``quantize_model_`` (int8
weights) serves through the W8A16 kernels #11 / #12 the same way.

Multi-tenant LoRA (``adapters=AdapterStore(...)``, JAX :598-606,
:666-687, :922-930): the scheduler pins each request's adapter on
admission; every decode step hands the model the per-slot pool slots
(built on the host, checked there against the pool and uploaded once per
tick, never read back) and the store's pool, every prefill chunk its
slot's pool slot.  The LoRA products run under the store's
``LoraPlugin.kernel`` mode: ``"auto"`` takes kernel #10 (``bgmv``) on
decode, the gathered product on prefill chunks and verify passes.

Speculative decode (``ServingPlugin.speculate`` ``"ngram"`` / ``"draft"``,
JAX :159-222, :681, :1054; greedy only): a draft provider
(``serving/speculate.py``) proposes up to ``speculate_k`` tokens per slot,
one verify pass writes K/V for the live lanes, takes the greedy token of
every lane through the same ``sample_logits`` and accepts the longest
matching draft prefix; the pages taken past the accepted frontier go back
onto the free stack in the same step.

Prefix caching (``ServingPlugin.prefix_cache="on"``, JAX :284-350,
:1160-1240): full prompt pages are content-addressed
(``serving/prefix_cache.py``); an admission whose prefix is cached writes
the shared page ids into its block-table row and prefills from the hit
boundary; releases push only the pages past a slot's shared prefix, and a
shared page returns to the free stack when its last holder lets go.

Overload control (JAX :471-478, :563-662, :997-1052): the scheduler
bounds its queue and sheds (``max_queue``, ``kv_shed_watermark``), every
request may carry a deadline (``Request.deadline_ticks``,
``default_deadline_ticks``), :meth:`ServingEngine.cancel` retires a
request at any stage at the next tick boundary, and every engine carries
a :class:`~.overload.DegradationLadder` (despeculate, shrink prefill,
tighten admission, shed) that an SLO monitor (:meth:`attach_slo`), a
deadline storm or an operator escalates.  Every retirement releases its
pages through the same keep-aware release the finish path uses.

Disaggregation (``serving/transfer.py``, JAX :390, :504-507, :576-624): an
engine built with ``hold_finished=True`` (the prefill role) parks each
finished slot with its pages until the transport streams them; the decode
role seats such a request with :meth:`adopt_prefilled`.

Fault plans (``resilience/faults.py``): the ``serve_step`` site takes
``preempt`` (drain at the tick boundary), ``prefix`` (flush the prefix
index), ``cancel`` (the oldest live request cancels) and ``deadline``
(every live request expires now and the ladder escalates one stage); the
``verify_step`` site takes ``preempt`` (drain before the verify pass
dispatches).  Request tracing (:meth:`ServingEngine.enable_tracing`)
records host-side spans, the ``shed`` / ``cancel`` / ``ladder`` /
``page_transfer`` instants included.

Tensor parallelism (JAX :764-771 warms the engine for a mesh-sharded param
tree whose KV pools come back tp-sharded): an engine over a tp rank's
module (``parallel.sharding.bind_tp_slices``), one per rank, every rank
stepping alike, sizes its pools from the rank's kv heads
(``LlamaForCausalLM.cache_kv_heads``) and runs the model's tp forward on
them; the logits are gathered whole, so every rank samples the same token
from the same seeded generator, and every rank's scheduler, block tables,
refcounts and event log stay the one-process engine's.  Speculation, the
prefix cache, the overload ladder, transfer and the router under tp are
not ported (ROADMAP item A13h.7): each refuses a tp engine.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import numpy as np
import torch

from ..generation import GenerationConfig, sample_logits
from ..models.llama import init_paged_cache
from ..ops.lora import lora_kernel
from ..resilience import faults as _faults
from ..telemetry import RequestTracer
from ..utils.dataclasses import ServingPlugin, TelemetryPlugin
from ..utils.device import resolve_device
from .overload import DegradationLadder, refuse_tensor_parallel
from .paged_cache import allocate, pages_for, push_pages, release
from .prefix_cache import PrefixCache
from .scheduler import ContinuousBatchingScheduler, Request, SlotState
from .speculate import Speculator, make_draft_provider, speculative_page_need


class ServingEngine:
    """Continuous-batching serving over one model.

    >>> engine = ServingEngine(model, plugin, generation_config)
    >>> engine.add_request(Request(uid=0, prompt=(1, 2, 3), max_new_tokens=8))
    >>> while not engine.idle():
    ...     engine.step()
    >>> engine.results[0]  # generated token ids

    ``device`` defaults to ``"cuda"`` (raises without one); the model must
    live there.  ``seed`` seeds the per-step sampling generator.
    ``adapters`` (an :class:`~.adapters.AdapterStore` over this model, on
    the engine's device) turns on multi-tenant LoRA: requests carry an
    ``adapter_id``.  ``draft_model`` (a small
    :class:`~accelerate_tpu_torch.models.llama.LlamaForCausalLM` with its
    own weights, on the engine's device) drafts for
    ``ServingPlugin(speculate="draft")``.  ``hold_finished=True`` makes a
    prefill-role engine of a :class:`~.transfer.DisaggregatedPair`.
    ``telemetry`` (a :class:`~..utils.dataclasses.TelemetryPlugin`, by
    default from the ``ACCELERATE_TELEMETRY*`` environment) arms request
    spans at construction when its ``trace_requests`` is set.
    ``run(trace)`` replays a list of :class:`~.scheduler.Request` with
    virtual-time arrivals.
    """

    def __init__(self, model, plugin: Optional[ServingPlugin] = None,
                 generation_config: Optional[GenerationConfig] = None, *,
                 seed: int = 0, device=None, adapters=None, draft_model=None,
                 hold_finished: bool = False, telemetry: Optional[TelemetryPlugin] = None):
        self.device = resolve_device(device)
        for label, mod in (("model", model), ("draft model", draft_model)):
            if mod is not None and not self._on_engine_device(mod.device):
                raise ValueError(f"the {label} lives on {mod.device}, the engine on "
                                 f"{self.device}")
        self.plugin = plugin or ServingPlugin()
        self.gen_config = generation_config or GenerationConfig()
        p = self.plugin
        # "auto" -> the paged kernels: CUDA kernels on the card, their plain
        # versions on a CPU tensor; "native" only when asked for
        self.attn_implementation = "flash" if p.decode_kernel == "auto" else p.decode_kernel
        self.model = model
        self.adapters = adapters
        if adapters is not None and (adapters.device.type != self.device.type or (
                adapters.device.index is not None and self.device.index is not None
                and adapters.device.index != self.device.index)):
            raise ValueError(f"the adapter pool lives on {adapters.device}, the engine "
                             f"on {self.device}")
        # the ranks of the model's tp world (1 outside one); its pools hold
        # the rank's kv heads
        self.tp = model.tp_degree()
        self.kv_heads = model.cache_kv_heads()
        self.cache = init_paged_cache(model.config, p.num_pages, p.page_size,
                                      p.num_slots, p.pages_per_slot, kv_dtype=p.kv_dtype,
                                      device=self.device, num_kv_heads=self.kv_heads)
        # speculative decode: greedy only, because the acceptance rule IS
        # the token-parity pin (a sampled verify needs rejection sampling)
        self._spec: Optional[Speculator] = None
        if p.speculate != "off":
            refuse_tensor_parallel("speculative decoding", self)
            if self.gen_config.do_sample:
                raise ValueError(
                    "speculative decode supports greedy decoding only (do_sample=True "
                    "breaks the greedy-prefix acceptance pin) — disable "
                    "ServingPlugin.speculate or sampling")
            provider = make_draft_provider(p.speculate, draft_model=draft_model,
                                           window=p.speculate_draft_window)
            self._spec = Speculator(provider, p.speculate_k, p.speculate_buckets)
        self.prefix: Optional[PrefixCache] = None
        if p.prefix_cache == "on":
            refuse_tensor_parallel("the prefix cache", self)
            self.prefix = PrefixCache(p.page_size, kv_dtype=p.kv_dtype)
        self.sched = ContinuousBatchingScheduler(
            p.num_slots, p.num_pages, p.page_size, p.pages_per_slot,
            p.prefill_chunk, p.prefill_buckets, adapters=adapters,
            max_bypass_age=adapters.plugin.max_bypass_age if adapters is not None else 16,
            speculate_k=p.speculate_k if self._spec is not None else 0,
            max_queue=p.max_queue, kv_shed_watermark=p.kv_shed_watermark,
            default_deadline_ticks=p.default_deadline_ticks, prefix=self.prefix,
        )
        # overload control: the ladder is always armed (escalation is
        # explicit: an SLO trip, a deadline storm or an operator call), and
        # cancels wait here for the next tick boundary
        self.despeculated = False
        self.ladder = DegradationLadder(self)
        self.slo = None                      # an attached SLOMonitor
        self._pending_cancels: list[int] = []
        self._seed = seed
        self._generator = torch.Generator(device=self.device)
        # request spans armed from the start when the telemetry plugin (or
        # ACCELERATE_TELEMETRY_TRACE_REQUESTS) asks for them
        self.telemetry = telemetry or TelemetryPlugin()
        self.trace: Optional[RequestTracer] = None
        if self.telemetry.trace_requests:
            self.enable_tracing()
        self.warmed_up = False
        self.steps = 0
        self.interrupted = False
        # disaggregation: a prefill-role engine holds finished slots, pages
        # intact, until the transport streams them and calls release_held()
        self.hold_finished = hold_finished
        self.held: list[int] = []
        self._undelivered: list[Request] = []
        self.results: dict[int, list[int]] = {}
        self._arrival_wall: dict[int, float] = {}
        self._last_token_wall: dict[int, float] = {}
        self._ttft_seen: set[int] = set()
        self.metrics = {
            "decode_steps": 0, "prefill_steps": 0, "idle_steps": 0,
            "scheduled_decode_slots": 0, "useful_decode_tokens": 0,
            "prefill_scheduled_tokens": 0, "prefill_useful_tokens": 0,
            "evictions": 0, "page_step_sum": 0, "peak_used_pages": 0,
            "prompt_tokens": 0, "generated_tokens": 0,
            # speculative decode (zeros when it is off): verify passes,
            # drafted and accepted lanes, per-lane passes and emitted tokens
            # (the tokens-per-step twin), pages rolled back off rejections
            "verify_steps": 0, "draft_tokens": 0, "accepted_draft_tokens": 0,
            "decode_lane_passes": 0, "decode_emitted_tokens": 0,
            "speculative_rollbacks": 0,
            # disaggregation (zeros unless a PagedKVTransport streams KV
            # pages out of or into this engine)
            "page_transfers": 0, "page_transfer_pages": 0, "page_transfer_bytes": 0,
        }
        self.ttft_s: list[float] = []
        # TTFT in virtual engine ticks (arrival -> first token)
        self.ttft_ticks: list[int] = []
        self.token_gaps_s: list[float] = []

    def _on_engine_device(self, dev: torch.device) -> bool:
        return dev.type == self.device.type and (
            self.device.index is None or dev.index == self.device.index)

    # -- telemetry -----------------------------------------------------------

    def enable_tracing(self, clock=None, capacity: Optional[int] = None) -> RequestTracer:
        """Arm request-level trace spans (idempotent unless ``clock`` or
        ``capacity`` is passed, which installs a fresh tracer).  ``clock``
        injects a deterministic timestamp source
        (:class:`~accelerate_tpu_torch.telemetry.VirtualClock`) for tests;
        the default is the host's ``perf_counter``.  Host-side only: no
        token changes."""
        if self.trace is None or clock is not None or capacity is not None:
            self.trace = RequestTracer(capacity=capacity or self.telemetry.ring_capacity,
                                       clock=clock)
        return self.trace

    def disable_tracing(self) -> None:
        self.trace = None

    # -- device steps (in place on self.cache) --------------------------------

    def _lora_args(self, ids: np.ndarray) -> dict:
        """The model's LoRA keywords for per-row pool slots ``ids`` (none
        without a store): the ids, checked against the pool on the host and
        uploaded once, and the pool itself."""
        if self.adapters is None:
            return {}
        pool_slots = self.adapters.plugin.pool_slots
        if ids.size and (int(ids.min()) < 0 or int(ids.max()) > pool_slots):
            raise ValueError(f"adapter pool slots {ids.tolist()} outside [0, {pool_slots}]")
        return {"adapter_ids": torch.from_numpy(ids).to(self.device),
                "lora": self.adapters.pool}

    def _lora_scope(self):
        if self.adapters is None:
            return contextlib.nullcontext()
        return lora_kernel(self.adapters.plugin.kernel)

    def _layer_caches(self, block_tables):
        """Each layer's model-facing cache: its pages (and, quantized,
        their scales) with this step's block tables."""
        return [{**layer, "block_tables": block_tables} for layer in self.cache["layers"]]

    @torch.inference_mode()
    def decode_step(self, tokens: np.ndarray, active: np.ndarray,
                    adapter_slots: Optional[np.ndarray] = None) -> torch.Tensor:
        """One token for every slot at once; dead slots write nowhere and
        their sampled token is ignored.  Pops a page for each active slot
        whose next position starts one.  ``adapter_slots`` [S]: each slot's
        adapter pool slot (multi-tenant mode; zeros when None).  Returns the
        sampled tokens [S]."""
        self._drain_prefix_frees()
        cache, page = self.cache, self.plugin.page_size
        tokens_t = torch.from_numpy(tokens).to(self.device)
        active_t = torch.from_numpy(active).to(self.device)
        pos = cache["seq_lens"]
        n_slots = tokens_t.shape[0]
        need = active_t & (pos % page == 0)
        block_tables, cache["free_top"] = allocate(
            cache["block_tables"], cache["free_stack"], cache["free_top"],
            torch.arange(n_slots, device=self.device), pos // page, need,
        )
        if adapter_slots is None:
            adapter_slots = np.zeros((n_slots,), np.int32)
        with self._lora_scope():
            logits, _ = self.model(
                tokens_t[:, None], positions=pos[:, None],
                cache=self._layer_caches(block_tables), cache_write_mask=active_t[:, None],
                attn_implementation=self.attn_implementation,
                **self._lora_args(adapter_slots),
            )
        next_tok = sample_logits(logits[:, 0], self._step_generator(), self.gen_config)
        cache["seq_lens"] = pos + active_t.to(torch.int32)
        return next_tok

    @torch.inference_mode()
    def verify_step(self, tokens: np.ndarray, spec_len: np.ndarray, active: np.ndarray,
                    adapter_slots: Optional[np.ndarray] = None) -> torch.Tensor:
        """One speculative verify pass of width ``w`` per slot (JAX
        ``verify_step``): lane 0 of ``tokens`` [S, w] is the slot's last
        sampled token, lanes ``1..spec_len`` its drafts.  Pops a page for
        every page start among the live lanes' positions, writes their K/V
        (lanes past ``spec_len`` and dead slots write nowhere), takes the
        greedy token of every lane through ``sample_logits``, accepts the
        longest matching draft prefix ``m`` and pushes the pages taken past
        the accepted frontier back onto the free stack.  Returns ``[S, w +
        1]``: the greedy tokens, then ``m``."""
        self._drain_prefix_frees()
        cache, page, dev = self.cache, self.plugin.page_size, self.device
        tokens_t = torch.from_numpy(tokens).to(dev)
        spec_t = torch.from_numpy(spec_len).to(dev)
        active_t = torch.from_numpy(active).to(dev)
        seq_lens = cache["seq_lens"]
        n, w = tokens_t.shape
        lane = torch.arange(w, device=dev, dtype=torch.int32)
        positions = seq_lens[:, None] + lane[None, :]
        live = active_t[:, None] & (lane[None, :] <= spec_t[:, None])
        logical = positions // page
        need = live & (positions % page == 0)
        block_tables, cache["free_top"] = allocate(
            cache["block_tables"], cache["free_stack"], cache["free_top"],
            torch.arange(n, device=dev).repeat_interleave(w), logical.reshape(-1),
            need.reshape(-1),
        )
        if adapter_slots is None:
            adapter_slots = np.zeros((n,), np.int32)
        with self._lora_scope():
            logits, _ = self.model(
                tokens_t, positions=positions, cache=self._layer_caches(block_tables),
                cache_write_mask=live, attn_implementation=self.attn_implementation,
                **self._lora_args(adapter_slots),
            )
        greedy = sample_logits(logits.reshape(n * w, -1), self._step_generator(),
                               self.gen_config).reshape(n, w)
        # draft j is accepted iff it equals the target's token after drafts
        # 1..j-1 (greedy[:, j-1]); m counts the matching prefix
        match = (tokens_t[:, 1:] == greedy[:, :-1]) & (lane[None, 1:] <= spec_t[:, None])
        m = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1, dtype=torch.int32)
        new_seq_lens = seq_lens + torch.where(active_t, m + 1, 0).to(torch.int32)
        # rollback: pages taken for positions past the accepted frontier go
        # back (their stale K/V is never read: the next pass rewrites any
        # position before the positional mask admits it)
        give_back = need & (positions >= new_seq_lens[:, None])
        pages = torch.gather(block_tables, 1,
                             logical.clamp(0, block_tables.shape[1] - 1).long())
        cache["free_stack"], cache["free_top"] = push_pages(
            cache["free_stack"], cache["free_top"], pages.reshape(-1), give_back.reshape(-1))
        cache["seq_lens"] = new_seq_lens
        return torch.cat([greedy, m[:, None]], dim=1)

    @torch.inference_mode()
    def prefill_step(self, slot: int, chunk_ids: np.ndarray, start: int,
                     chunk_len: int, adapter_slot: int = 0) -> torch.Tensor:
        """One bucket-padded chunk of one sequence's prompt, through the
        sequence's adapter pool slot ``adapter_slot`` in multi-tenant mode.
        Returns the logits of the chunk's last real token (the decode-loop
        seed once the prompt completes)."""
        self._drain_prefix_frees()
        cache, page = self.cache, self.plugin.page_size
        width = chunk_ids.shape[0]
        lane = torch.arange(width, device=self.device, dtype=torch.int32)
        positions = start + lane
        wmask = lane < chunk_len
        need = wmask & (positions % page == 0)
        block_tables, cache["free_top"] = allocate(
            cache["block_tables"], cache["free_stack"], cache["free_top"],
            torch.full((width,), slot, device=self.device), positions // page, need,
        )
        with self._lora_scope():
            logits, _ = self.model(
                torch.from_numpy(chunk_ids).to(self.device)[None], positions=positions[None],
                cache=self._layer_caches(block_tables[slot:slot + 1]),
                cache_write_mask=wmask[None], attn_implementation=self.attn_implementation,
                **self._lora_args(np.asarray([adapter_slot], np.int32)),
            )
        cache["seq_lens"][slot] = start + chunk_len
        return logits[0, chunk_len - 1]

    @torch.inference_mode()
    def release_step(self, mask: np.ndarray) -> None:
        """Push every page of the masked slots back onto the free stack and
        zero their lengths."""
        cache = self.cache
        cache["seq_lens"], cache["free_stack"], cache["free_top"] = release(
            cache["block_tables"], cache["seq_lens"], cache["free_stack"],
            cache["free_top"], torch.from_numpy(mask).to(self.device),
            self.plugin.page_size,
        )

    # the prefix-cache steps: allocator arithmetic only

    @torch.inference_mode()
    def adopt_step(self, slot: int, page_ids: list) -> None:
        """Write an admission's shared page ids into the slot's block-table
        row prefix and set its length at the hit boundary (the region
        chunked prefill skips; shared pages were never free)."""
        cache = self.cache
        n = len(page_ids)
        cache["block_tables"][slot, :n] = torch.tensor(page_ids, dtype=torch.int32,
                                                       device=self.device)
        cache["seq_lens"][slot] = n * self.plugin.page_size

    @torch.inference_mode()
    def release_cow_step(self, mask: np.ndarray, keep_counts: np.ndarray) -> None:
        """The keep-aware release: push only each masked slot's pages past
        its first ``keep_counts[slot]`` (its shared prefix stays off the
        stack: the host refcounts decide when an aliased page frees) and
        zero its length."""
        cache = self.cache
        mask_t = torch.from_numpy(mask).to(self.device)
        keep_t = torch.from_numpy(keep_counts).to(self.device)
        n = cache["block_tables"].shape[1]
        logical = torch.arange(n, device=self.device, dtype=torch.int32)[None, :]
        owned = mask_t[:, None] & (logical >= keep_t[:, None]) & (
            logical < pages_for(cache["seq_lens"], self.plugin.page_size)[:, None])
        cache["free_stack"], cache["free_top"] = push_pages(
            cache["free_stack"], cache["free_top"], cache["block_tables"].reshape(-1),
            owned.reshape(-1))
        cache["seq_lens"] = torch.where(mask_t, torch.zeros_like(cache["seq_lens"]),
                                        cache["seq_lens"])

    @torch.inference_mode()
    def push_free_step(self, page_ids: list) -> None:
        """Push an explicit page id list (refcount deaths and reclaims the
        host queued) onto the free stack."""
        cache = self.cache
        ids = torch.tensor(page_ids, dtype=torch.int32, device=self.device)
        cache["free_stack"], cache["free_top"] = push_pages(
            cache["free_stack"], cache["free_top"], ids, torch.ones_like(ids, dtype=torch.bool))

    @torch.inference_mode()
    def sample_first(self, last: torch.Tensor) -> torch.Tensor:
        return sample_logits(last[None], self._step_generator(), self.gen_config)[0]

    def _step_generator(self) -> torch.Generator:
        # one stream per (seed, tick): the JAX engine's fold_in(rng, steps)
        return self._generator.manual_seed((self._seed << 32) + self.steps)

    # -- request lifecycle ---------------------------------------------------

    def add_request(self, request: Request) -> None:
        self.sched.submit(request)
        self._arrival_wall[request.uid] = time.perf_counter()

    def cancel(self, uid: int) -> None:
        """Cancel ``uid`` at whatever stage it is in (queued, mid prefill,
        decoding or between verify passes), at the next tick boundary: the
        steps are atomic per tick, so the boundary is where pages, adapter
        hold, slot and speculative state release together.  Idempotent;
        unknown or finished uids drop silently.  A cancel still pending at a
        preemption drain is owed: :meth:`remaining_requests` hands the
        request back exactly once."""
        if uid not in self._pending_cancels:
            self._pending_cancels.append(uid)

    def adopt_prefilled(self, request: Request, first_token: int) -> int:
        """The decode role's half of the disaggregated handoff: occupy a
        free slot for a request prefilled on another engine, whose first
        token is sampled and whose pages the transport is about to write
        into this pool.  The host mirror books ``pages_for(prompt_len)``
        pages (the transport pops exactly those); decode goes on through the
        ordinary tick loop.  Returns the slot."""
        sched = self.sched
        if not sched.free_slots:
            raise RuntimeError("adopt_prefilled: no free decode slot")
        n_pages = int(pages_for(request.prompt_len, self.plugin.page_size))
        if n_pages > sched.free_pages:
            raise RuntimeError(f"adopt_prefilled: request {request.uid} needs {n_pages} "
                               f"pages, pool has {sched.free_pages} free")
        slot = sched.free_slots.pop(0)
        st = SlotState(request, sched._admit_counter, prefilled=request.prompt_len)
        st.tokens = [int(first_token)]
        if self.adapters is not None and request.adapter_id:
            # the decode role pins the tenant in its own pool (the prefill
            # role's pin went with the held slot); finish unpins
            adapter_slot, swapped = self.adapters.pin(request.adapter_id)
            st.adapter_slot = adapter_slot
            if swapped:
                sched.events.append(("swap", request.adapter_id, adapter_slot))
        sched.slots[slot] = st
        sched._admit_counter += 1
        sched.free_pages -= n_pages
        sched.events.append(("admit", request.uid, slot))
        # the prefill engine delivered the first token: TTFT is its story
        now = time.perf_counter()
        self._arrival_wall[request.uid] = now
        self._last_token_wall[request.uid] = now
        self._ttft_seen.add(request.uid)
        return slot

    def release_held(self, slot: int) -> None:
        """The prefill role's half of the handoff: retire a held finished
        slot once its pages have been streamed out (device release first,
        then the host mirror, as every retirement)."""
        self.held.remove(slot)
        self._release_slots([slot])
        self.sched.finish(slot)
        self._drain_prefix_frees()

    def attach_slo(self, monitor) -> DegradationLadder:
        """Feed per-token latency and TTFT samples into ``monitor`` as they
        are measured and wire its trip / recover callbacks to the ladder
        (trip: escalate one stage; recover: relax one).  Returns the
        ladder."""
        self.slo = monitor
        self.ladder.attach(monitor)
        return self.ladder

    def idle(self) -> bool:
        return self.sched.idle()

    def unfinished_requests(self) -> list[Request]:
        """Everything not yet finished, in admission order then queue order
        (prompt intact, generated tokens discarded: the recompute-on-resume
        contract a preemption drain relies on)."""
        in_flight = [self.sched.slots[s].request
                     for s in sorted(self.sched.slots, key=lambda s: self.sched.slots[s].admit_seq)]
        return in_flight + list(self.sched.waiting)

    def remaining_requests(self) -> list[Request]:
        """After a drain: everything still owed — in flight, queued and
        trace arrivals the replay never delivered — once per uid, without
        the deliberately retired (shed or cancelled).  A request whose
        :meth:`cancel` is still pending was not retired: it comes back
        exactly once; a processed cancel never does."""
        retired = self.sched.retired_uids
        out, seen = [], set()
        for r in self.unfinished_requests() + list(self._undelivered):
            if r.uid in retired or r.uid in self.results or r.uid in seen:
                continue
            seen.add(r.uid)
            out.append(r)
        return out

    @property
    def speculator(self) -> Optional[Speculator]:
        """The engine's speculative-decode state (None when off)."""
        return self._spec

    @property
    def speculate_mode(self) -> str:
        return self.plugin.speculate if self._spec is not None else "off"

    # -- the engine tick -----------------------------------------------------

    def warmup(self) -> None:
        """Run every step once before taking traffic — decode, release,
        each bucket's prefill (plus the first-token sampler), each verify
        bucket and the draft provider's forward — as no-ops: decode and
        verify with zero active slots, a zero-length chunk into an idle
        slot, an empty release mask — and, in multi-tenant mode, one insert
        into the adapter pool's null slot.  This builds the CUDA kernels
        and brings up cuBLAS before the first request's clock starts.
        Tokens are never recorded and ``steps`` does not advance."""
        if self.sched.slots:
            raise RuntimeError("warmup() must run before any traffic is admitted")
        n = self.plugin.num_slots
        self.decode_step(np.zeros((n,), np.int32), np.zeros((n,), bool))
        last = None
        for bucket in self.plugin.prefill_buckets:
            last = self.prefill_step(0, np.zeros((bucket,), np.int32), 0, 0)
        if last is not None:
            self.sample_first(last)
        if self._spec is not None:
            for bucket in self._spec.buckets:
                self.verify_step(np.zeros((n, bucket + 1), np.int32), np.zeros((n,), np.int32),
                                 np.zeros((n,), bool))
            self._spec.provider.warmup(n, self._spec.k)
        self.release_step(np.zeros((n,), bool))
        self.decode_step(np.zeros((n,), np.int32), np.zeros((n,), bool))
        if self.adapters is not None:
            self.adapters.warmup_insert()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.warmed_up = True

    def step(self) -> dict:
        """One scheduler decision + at most one model step.

        With tracing on (:attr:`trace`) the tick records its phase spans —
        ``schedule`` (admission + the scheduler decision), ``dispatch:*``
        (the model step's host time; the card runs it asynchronously) and
        ``host_sync`` (the token fetch) — and the per-request lifecycle
        spans of the scheduler's event log."""
        tr = self.trace
        sched = self.sched
        for ev in _faults.fault_point("serve_step"):
            if ev.kind == "preempt":
                # drain: stop taking work; remaining_requests() hands every
                # unfinished request back
                self.interrupted = True
                self._drain_prefix_frees()
                return {"type": "preempted", "step": self.steps}
            if ev.kind == "cancel":
                # cancellation storm: the oldest live request cancels
                self._inject_cancel_oldest()
            elif ev.kind == "deadline":
                # deadline storm: every live request expires now, and the
                # overload signal escalates the ladder one stage
                sched.force_expire_all()
                self.ladder.escalate()
            elif ev.kind == "prefix" and self.prefix is not None:
                # cache-invalidation storm: every index hold drops; live
                # slots keep their shared refcounts, future admissions miss
                freed = self.prefix.flush()
                sched.free_pages += freed
                sched.events.append(("prefix_flush", freed))
        sched.tick = self.steps
        self._process_control()
        t_sched = tr.stamp() if tr is not None else 0.0
        admitted = sched.admit()
        if self.prefix is not None:
            # push refcount deaths / reclaims before any allocating step,
            # then write each adopted prefix into its slot's row
            self._drain_prefix_frees()
            for s in admitted:
                if sched.slots[s].shared_pages:
                    self.adopt_step(s, sched.slots[s].shared_pages)
        action = sched.next_action()
        if tr is not None:
            tr.phase("schedule", t_sched, action=action[0], step=self.steps)
        window = None
        event: dict = {"type": action[0], "step": self.steps}
        m = self.metrics
        if action[0] == "prefill":
            _, slot, start, chunk, bucket = action
            survived, evicted = sched.plan_prefill_evictions(slot, chunk)
            self._release_evicted(evicted)
            if survived:
                st = sched.slots[slot]
                ids = np.zeros((bucket,), np.int32)
                ids[:chunk] = st.request.prompt[start:start + chunk]
                t_disp = tr.stamp() if tr is not None else 0.0
                last = self.prefill_step(slot, ids, start, chunk, st.adapter_slot)
                if tr is not None:
                    tr.phase("dispatch:prefill", t_disp, slot=slot, chunk=chunk,
                             bucket=bucket, step=self.steps)
                sched.note_prefill(slot, chunk)
                m["prefill_steps"] += 1
                m["prefill_scheduled_tokens"] += bucket
                m["prefill_useful_tokens"] += chunk
                m["prompt_tokens"] += chunk
                event.update(slot=slot, chunk=chunk, bucket=bucket)
                if self.prefix is not None and st.prefill_done:
                    # the completed prompt's new full pages join the index
                    self._insert_prefix(slot, st)
                if st.prefill_done:
                    # the prompt's last-token logits seed the decode loop —
                    # the first generated token, exactly like generate()
                    t_sync = tr.stamp() if tr is not None else 0.0
                    tok = int(self.sample_first(last))
                    if tr is not None:
                        tr.phase("host_sync", t_sync, step=self.steps)
                    m["generated_tokens"] += 1
                    self._record_token(slot, tok)
                if tr is not None:
                    window = (t_disp, tr.recorder.clock())
            else:
                event["cancelled"] = True
        elif action[0] == "decode" and self._spec is not None and not self.despeculated:
            event["type"] = "verify"
            window = self._verify_tick(action[1], tr, event)
            if self.interrupted:  # preempted before the pass: nothing ran
                self._drain_prefix_frees()
                return {"type": "preempted", "step": self.steps}
        elif action[0] == "decode":
            active_slots, evicted = sched.plan_evictions(action[1])
            self._release_evicted(evicted)
            if active_slots:
                needing = sched.decode_page_need(active_slots)
                n = self.plugin.num_slots
                tokens = np.zeros((n,), np.int32)
                active = np.zeros((n,), bool)
                adapter_slots = np.zeros((n,), np.int32)
                for s in active_slots:
                    tokens[s] = sched.slots[s].tokens[-1]
                    active[s] = True
                    adapter_slots[s] = sched.slots[s].adapter_slot
                t_disp = tr.stamp() if tr is not None else 0.0
                next_tok = self.decode_step(tokens, active, adapter_slots)
                if tr is not None:
                    tr.phase("dispatch:decode", t_disp, slots=list(active_slots),
                             step=self.steps)
                sched.note_decode(needing, active_slots)
                t_sync = tr.stamp() if tr is not None else 0.0
                next_np = next_tok.cpu().numpy()  # the tick's one host sync
                if tr is not None:
                    tr.phase("host_sync", t_sync, step=self.steps)
                    window = (t_disp, tr.recorder.clock())
                done_slots = [s for s in active_slots
                              if self._record_token(s, int(next_np[s]), release=False)]
                if done_slots and not self.hold_finished:
                    self._release_slots(done_slots)
                    for s in done_slots:
                        sched.finish(s)
                m["decode_steps"] += 1
                m["scheduled_decode_slots"] += n
                m["useful_decode_tokens"] += len(active_slots)
                m["generated_tokens"] += len(active_slots)
                m["decode_lane_passes"] += len(active_slots)
                m["decode_emitted_tokens"] += len(active_slots)
                event.update(slots=tuple(active_slots))
            else:
                event["cancelled"] = True
        else:
            m["idle_steps"] += 1
        used = sched.used_pages
        m["page_step_sum"] += used
        m["peak_used_pages"] = max(m["peak_used_pages"], used)
        if tr is not None:
            tr.consume_scheduler_events(sched.events, self.steps, window=window)
        # the tick boundary owes the device every refcount-death push the
        # host counted this tick (the mirror is exact between ticks)
        self._drain_prefix_frees()
        self.steps += 1
        return event

    def run(self, trace: list[Request], max_steps: int = 200_000) -> dict[int, list[int]]:
        """Replay ``trace`` (arrivals keyed on virtual step time) to
        completion — or to the first injected preemption."""
        pending = sorted(trace, key=lambda r: (r.arrival_step, r.uid))
        i = 0
        while True:
            while i < len(pending) and pending[i].arrival_step <= self.steps:
                self.add_request(pending[i])
                i += 1
            if self.interrupted or (self.idle() and i >= len(pending)):
                break
            self.step()
            if self.steps >= max_steps:
                raise RuntimeError(f"serving replay exceeded {max_steps} steps")
        # arrivals that never reached the engine before a drain are still
        # owed to the resume path
        self._undelivered = pending[i:]
        return self.results

    # -- internals -----------------------------------------------------------

    def _process_control(self) -> None:
        """The tick-boundary control pass, before admission (so a retired
        request's pages and slot serve this very tick): apply pending
        cancels, then cancel in-flight requests past their deadline."""
        sched = self.sched
        for uid in list(self._pending_cancels):
            if self._apply_cancel(uid, reason="cancel"):
                self._pending_cancels.remove(uid)
            elif uid in self.results or uid in sched.retired_uids:
                # raced a finish or a shed: nothing left to cancel
                self._pending_cancels.remove(uid)
            # else: not arrived yet — the cancel stays pending
        for slot in sorted(sched.slots):
            # a held finished slot delivered its tokens: its pages wait for
            # the transfer, and a deadline cannot revoke them
            if sched.slots[slot].finished:
                continue
            if sched.request_expired(sched.slots[slot].request):
                self._cancel_slot(slot, reason="deadline")

    def _apply_cancel(self, uid: int, reason: str) -> bool:
        """Cancel ``uid`` at the stage it is in now.  Returns True when a
        live request was retired."""
        sched = self.sched
        for slot, st in sched.slots.items():
            if st.request.uid == uid and not st.finished:
                self._cancel_slot(slot, reason=reason)
                return True
        return sched.cancel_queued(uid, reason=reason)

    def _cancel_slot(self, slot: int, reason: str) -> None:
        """Retire an admitted request: the device's pages first (the
        release finish and evict use: keep-aware with the prefix cache), then
        the scheduler's host mirror."""
        uid = self.sched.slots[slot].request.uid
        self._release_slots([slot])
        self.sched.cancel_slot(slot, reason=reason)
        self._arrival_wall.pop(uid, None)
        self._last_token_wall.pop(uid, None)
        self._ttft_seen.discard(uid)

    def _inject_cancel_oldest(self) -> None:
        """The cancellation storm's payload: cancel the oldest live request
        — the oldest-admitted in flight, else the head of the line."""
        sched = self.sched
        live = [s for s in sched.slots if not sched.slots[s].finished]
        if live:
            self._cancel_slot(min(live, key=lambda s: sched.slots[s].admit_seq),
                              reason="cancel")
        elif sched.waiting:
            sched.cancel_queued(sched.waiting[0].uid, reason="cancel")

    def _verify_tick(self, candidate_slots, tr, event):
        """One draft-and-verify pass (the decode action with speculation
        on): draft first (the proposals size the page reservation), fit the
        worst-case page demand (zeroing draft depths before evicting), run
        the bucket-padded verify step, then settle the host mirror off the
        accepted lengths.  Returns the tracing window (or None).  The
        ``verify_step`` fault site fires first: a ``preempt`` there drains
        with nothing dispatched and no state touched."""
        for ev in _faults.fault_point("verify_step"):
            if ev.kind == "preempt":
                self.interrupted = True
                event["preempted"] = True
                return None
        sp, sched = self._spec, self.sched
        cand = list(candidate_slots)
        n = self.plugin.num_slots
        # the draft batch is padded to every slot, and each context carries
        # only the provider's trailing window; assembling them is draft time
        t_ctx = time.perf_counter()
        win = max(2, getattr(sp.provider, "window", 512))
        contexts = [[1]] * n
        remaining = [1] * n  # dummy rows clamp to depth 0
        tenant_ids = [0] * n
        for s in cand:
            st = sched.slots[s]
            toks = st.tokens
            if len(toks) >= win:
                contexts[s] = toks[-win:]
            else:
                contexts[s] = list(st.request.prompt[len(toks) - win:]) + toks
            remaining[s] = st.request.max_new_tokens - len(toks)
            tenant_ids[s] = st.request.adapter_id
        sp.draft_time_s += time.perf_counter() - t_ctx
        drafts, spec_lens = sp.draft(contexts, remaining, tenant_ids)
        spec_by_slot = {s: int(spec_lens[s]) for s in cand}
        active_slots, evicted = sched.plan_speculative_evictions(cand, spec_by_slot)
        self._release_evicted(evicted)
        if not active_slots:
            event["cancelled"] = True
            return None
        worst_need = sched.verify_page_need(active_slots, spec_by_slot)
        bucket = sp.bucket_for(max(spec_by_slot[s] for s in active_slots))
        w = bucket + 1
        tokens = np.zeros((n, w), np.int32)
        spec_arr = np.zeros((n,), np.int32)
        active = np.zeros((n,), bool)
        adapter_slots = np.zeros((n,), np.int32)
        for s in active_slots:
            st = sched.slots[s]
            d = spec_by_slot[s]
            tokens[s, 0] = st.tokens[-1]
            if d:
                tokens[s, 1:1 + d] = drafts[s, :d]
            spec_arr[s] = d
            active[s] = True
            adapter_slots[s] = st.adapter_slot
        t_disp = tr.stamp() if tr is not None else 0.0
        out = self.verify_step(tokens, spec_arr, active, adapter_slots)
        if tr is not None:
            tr.phase("dispatch:verify", t_disp, slots=list(active_slots), bucket=bucket,
                     step=self.steps)
        t_sync = tr.stamp() if tr is not None else 0.0
        out_np = out.cpu().numpy()  # the tick's one host sync
        if tr is not None:
            tr.phase("host_sync", t_sync, step=self.steps)
        window = (t_disp, tr.recorder.clock()) if tr is not None else None
        greedy_np = out_np[:, :w]
        accepted = {s: int(out_np[s, w]) for s in active_slots}
        m = self.metrics
        # rollback accounting against the kv lengths before the pass
        for s in active_slots:
            kept = speculative_page_need(sched.slots[s].kv_tokens, accepted[s],
                                         self.plugin.page_size)
            m["speculative_rollbacks"] += worst_need[s] - kept
        sched.note_verify(accepted)
        done_slots = []
        recorded = delivered_drafts = 0
        for s in active_slots:
            r = 0
            for tok in greedy_np[s, :accepted[s] + 1]:
                r += 1
                if self._record_token(s, int(tok), release=False):
                    # EOS or max_new inside the accepted window retires the
                    # sequence; the rest of the window is discarded
                    done_slots.append(s)
                    break
            recorded += r
            # accepted drafts delivered (a pass emits m + 1 tokens for m
            # accepted drafts; a truncated tail does not count)
            delivered_drafts += r - 1
        if done_slots and not self.hold_finished:
            self._release_slots(done_slots)
            for s in done_slots:
                sched.finish(s)
        m["verify_steps"] += 1
        m["scheduled_decode_slots"] += n * w
        m["useful_decode_tokens"] += recorded
        m["generated_tokens"] += recorded
        m["decode_lane_passes"] += len(active_slots)
        m["decode_emitted_tokens"] += recorded
        m["draft_tokens"] += sum(spec_by_slot[s] for s in active_slots)
        m["accepted_draft_tokens"] += delivered_drafts
        event.update(slots=tuple(active_slots), bucket=bucket,
                     accepted=tuple(accepted[s] for s in active_slots))
        return window

    def _record_token(self, slot: int, tok: int, release: bool = True) -> bool:
        """Append a sampled token; retire the sequence on EOS/max_new.
        Returns True when the sequence finished (the caller releases if it
        opted out of the immediate release)."""
        st = self.sched.slots[slot]
        now = time.perf_counter()
        uid = st.request.uid
        if not st.tokens:
            # once per request: an evicted-and-readmitted sequence must not
            # re-sample its TTFT
            if uid not in self._ttft_seen:
                self._ttft_seen.add(uid)
                self.ttft_s.append(now - self._arrival_wall[uid])
                self.ttft_ticks.append(self.steps - st.request.arrival_step)
                if self.slo is not None:
                    self.slo.observe("ttft_s", self.ttft_s[-1])
        elif uid in self._last_token_wall:
            self.token_gaps_s.append(now - self._last_token_wall[uid])
            if self.slo is not None:
                self.slo.observe("token_latency_s", self.token_gaps_s[-1])
        self._last_token_wall[uid] = now
        st.tokens.append(tok)
        if not st.prefill_done:
            raise AssertionError("token recorded before prefill completed")
        eos = self.gen_config.eos_token_id
        finished = (eos is not None and tok == eos) or \
            len(st.tokens) >= st.request.max_new_tokens
        if finished:
            self.results[uid] = list(st.tokens)
            self._arrival_wall.pop(uid, None)
            self._last_token_wall.pop(uid, None)
            self._ttft_seen.discard(uid)
            if self.hold_finished:
                # prefill role: the pages stay until the transport streams them
                st.finished = True
                self.held.append(slot)
            elif release:
                self._release_slots([slot])
                self.sched.finish(slot)
            return True
        return False

    def _release_slots(self, slots: list[int]) -> None:
        mask = np.zeros((self.plugin.num_slots,), bool)
        mask[slots] = True
        if self.prefix is None:
            self.release_step(mask)
            return
        # COW release: only the pages past each slot's shared prefix go
        # back; the host refcounts decide when an aliased page frees
        keep = np.zeros((self.plugin.num_slots,), np.int32)
        for s in slots:
            st = self.sched.slots.get(s)
            if st is not None:
                keep[s] = len(st.shared_pages)
            else:
                # evict() popped the state already; it parked the keep count
                keep[s] = self.sched.evicted_keep.pop(s, 0)
        self.release_cow_step(mask, keep)

    def _drain_prefix_frees(self) -> None:
        """Push every refcount-death / reclaim page the host queued onto
        the device free stack (``pop_pending`` refuses a page that still
        holds a reference)."""
        if self.prefix is None or not self.prefix.pending_free:
            return
        self.push_free_step(self.prefix.pop_pending())

    def _insert_prefix(self, slot: int, st) -> None:
        """Register a completed prefill's new full pages in the content
        index: their physical ids come from one small block-row fetch (the
        device popped them); the slot's shared set stays a contiguous row
        prefix, so the COW release's keep count holds."""
        hashes = self.prefix.block_hashes(st.request.prompt, st.request.adapter_id)
        k = len(st.shared_pages)
        if len(hashes) <= k:
            return
        row = self.cache["block_tables"][slot, :len(hashes)].cpu().numpy()
        st.shared_pages.extend(self.prefix.insert_owned(hashes[k:], [int(p) for p in row[k:]]))

    def _release_evicted(self, evicted: list[int]) -> None:
        if evicted:
            self._release_slots(evicted)
            self.metrics["evictions"] += len(evicted)
            # the evicted sequences' generated tokens were revoked: their
            # inter-token clock must not bridge across the readmission
            for req in self.sched.waiting:
                self._last_token_wall.pop(req.uid, None)

    # -- introspection --------------------------------------------------------

    def free_page_mirror_in_sync(self) -> bool:
        """The host scheduler's free-page mirror equals the device
        allocator's ``free_top`` (one scalar fetch).  The full resource
        contract is :func:`~.overload.verify_serving_invariants`."""
        return int(self.cache["free_top"]) == self.sched.free_pages
