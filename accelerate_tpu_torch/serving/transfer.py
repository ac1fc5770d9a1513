"""Disaggregated prefill -> decode: streaming finished KV pages between
engines (mirrors ``accelerate_tpu/serving/transfer.py``: ``page_bytes``
:50, ``transfer_accounting`` :61, ``PagedKVTransport`` :160,
``DisaggregatedPair`` :242).

A prefill-role engine turns prompts into KV pages and a first token at
chunked-prefill shapes; a decode-role engine decodes from those pages at
its own batch shape, so neither workload pads out the other's step.

- :class:`PagedKVTransport` moves one finished slot's pages between the
  two pools: :meth:`~PagedKVTransport.send` gathers the slot's pages
  through its block-table row into the wire payload (``[L, Hkv, pps,
  page, D]`` per K / V, JAX's wire shape; quantized pools also ship their
  ``[L, Hkv, pps]`` f32 scales, which are page content; a transfer gathers
  only the ``n`` live pages, ``pps`` -> ``n``), :meth:`~PagedKVTransport.recv` pops
  fresh pages off the destination's free stack, writes the payload's live
  pages into them (dead lanes are dropped, never written out of bounds)
  and installs the block-table row and ``seq_len``.  On one card both are
  a device-to-device gather and scatter; the payload is freed after the
  scatter.  Bytes are accounted against :func:`transfer_accounting` (the
  ``transfer.page_bytes`` twin).
- :class:`DisaggregatedPair` is the host loop over a prefill-role engine
  (``hold_finished=True``) and a decode-role engine.  Greedy tokens equal
  the same trace through one engine: the payload is the K / V itself.

The same payload crosses a process boundary in the two-process fabric
(``test_utils/scripts/fleet_fabric.py``): each process holds one role's
engine and a transport over it alone (``PagedKVTransport(engine,
engine)``), its ``send`` on the prefill side and its ``recv`` on the
decode side, the payload on a gloo group between them.
"""

from __future__ import annotations

import bisect
import dataclasses
import torch

from ..telemetry import twin_registry
from .engine import ServingEngine
from .overload import refuse_tensor_parallel
from .paged_cache import allocate, kv_page_bytes, pages_for
from .scheduler import Request


def page_bytes(config, page_size: int, dtype_bytes: int = 2, kv_dtype: str = "") -> int:
    """Wire bytes of one physical page across all layers (the unit the
    transfer twin counts in; quantized pools ship one-byte codes plus the
    per-(kv head, page) scales)."""
    return kv_page_bytes(config, page_size, dtype_bytes, kv_dtype)


def transfer_accounting(config, trace, page_size: int, dtype_bytes: int = 2,
                        dcn_gbps: float = 25.0, kv_dtype: str = "") -> dict:
    """Predicted bytes of a disaggregated replay of ``trace``: every request
    ships ``pages_for(prompt_len)`` live pages once, prefill -> decode (the
    predicted side of ``transfer.page_bytes``; the transport's counter is
    the measured side, equal unless a request never reached the handoff).
    ``dcn_gbps`` turns the bytes into a stream time at the JAX package's
    reference link rate."""
    per_page = page_bytes(config, page_size, dtype_bytes, kv_dtype)
    pages = sum(int(pages_for(r.prompt_len, page_size)) for r in trace)
    total = pages * per_page
    twin_registry().record_predicted("transfer.page_bytes", total,
                                     source="serving/transfer.transfer_accounting")
    return {
        "requests": len(trace),
        "pages_predicted": pages,
        "bytes_per_page": per_page,
        "page_transfer_bytes": total,
        "dcn_gbps_ref": dcn_gbps,
        "stream_s_pred": round(total / (dcn_gbps * 1e9), 6) if total else 0.0,
    }


# pool key -> payload key
_WIRE = {"k_pages": "k", "v_pages": "v", "k_scales": "k_scales", "v_scales": "v_scales"}


def _bits(t):
    # PyTorch gathers and scatters few float8 ops: move e4m3 codes as bytes
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


class PagedKVTransport:
    """Streams one finished slot's KV pages from a prefill-role engine to a
    decode-role engine.  Construction refuses a pair whose wire schemas
    differ (``analysis/distributed_audit.check_wire_schemas``).  Each
    transfer adds to the engines' ``page_transfer*`` metrics, records the
    measured side of ``transfer.page_bytes`` and appends ``("page_transfer",
    uid, n_pages, bytes)`` to the decode scheduler's event log."""

    def __init__(self, src: ServingEngine, dst: ServingEngine):
        from ..analysis.distributed_audit import check_wire_schemas, wire_schema

        refuse_tensor_parallel("KV page transfer", src, dst)
        schema_src = wire_schema(src.model.config, src.plugin)
        check_wire_schemas(schema_src, wire_schema(dst.model.config, dst.plugin))
        self.src, self.dst = src, dst
        self.schema = schema_src
        self._page_bytes = schema_src["page_bytes"]
        self.transfers = 0
        self.pages_moved = 0
        self.bytes_moved = 0
        twin_registry().record_measured("distributed.wire_bytes_per_page", self._page_bytes,
                                        source="serving/transfer.PagedKVTransport")

    @torch.inference_mode()
    def send(self, slot: int, n_pages: int | None = None) -> dict:
        """Gather the first ``n_pages`` entries of ``slot``'s block-table
        row on the prefill engine: ``{"k", "v"}`` ``[L, Hkv, n_pages, page,
        D]`` in the pool's dtype, plus ``{"k_scales", "v_scales"}`` ``[L,
        Hkv, n_pages]`` for a quantized pool.  ``None`` gathers the whole
        row, dead entries riding as padding: JAX's ``pps``-wide wire
        shape."""
        cache = self.src.cache
        row = cache["block_tables"][slot, :n_pages].long()
        layers = cache["layers"]
        payload = {}
        for key, wire in _WIRE.items():
            if key not in layers[0]:
                continue
            first = _bits(layers[0][key])
            out = torch.empty((len(layers), first.shape[0], row.numel(), *first.shape[2:]),
                              dtype=first.dtype, device=first.device)
            for i, layer in enumerate(layers):
                torch.index_select(_bits(layer[key]), 1, row, out=out[i])
            payload[wire] = out.view(layers[0][key].dtype)
        return payload

    @torch.inference_mode()
    def recv(self, slot: int, payload: dict, n_pages: int, seq_len: int) -> None:
        """Pop ``n_pages`` fresh pages off the decode engine's free stack
        into ``slot``'s block-table row, write the payload's first
        ``n_pages`` pages into them (a whole-row payload's dead lanes are
        dropped) and set the slot's ``seq_len``."""
        cache, dev = self.dst.cache, self.dst.device
        pps = cache["block_tables"].shape[1]
        lane = torch.arange(pps, device=dev)
        block_tables, cache["free_top"] = allocate(
            cache["block_tables"], cache["free_stack"], cache["free_top"],
            torch.full((pps,), slot, device=dev), lane, lane < n_pages)
        dst = block_tables[slot, :n_pages].long()
        for i, layer in enumerate(cache["layers"]):
            for key, wire in _WIRE.items():
                if key in layer:
                    _bits(layer[key]).index_copy_(1, dst, _bits(payload[wire][i])[:, :n_pages])
        cache["seq_lens"][slot] = seq_len

    def warmup(self) -> None:
        """One no-op round trip (slot 0 gathered, zero pages installed)."""
        self.recv(0, self.send(0), 0, 0)

    def transfer(self, src_slot: int, request: Request, first_token: int) -> int:
        """Move one held finished slot: gather its live pages on the
        prefill engine, seat a decode slot, scatter and install on the
        decode engine, then release the source slot (keep-aware with the
        prefix cache: a shared page frees only at refcount zero).  Returns
        the decode slot."""
        src, dst = self.src, self.dst
        n_pages = int(pages_for(request.prompt_len, src.plugin.page_size))
        payload = self.send(src_slot, n_pages)
        dst_slot = dst.adopt_prefilled(request, first_token)
        self.recv(dst_slot, payload, n_pages, request.prompt_len)
        del payload
        src.release_held(src_slot)
        moved = n_pages * self._page_bytes
        self.transfers += 1
        self.pages_moved += n_pages
        self.bytes_moved += moved
        for eng in (src, dst):
            eng.metrics["page_transfers"] += 1
            eng.metrics["page_transfer_pages"] += n_pages
            eng.metrics["page_transfer_bytes"] += moved
        dst.sched.events.append(("page_transfer", request.uid, n_pages, moved))
        twin_registry().record_measured("transfer.page_bytes", self.bytes_moved,
                                        source="serving/transfer.PagedKVTransport")
        return dst_slot


class DisaggregatedPair:
    """One prefill-role engine (requests clamped to one new token: the
    prompt and the first sampled token), one decode-role engine, and the
    transport between them, over one model.

    ``run(trace)`` returns the ``{uid: tokens}`` a single engine's ``run``
    would, with greedy tokens equal to it.  Speculation lives on the decode
    side (the prefill role is forced plain); multi-tenant adapters need one
    :class:`~.adapters.AdapterStore` per role (``adapters`` for decode,
    ``prefill_adapters`` for prefill, identical weights published) or none.
    Per-tick deadlines belong to the fused engine: both roles run with
    ``default_deadline_ticks=0`` and requests cross without a deadline.

    :meth:`submit` / :meth:`tick` / :meth:`busy` expose the host loop a step
    at a time (the fleet router drives pairs so), and
    :meth:`remaining_requests` extends the drain contract across the pair.
    """

    def __init__(self, model, plugin=None, generation_config=None, *, seed: int = 0,
                 device=None, prefill_plugin=None, adapters=None, prefill_adapters=None):
        from ..utils.dataclasses import ServingPlugin

        plugin = plugin or ServingPlugin()
        if (adapters is None) != (prefill_adapters is None):
            raise ValueError(
                "adapter traffic crosses the split: pass BOTH role stores (adapters= "
                "for the decode engine, prefill_adapters= for the prefill engine, "
                "published identical weights) or neither")
        plugin = dataclasses.replace(plugin, default_deadline_ticks=0)
        prefill_plugin = dataclasses.replace(prefill_plugin or plugin,
                                             default_deadline_ticks=0, speculate="off")
        self.prefill_engine = ServingEngine(model, prefill_plugin, generation_config,
                                            seed=seed, device=device, hold_finished=True,
                                            adapters=prefill_adapters)
        self.decode_engine = ServingEngine(model, plugin, generation_config, seed=seed,
                                           device=device, adapters=adapters)
        self.transport = PagedKVTransport(self.prefill_engine, self.decode_engine)
        self._pending: list[Request] = []
        self._i = 0
        self._originals: dict[int, Request] = {}
        self._done: dict[int, list[int]] = {}

    def preflight(self) -> tuple:
        """The pair's host preflight (``analysis/distributed_audit``):
        schema agreement and the predicted wire bytes per page."""
        from ..analysis.distributed_audit import pair_preflight

        return pair_preflight(self.prefill_engine.model.config, self.prefill_engine.plugin,
                              self.decode_engine.plugin,
                              adapters=self.decode_engine.adapters is not None)

    def warmup(self) -> None:
        self.prefill_engine.warmup()
        self.decode_engine.warmup()
        self.transport.warmup()

    @property
    def warmed_up(self) -> bool:
        return self.prefill_engine.warmed_up and self.decode_engine.warmed_up

    # -- the incremental host loop -------------------------------------------

    def submit(self, request: Request) -> None:
        """Queue one request (its arrival is kept against the prefill
        engine's clock)."""
        key = (request.arrival_step, request.uid)
        lo = self._i + bisect.bisect_right(
            [(r.arrival_step, r.uid) for r in self._pending[self._i:]], key)
        self._pending.insert(lo, request)
        self._originals[request.uid] = request

    def tick(self) -> bool:
        """One host-loop decision: deliver due arrivals, stream every held
        prefill the decode side can seat, then step exactly one engine.
        Returns False when there is nothing left to do."""
        P, D = self.prefill_engine, self.decode_engine
        eos = P.gen_config.eos_token_id
        while self._i < len(self._pending) and self._pending[self._i].arrival_step <= P.steps:
            P.add_request(dataclasses.replace(self._pending[self._i], max_new_tokens=1,
                                              deadline_ticks=0))
            self._i += 1
        while P.held and self._dst_capacity():
            slot = P.held[0]
            uid = P.sched.slots[slot].request.uid
            tok = P.results[uid][0]
            if self._originals[uid].max_new_tokens == 1 or (eos is not None and tok == eos):
                # the first token finished the request: nothing to stream
                P.release_held(slot)
                self._done[uid] = [tok]
                continue
            self.transport.transfer(
                slot, dataclasses.replace(self._originals[uid], deadline_ticks=0), tok)
        if P.held and not self._dst_capacity() and not D.idle():
            # a finished prefill waits on decode capacity: decode first
            D.step()
        elif self._p_busy():
            P.step()
        elif not D.idle():
            D.step()
        elif self._i < len(self._pending):
            P.step()  # an idle tick advances the arrival clock
        elif P.held:
            raise RuntimeError(
                "disaggregated handoff wedged: held prefill slots with an idle decode "
                "engine that cannot seat them")  # pragma: no cover
        else:
            return False
        return True

    def busy(self) -> bool:
        """Work anywhere in the pair: undelivered arrivals, a busy prefill
        engine, a held handoff or a non-idle decode engine."""
        return (self._i < len(self._pending) or self._p_busy()
                or bool(self.prefill_engine.held) or not self.decode_engine.idle())

    def run(self, trace: list[Request], max_steps: int = 200_000) -> dict[int, list[int]]:
        for r in sorted(trace, key=lambda r: (r.arrival_step, r.uid)):
            self.submit(r)
        steps = 0
        while self.tick():
            steps += 1
            if steps >= max_steps:
                raise RuntimeError(f"disaggregated replay exceeded {max_steps} steps")
        return self.results

    @property
    def results(self) -> dict[int, list[int]]:
        return {**self.decode_engine.results, **self._done}

    @property
    def interrupted(self) -> bool:
        return self.prefill_engine.interrupted or self.decode_engine.interrupted

    def remaining_requests(self) -> list[Request]:
        """Every submitted original neither completed nor deliberately
        retired on either engine — undelivered, prefilling, held or
        decoding — once each, in submission order."""
        retired = self.prefill_engine.sched.retired_uids | self.decode_engine.sched.retired_uids
        results = self.results
        return [r for r in self._pending if r.uid not in results and r.uid not in retired]

    def _p_busy(self) -> bool:
        P = self.prefill_engine
        return bool(P.sched.waiting) or any(not st.finished for st in P.sched.slots.values())

    def _dst_capacity(self) -> bool:
        P, D = self.prefill_engine, self.decode_engine
        if not P.held or not D.sched.free_slots:
            return False
        req = P.sched.slots[P.held[0]].request
        # speculative decode books its first verify pass's worst case at
        # admission: the seat reserves the same headroom
        depth = 0
        if D.sched.speculate_k:
            depth = 1 + min(D.sched.speculate_k,
                            self._originals[req.uid].max_new_tokens - 1)
        if pages_for(req.prompt_len + depth, D.plugin.page_size) > D.sched.free_pages:
            return False
        if D.adapters is not None and req.adapter_id:
            return D.adapters.can_pin(req.adapter_id)
        return True

    def report(self) -> dict:
        t = self.transport
        return {
            "page_transfers": t.transfers,
            "page_transfer_pages": t.pages_moved,
            "page_transfer_bytes": t.bytes_moved,
            "prefill_steps": self.prefill_engine.steps,
            "decode_steps": self.decode_engine.steps,
        }


__all__ = ["DisaggregatedPair", "PagedKVTransport", "page_bytes", "transfer_accounting"]
