"""Twin registry: every predicted/measured pair in one queryable place
(mirrors ``accelerate_tpu/telemetry/twins.py``, standard library only).

Each accounting site **records** its side of a pair under a stable name
(``<subsystem>.<quantity>``, the canonical set in :data:`STANDARD_TWINS`,
the JAX package's), with units and a per-twin drift tolerance;
:meth:`TwinRegistry.drift_report` says which cost model drifts and by how
much.  ``rel_err`` is ``|m - p| / max(|p|, |m|)``, 0.0 when both sides
agree or a side is missing; ``status`` is ``idle`` (a side missing),
``ok``, ``warn`` (beyond ``tolerance``) or ``error`` (beyond
``error_tolerance``, default twice the tolerance).

The port's serving replay (``serving/harness.py``) records the adapter
pool's hit rate, the speculative acceptance and tokens per step, and the
prefix cache's hit rate.  Recording is host-side.  The process-global
instance behind :func:`twin_registry` is what the accounting sites feed;
:meth:`TwinRegistry.reset` clears it.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

# the canonical twin set every bench report declares up front (zeros-clean:
# the `twins` block always carries all of these, idle rows included) —
# name -> (units, tolerance, error_tolerance or None for the 2x default)
STANDARD_TWINS: dict[str, tuple] = {
    # ops/streaming.offload_transfer_accounting vs xplane.streaming_overlap_report
    "offload_transfer.overlap_frac": ("frac", 0.25, None),
    # ops/collective_matmul.tp_comm_accounting vs xplane.ici_overlap_report
    "tp_comm.overlap_frac": ("frac", 0.25, None),
    # parallel/hierarchical.dcn_comm_accounting vs measure_dcn_bytes — the
    # byte models agree EXACTLY by construction (pinned), so any drift is
    # a real model bug
    "dcn_comm.dcn_bytes": ("bytes/step/device", 0.01, None),
    # serving/harness.predicted_pool_utilization vs the measured replay
    "kv_pool.utilization": ("frac", 0.25, None),
    # serving/adapters.predicted_adapter_hit_rate vs AdapterStore.hit_rate
    "adapter_pool.hit_rate": ("frac", 0.25, None),
    # serving/speculate.predicted_acceptance (model-free replay over the
    # measured streams) vs the engine's accepted/drafted counters — the
    # prediction error is the eviction/recompute re-decode traffic
    "speculate.accept_rate": ("frac", 0.25, None),
    # same replay's verify-emitted tokens per pass vs the measured
    # decode_emitted_tokens / decode_lane_passes ratio
    "speculate.tokens_per_step": ("tokens/step", 0.25, None),
    # resilience/goodput.goodput_accounting (or the clean-run model) vs
    # GoodputTracker
    "goodput.goodput_frac": ("frac", 0.1, None),
    # resilience/peer_ckpt.peer_ckpt_accounting vs PeerSnapshotter's captured
    # host bytes — priced from the SAME schema dict, so tolerance 0.0: ANY
    # disagreement is an error
    "recovery.peer_snapshot_bytes": ("bytes", 0.0, 0.0),
    # Accelerator.recover wall time — informational (no analytic model
    # predicts host I/O latency; tolerance 1.0 never errors)
    "recovery.restore_time_s": ("s", 1.0, 1.0),
    # the recompile guard: predicted 0 post-warmup vs the monitoring stream
    # — tolerance 0.0: ANY disagreement is an error
    "compiles.steady_state": ("events", 0.0, 0.0),
    # serving overload control (serving/harness._overload_fields): the
    # clean-run model predicts ZERO sheds/misses/cancels/reclaims — any
    # measured event on a clean, unarmed replay is an error.  With a
    # FaultPlan active, overload knobs armed, or deadlines in the trace,
    # only the measured side records (a chaos soak owns its predictions;
    # intended admission-control shedding is policy, not drift) — the rows
    # never false-alarm on purpose-injected chaos or configured shedding
    "serving.requests_shed": ("events", 0.0, 0.0),
    "serving.deadline_misses": ("events", 0.0, 0.0),
    "serving.cancelled": ("events", 0.0, 0.0),
    "serving.pages_reclaimed_on_cancel": ("pages", 0.0, 0.0),
    # completed / (completed + deliberately retired); clean-run model: 1.0
    "serving.request_goodput_frac": ("frac", 0.1, None),
    # serving/prefix_cache.predicted_prefix_hit_rate (model-free trace
    # replay, unbounded index) vs the PrefixCache's admission counters —
    # the prediction error is capacity traffic (LRU reclaims, flush
    # faults, eviction-driven re-admissions re-hitting their own pages)
    "prefix_cache.hit_rate": ("frac", 0.25, None),
    # TTFT in virtual engine ticks: predicted = the SAME trace replayed
    # with reuse OFF (the no-reuse baseline bench runs), measured = with
    # reuse.  The drift IS the reuse win — tolerance 1.0 keeps the row
    # informational (it can never read as model error)
    "prefix_cache.ttft_ticks": ("ticks", 1.0, 1.0),
    # serving/transfer.transfer_accounting (every request ships
    # pages_for(prompt) live pages once, prefill->decode) vs the
    # transport's executed byte counter — exact by construction unless a
    # request never reached the handoff
    "transfer.page_bytes": ("bytes", 0.01, None),
    # serving/paged_cache.kv_page_bytes (codes + per-page scales for
    # int8/fp8 pools) vs the allocated pool arrays' actual nbytes per page
    # — one formula feeds the allocator, the transfer wire unit and this
    # row, so the sides agree EXACTLY; tolerance 0.0 makes any drift
    # (a scale array the formula forgot, a dtype change) an error
    "kv_quant.page_bytes": ("bytes/page", 0.0, 0.0),
    # analysis/distributed_audit.pair_preflight's static wire unit (the
    # GL403 schema's page_bytes, predicted before any engine exists) vs
    # the constructed PagedKVTransport's _page_bytes — gate and runtime
    # read ONE wire_schema() derivation, so the sides agree EXACTLY;
    # tolerance 0.0 turns any drift (the gate auditing a different schema
    # than the transport enforces) into an error
    "distributed.wire_bytes_per_page": ("bytes/page", 0.0, 0.0),
    # serving/router.fleet_replay: completed / offered across the whole
    # fleet; the clean-run model (no fault plan) predicts 1.0 — a chaos
    # soak records measured only, and a drain re-routes survivors so the
    # goodput holds through a replica kill
    "fleet.request_goodput": ("frac", 0.1, None),
    # fleet-aggregate prefix hit rate (index-served cacheable pages over
    # cacheable pages offered, summed over every replica's cache, each
    # request's offered traffic counted ONCE across drain re-routes) vs
    # the single-cache trace model — informational tolerance: a fleet
    # splits traffic across indexes, and the measured-vs-model gap IS the
    # routing quality the affinity policy exists to close
    "fleet.prefix_hit_rate": ("frac", 1.0, 1.0),
    # fleet-aggregate adapter-pool hit rate vs the single-pool LRU trace
    # model — informational for the same reason (tenant traffic splits;
    # adapter affinity closes the gap)
    "fleet.adapter_pool_hit_rate": ("frac", 1.0, 1.0),
}


@dataclasses.dataclass
class Twin:
    """One predicted/measured pair.  ``None`` means the side was never
    recorded this run (distinct from a recorded ``0.0``)."""

    name: str
    units: str = ""
    tolerance: float = 0.25
    error_tolerance: Optional[float] = None  # None -> 2 * tolerance
    predicted: Optional[float] = None
    measured: Optional[float] = None
    source: str = ""

    @property
    def rel_err(self) -> float:
        if self.predicted is None or self.measured is None:
            return 0.0
        p, m = float(self.predicted), float(self.measured)
        denom = max(abs(p), abs(m))
        if denom == 0.0:
            return 0.0
        return abs(m - p) / denom

    @property
    def status(self) -> str:
        if self.predicted is None or self.measured is None:
            return "idle"
        err = self.rel_err
        hard = self.error_tolerance if self.error_tolerance is not None \
            else 2.0 * self.tolerance
        if err > hard:
            return "error"
        if err > self.tolerance:
            return "warn"
        return "ok"

    def row(self) -> dict:
        """The JSON row bench.py's ``twins`` block carries (zeros-clean:
        unrecorded sides read as 0.0, status says ``idle``)."""
        return {
            "predicted": round(float(self.predicted or 0.0), 6),
            "measured": round(float(self.measured or 0.0), 6),
            "rel_err": round(self.rel_err, 6),
            "status": self.status,
            "units": self.units,
            "tolerance": self.tolerance,
        }


class TwinRegistry:
    """Central registry of predicted/measured twins (thread-safe: the
    serving engine and an async checkpoint drain may record concurrently)."""

    def __init__(self):
        self._twins: dict[str, Twin] = {}
        self._lock = threading.Lock()

    # -- registration / recording -------------------------------------------

    def register(self, name: str, *, units: str = "", tolerance: float = 0.25,
                 error_tolerance: Optional[float] = None,
                 source: str = "") -> Twin:
        """Idempotent: a twin registered twice keeps its recorded values
        (metadata from the FIRST registration wins — stable names carry
        stable units/tolerances)."""
        with self._lock:
            twin = self._twins.get(name)
            if twin is None:
                twin = Twin(name=name, units=units, tolerance=tolerance,
                            error_tolerance=error_tolerance, source=source)
                self._twins[name] = twin
            return twin

    def declare_standard_twins(self) -> None:
        """Pre-register the canonical set (:data:`STANDARD_TWINS`) so the
        bench ``twins`` block is zeros-clean: every name present, idle rows
        carrying zeros, whether or not the run exercised the subsystem."""
        for name, (units, tol, err_tol) in STANDARD_TWINS.items():
            self.register(name, units=units, tolerance=tol,
                          error_tolerance=err_tol)

    def _record(self, name: str, side: str, value, source: str,
                units: str, tolerance: Optional[float]) -> Twin:
        meta = STANDARD_TWINS.get(name)
        twin = self.register(
            name,
            units=units or (meta[0] if meta else ""),
            tolerance=tolerance if tolerance is not None
            else (meta[1] if meta else 0.25),
            error_tolerance=meta[2] if meta else None,
            source=source,
        )
        with self._lock:
            setattr(twin, side, float(value))
            if source:
                twin.source = source
        return twin

    def record_predicted(self, name: str, value, *, source: str = "",
                         units: str = "", tolerance: Optional[float] = None) -> Twin:
        return self._record(name, "predicted", value, source, units, tolerance)

    def record_measured(self, name: str, value, *, source: str = "",
                        units: str = "", tolerance: Optional[float] = None) -> Twin:
        return self._record(name, "measured", value, source, units, tolerance)

    def record(self, name: str, *, predicted=None, measured=None,
               source: str = "", units: str = "",
               tolerance: Optional[float] = None) -> Twin:
        if predicted is not None:
            self.record_predicted(name, predicted, source=source, units=units,
                                  tolerance=tolerance)
        if measured is not None:
            self.record_measured(name, measured, source=source, units=units,
                                 tolerance=tolerance)
        return self._twins[name]

    # -- queries ------------------------------------------------------------

    def get(self, name: str) -> Optional[Twin]:
        return self._twins.get(name)

    def names(self) -> list[str]:
        return sorted(self._twins)

    def drift_report(self) -> dict:
        """``name -> {predicted, measured, rel_err, status, units,
        tolerance}``, sorted by name — the unified ``twins`` block bench.py
        emits, and the table the autotuner ranks knobs with."""
        return {name: self._twins[name].row() for name in self.names()}

    def drifting(self, min_status: str = "warn") -> list[Twin]:
        """Twins at or beyond ``min_status`` (``"warn"`` or ``"error"``),
        worst first — the autotuner's knob-ranking order."""
        order = {"warn": ("warn", "error"), "error": ("error",)}[min_status]
        hits = [t for t in self._twins.values() if t.status in order]
        return sorted(hits, key=lambda t: -t.rel_err)

    def flat_metrics(self, prefix: str = "twins") -> dict:
        """``{"twins/<name>/rel_err": ...}`` — the tracker-ready flattening
        (``Accelerator.log(registry.flat_metrics())`` lands it in any
        configured backend, the always-available JSONL one included)."""
        out = {}
        for name in self.names():
            row = self._twins[name].row()
            for k in ("predicted", "measured", "rel_err"):
                out[f"{prefix}/{name}/{k}"] = row[k]
        return out

    def reset(self) -> None:
        with self._lock:
            self._twins.clear()


_REGISTRY = TwinRegistry()


def twin_registry() -> TwinRegistry:
    """The process-global registry every accounting site records into."""
    return _REGISTRY
