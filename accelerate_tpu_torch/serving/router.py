"""Fleet routing: N serving replicas behind deterministic prefix- and
adapter-affinity placement (mirrors ``accelerate_tpu/serving/router.py``:
``_Replica`` :58, ``FleetRouter`` :217, ``fleet_replay`` :508,
``fleet_chaos_replay`` :614).

- **Prefix affinity**: the router probes each replica's prefix index
  (:meth:`~.prefix_cache.PrefixCache.match`, no stats or LRU touched) for
  how many leading pages of the prompt it holds, and sends the request
  where its preamble is hot.  Requests routed but not yet admitted are
  kept in a per-replica *planned* hash set, so a burst of same-preamble
  arrivals converges on one replica before the first insert lands.
- **Adapter affinity**: a tenant stays on replicas whose adapter pool holds
  its weights resident, then on its sticky home replica, before load
  decides.
- **Load**: among equals, the shortest queue and the emptiest KV pool win,
  the lowest replica index last — the same trace and fleet give the same
  placement, always.

A ``replica_kill`` fault (site ``fleet_route``) drains a replica through
its ``remaining_requests()``: completed work stays completed and every
pending request re-routes exactly once, pre-marked in its target's
once-only offered-traffic set so the fleet's prefix hit rate counts it
once.  :meth:`FleetRouter.attach` chains an SLO monitor to every replica's
degradation ladder: the fleet escalates and relaxes in lockstep.

Two parts of the JAX router are not ported: ``warmup(prewarm_dir=)``
packs an XLA compile cache, which eager PyTorch has no counterpart of
(the port raises ``ValueError``), and the two-process fabric waits for
ROADMAP item A13.  The JAX reports' ``compiles_*`` fields are left out.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from ..telemetry import twin_registry
from .overload import refuse_tensor_parallel
from .scheduler import Request


class _Replica:
    """One fleet member — a fused :class:`~.engine.ServingEngine` or a
    :class:`~.transfer.DisaggregatedPair` (it has ``prefill_engine``) —
    behind one drive surface and the probes the router scores on."""

    def __init__(self, index: int, backend):
        self.index = index
        self.backend = backend
        self.is_pair = hasattr(backend, "prefill_engine")
        self.alive = True
        self.routed = 0
        # hash chains routed here, admitted or not: the look-ahead index
        self.planned: set[bytes] = set()

    @property
    def engines(self) -> list:
        if self.is_pair:
            return [self.backend.prefill_engine, self.backend.decode_engine]
        return [self.backend]

    @property
    def role(self) -> str:
        return "pair" if self.is_pair else "engine"

    @property
    def _admit_engine(self):
        """The engine whose scheduler admits routed traffic and owns the
        prefix cache the probe reads."""
        return self.backend.prefill_engine if self.is_pair else self.backend

    def warmup(self) -> None:
        if not self.backend.warmed_up:
            self.backend.warmup()

    def submit(self, request: Request) -> None:
        """Hand a routed request to the backend now, its arrival rebased to
        the replica's own virtual clock."""
        r = dataclasses.replace(request, arrival_step=self._admit_engine.steps)
        if self.is_pair:
            self.backend.submit(r)
        else:
            self.backend.add_request(r)
        self.routed += 1

    def busy(self) -> bool:
        return self.backend.busy() if self.is_pair else not self.backend.idle()

    def tick(self) -> None:
        if self.is_pair:
            self.backend.tick()
        else:
            self.backend.step()

    @property
    def results(self) -> dict:
        return self.backend.results

    def remaining_requests(self) -> list[Request]:
        return self.backend.remaining_requests()

    def prefix_counted(self) -> set[int]:
        """Uids whose preamble this replica counted as offered traffic."""
        out: set[int] = set()
        for eng in self.engines:
            out |= eng.sched._prefix_counted
        return out

    def mark_prefix_counted(self, uids) -> None:
        self._admit_engine.sched.mark_prefix_counted(uids)

    def queue_len(self) -> int:
        n = sum(len(eng.sched.waiting) for eng in self.engines)
        if self.is_pair:
            n += len(self.backend._pending) - self.backend._i
        return n

    def kv_occupancy(self) -> float:
        return max(eng.sched.used_pages / eng.sched.num_pages for eng in self.engines)

    def prefix_score(self, request: Request) -> int:
        """Prompt tokens this replica's prefix index (live pages and planned
        routes) covers — 0 with the cache off."""
        pc = self._admit_engine.prefix
        if pc is None:
            return 0
        hashes = pc.block_hashes(request.prompt, request.adapter_id)
        live = len(pc.match(hashes))
        planned = 0
        for h in hashes:
            if h not in self.planned:
                break
            planned += 1
        return max(live, planned) * pc.page_size

    def plan_prefix(self, request: Request) -> None:
        pc = self._admit_engine.prefix
        if pc is not None:
            self.planned.update(pc.block_hashes(request.prompt, request.adapter_id))

    def adapter_resident(self, tid: int) -> bool:
        # resident on any of the replica's pools (a pair has one per role)
        return bool(tid) and any(eng.adapters is not None and eng.adapters.resident(tid)
                                 for eng in self.engines)

    def stats_row(self) -> dict:
        prefix_rates = [eng.prefix.hit_rate() for eng in self.engines if eng.prefix is not None]
        adapter_rates = [eng.adapters.hit_rate() for eng in self.engines
                         if eng.adapters is not None]
        return {
            "replica": self.index,
            "role": self.role,
            "alive": self.alive,
            "routed": self.routed,
            "completed": len(self.results),
            "engine_steps": sum(eng.steps for eng in self.engines),
            "waiting": self.queue_len(),
            "kv_occupancy": round(self.kv_occupancy(), 4),
            "prefix_hit_rate": round(max(prefix_rates), 4) if prefix_rates else 0.0,
            "adapter_pool_hit_rate": round(max(adapter_rates), 4) if adapter_rates else 0.0,
        }


class FleetRouter:
    """Deterministic affinity router over N replicas (fused engines or
    disaggregated pairs, freely mixed).

    ``policy`` is ``"affinity"`` (prefix, then adapter, then load; the
    default) or ``"round_robin"``.  The placement score is the tuple
    ``(prefix_tokens, adapter_affinity, -queue_len, -kv_occupancy,
    -index)`` maximised over alive replicas.  ``respawn`` (optional), a
    factory ``index -> backend``, appends a fresh warmed replica after a
    ``replica_kill`` drain; without it the fleet narrows.
    """

    def __init__(self, replicas: Sequence, *, policy: str = "affinity",
                 respawn: Optional[Callable[[int], object]] = None):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        if policy not in ("affinity", "round_robin"):
            raise ValueError(f"unknown routing policy {policy!r}: "
                             "expected 'affinity' or 'round_robin'")
        self.replicas = [_Replica(i, b) for i, b in enumerate(replicas)]
        refuse_tensor_parallel("the fleet router", *(e for r in self.replicas for e in r.engines))
        self.policy = policy
        self.respawn = respawn
        self.routed_by = {"prefix": 0, "adapter": 0, "load": 0}
        self.drain_events: list[dict] = []
        self.clock = 0
        self.monitor = None
        self._rr = 0
        self._home: dict[int, int] = {}   # tenant -> sticky home replica

    def warmup(self, prewarm_dir: Optional[str] = None) -> None:
        """Warm every replica not warm yet.  ``prewarm_dir`` (the JAX router's packed
        compile cache) has no counterpart in eager PyTorch: passing one
        raises ``ValueError``."""
        if prewarm_dir is not None:
            raise ValueError(
                "prewarm_dir packs an XLA compile cache in the JAX package; the PyTorch "
                "port compiles no program and has no cache to pack (a deliberate "
                "departure)")
        for rep in self.replicas:
            rep.warmup()

    def alive_replicas(self) -> list[_Replica]:
        return [rep for rep in self.replicas if rep.alive]

    def route(self, request: Request) -> _Replica:
        """Place one request on the best-scoring alive replica, update the
        planned-prefix index and the tenant's home.  Returns the replica."""
        alive = self.alive_replicas()
        if not alive:
            raise RuntimeError("fleet has no alive replicas to route to (every replica "
                               "drained without a respawn factory)")
        if self.policy == "round_robin":
            rep = alive[self._rr % len(alive)]
            self._rr += 1
            reason = "load"
        else:
            tid = request.adapter_id

            def score(r: _Replica):
                affinity = (2 if r.adapter_resident(tid)
                            else 1 if tid and self._home.get(tid) == r.index else 0)
                return (r.prefix_score(request), affinity, -r.queue_len(),
                        -r.kv_occupancy(), -r.index)

            rep = max(alive, key=score)
            s = score(rep)
            reason = "prefix" if s[0] > 0 else "adapter" if s[1] > 0 else "load"
        self.routed_by[reason] += 1
        rep.plan_prefix(request)
        if request.adapter_id:
            self._home[request.adapter_id] = rep.index
        rep.submit(request)
        return rep

    def drain(self, rep: _Replica) -> list[Request]:
        """Kill one replica: collect its survivors through the
        ``remaining_requests()`` contract, mark it dead (its completed
        results stay), re-route every survivor exactly once and pre-seed
        each target's once-only prefix counting.  Returns the survivors."""
        survivors = rep.remaining_requests()
        counted = rep.prefix_counted()
        rep.alive = False
        self.drain_events.append({"replica": rep.index, "at_clock": self.clock,
                                  "survivors": len(survivors)})
        if self.respawn is not None:
            fresh = _Replica(len(self.replicas), self.respawn(rep.index))
            fresh.warmup()
            self.replicas.append(fresh)
        for r in survivors:
            target = self.route(r)
            if r.uid in counted:
                target.mark_prefix_counted([r.uid])
        return survivors

    def _kill_one(self) -> None:
        """The ``replica_kill`` payload: drain the highest-index busy alive
        replica, else the highest-index alive one.  A one-replica fleet
        without respawn ignores the kill (nowhere to re-route)."""
        alive = self.alive_replicas()
        if len(alive) <= 1 and self.respawn is None:
            return
        busy = [rep for rep in alive if rep.busy()]
        self.drain((busy or alive)[-1])

    def run(self, trace: list[Request], max_steps: int = 500_000) -> dict:
        """Replay a trace: each fleet tick fires the ``fleet_route`` fault
        point, routes due arrivals, then ticks every busy alive replica
        once.  Returns the merged results."""
        from ..resilience.faults import fault_point

        pending = sorted(trace, key=lambda r: (r.arrival_step, r.uid))
        i = 0
        while True:
            for e in fault_point("fleet_route"):
                if e.kind == "replica_kill":
                    self._kill_one()
            while i < len(pending) and pending[i].arrival_step <= self.clock:
                self.route(pending[i])
                i += 1
            busy = [rep for rep in self.alive_replicas() if rep.busy()]
            if not busy and i >= len(pending):
                break
            for rep in busy:
                rep.tick()
            self.clock += 1
            if self.clock >= max_steps:
                raise RuntimeError(f"fleet replay exceeded {max_steps} ticks")
        return self.results

    @property
    def results(self) -> dict:
        """Results across every replica, drained ones included."""
        out: dict = {}
        for rep in self.replicas:
            out.update(rep.results)
        return out

    def attach(self, monitor) -> None:
        """Chain an SLO monitor to the whole fleet: a trip escalates every
        alive replica's ladder one stage, a recovery relaxes every one;
        callbacks the monitor already carries keep firing."""
        from .overload import _chained

        self.monitor = monitor
        monitor.on_trip = _chained(self.escalate, monitor.on_trip)
        monitor.on_recover = _chained(self.relax, monitor.on_recover)

    def escalate(self, metric=None, quantile=None, value=None) -> None:
        for rep in self.alive_replicas():
            for eng in rep.engines:
                eng.ladder.escalate(metric, quantile, value)

    def relax(self, metric=None, quantile=None, value=None) -> None:
        for rep in self.alive_replicas():
            for eng in rep.engines:
                eng.ladder.relax(metric, quantile, value)

    def ttft_ticks(self) -> list[int]:
        """Every replica's TTFT samples in virtual ticks."""
        return [t for rep in self.replicas for eng in rep.engines for t in eng.ttft_ticks]

    def prefix_hit_rate(self) -> float:
        """Index-served cacheable pages over cacheable pages offered, summed
        over every replica's cache (each request counted once, across a
        drain too)."""
        hits = lookups = 0
        for rep in self.replicas:
            for eng in rep.engines:
                if eng.prefix is not None:
                    hits += eng.prefix.stats["hit_pages"]
                    lookups += eng.prefix.stats["lookup_pages"]
        return round(hits / lookups, 4) if lookups else 0.0

    def adapter_pool_hit_rate(self) -> float:
        hits = total = 0
        for rep in self.replicas:
            for eng in rep.engines:
                if eng.adapters is not None:
                    hits += eng.adapters.hits
                    total += eng.adapters.hits + eng.adapters.swaps
        return round(hits / total, 4) if total else 0.0

    def transfer_bytes(self) -> int:
        return sum(rep.backend.transport.bytes_moved for rep in self.replicas if rep.is_pair)

    def report(self) -> dict:
        return {
            "replicas": len(self.replicas),
            "alive": len(self.alive_replicas()),
            "policy": self.policy,
            "routed_by_prefix": self.routed_by["prefix"],
            "routed_by_adapter": self.routed_by["adapter"],
            "routed_by_load": self.routed_by["load"],
            "drain_events": list(self.drain_events),
            "fleet_clock": self.clock,
            "per_replica": [rep.stats_row() for rep in self.replicas],
        }


def fleet_replay(router: FleetRouter, trace: list[Request], *, slo_monitor=None) -> dict:
    """Run a trace through a fleet (warming it first) and compose the fleet
    report: every field present, zeros on an empty trace.  Records the
    ``fleet.request_goodput`` twin (the clean-run prediction 1.0 only with
    no fault plan active), the ``fleet.prefix_hit_rate`` /
    ``fleet.adapter_pool_hit_rate`` twins (predicted by the single-cache
    trace models: informational, since a fleet splits traffic) and the
    pairs' summed ``transfer.page_bytes``."""
    from ..resilience.faults import active_fault_plan

    router.warmup()
    if slo_monitor is not None:
        router.attach(slo_monitor)
    results = router.run(trace)
    if slo_monitor is not None:
        for rep in router.replicas:
            for eng in rep.engines:
                if eng.slo is not slo_monitor:
                    slo_monitor.observe_many("token_latency_s", eng.token_gaps_s)
                    slo_monitor.observe_many("ttft_s", eng.ttft_s)
    ticks = router.ttft_ticks()
    goodput = round(len(results) / len(trace), 4) if trace else 0.0
    prefix_rate = router.prefix_hit_rate()
    adapter_rate = router.adapter_pool_hit_rate()
    reg = twin_registry()
    source = "serving/router.fleet_replay"
    reg.record_measured("fleet.request_goodput", goodput, source=source)
    if active_fault_plan() is None:
        reg.record_predicted("fleet.request_goodput", 1.0 if trace else 0.0,
                             source="serving/router clean-run model")
    reg.record_measured("fleet.prefix_hit_rate", prefix_rate, source=source)
    reg.record_measured("fleet.adapter_pool_hit_rate", adapter_rate, source=source)
    admit = router.replicas[0]._admit_engine
    if admit.prefix is not None and trace:
        from .harness import predicted_prefix_hit_rate

        p = admit.plugin
        reg.record_predicted("fleet.prefix_hit_rate", predicted_prefix_hit_rate(
            trace, num_slots=p.num_slots, num_pages=p.num_pages, page_size=p.page_size,
            pages_per_slot=p.pages_per_slot, prefill_chunk=p.prefill_chunk),
            source="serving/router single-cache trace model")
    stores = [eng.adapters for rep in router.replicas for eng in rep.engines
              if eng.adapters is not None]
    if stores and trace:
        from .adapters import predicted_adapter_hit_rate

        tenant_ids = [r.adapter_id for r in sorted(trace, key=lambda r: (r.arrival_step, r.uid))]
        reg.record_predicted("fleet.adapter_pool_hit_rate",
                             predicted_adapter_hit_rate(tenant_ids, stores[0].plugin.pool_slots),
                             source="serving/router single-pool trace model")
    wire_bytes = router.transfer_bytes()
    if wire_bytes:
        reg.record_measured("transfer.page_bytes", wire_bytes, source=source)
    return {
        "requests": len(trace),
        "completed": len(results),
        "goodput_frac": goodput,
        "ttft_p50_ticks": round(float(np.percentile(np.asarray(ticks), 50)), 2) if ticks else 0.0,
        "prefix_hit_rate": prefix_rate,
        "adapter_pool_hit_rate": adapter_rate,
        "page_transfer_bytes": wire_bytes,
        **router.report(),
        "results": results,
    }


def fleet_chaos_replay(router_factory: Callable[[], FleetRouter], trace: list[Request], plan,
                       *, baseline_parity: bool = True) -> dict:
    """Fleet chaos soak: replay the trace through a fleet while ``plan``
    kills replicas (``replica_kill`` at ``fleet_route``).  The pin: each
    victim drains through the survivors contract, pending work re-routes
    exactly once, and the surviving tokens equal a fault-free replay of the
    trace through a fresh identical fleet (``token_parity``)."""
    from ..resilience.faults import fault_plan as _fault_plan

    with _fault_plan(plan):
        router = router_factory()
        router.warmup()
        results = router.run(trace)
    token_parity = True
    if baseline_parity and results:
        baseline = router_factory()
        baseline.warmup()
        base_results = baseline.run(trace)
        token_parity = {uid: base_results.get(uid) for uid in results} == results
    goodput = round(len(results) / len(trace), 4) if trace else 0.0
    twin_registry().record_measured("fleet.request_goodput", goodput,
                                    source="serving/router.fleet_chaos_replay")
    return {
        "requests": len(trace),
        "completed": len(results),
        "goodput_frac": goodput,
        "faults_fired": len(plan.fired),
        "drain_events": list(router.drain_events),
        "token_parity": token_parity,
        **{k: v for k, v in router.report().items() if k != "drain_events"},
        "results": results,
    }


__all__ = ["FleetRouter", "fleet_chaos_replay", "fleet_replay"]
