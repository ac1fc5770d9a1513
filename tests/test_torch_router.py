"""The port's fleet router (``serving/router.py``) held against the JAX
package's: one counterpart per case of ``tests/test_router.py:103-343``.

Both fleets serve the same f32 weights (``torch_state_from_flax``) with
``"native"`` attention on the CPU over the same traces: placements (which
replica each request was submitted to, in order), routed-by counts, drain
events and results equal JAX's, and the fleet's tokens equal one fused
engine's.  Prefix affinity beats round robin, adapter affinity keeps
tenants home, a ``replica_kill`` drains and re-routes exactly once with
the survivors' tokens bitwise, offered prefix traffic is counted once,
respawn restores capacity, the ladder moves in lockstep and the fleet
twins are recorded.

Not ported, so without a counterpart here: ``test_router.py:371`` (the
prewarm pack: JAX's compile cache has no eager-PyTorch counterpart; the
port's ``warmup(prewarm_dir=)`` raises, pinned below) and ``:392`` (the
two-process fabric, ROADMAP item A13).  Every engine shares one geometry
(slots 4, pages of 4, pool 24, chunk 8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.generation import GenerationConfig as JaxGenerationConfig
from accelerate_tpu.models import llama as jl
from accelerate_tpu.ops import lora as jlora
from accelerate_tpu.resilience import faults as jfaults
from accelerate_tpu.serving import AdapterStore as JaxAdapterStore
from accelerate_tpu.serving import DisaggregatedPair as JaxDisaggregatedPair
from accelerate_tpu.serving import FleetRouter as JaxFleetRouter
from accelerate_tpu.serving import Request as JaxRequest
from accelerate_tpu.serving import ServingEngine as JaxServingEngine
from accelerate_tpu.serving import fleet_chaos_replay as jax_fleet_chaos_replay
from accelerate_tpu.serving import fleet_replay as jax_fleet_replay
from accelerate_tpu.utils.dataclasses import LoraPlugin as JaxLoraPlugin
from accelerate_tpu.utils.dataclasses import ServingPlugin as JaxServingPlugin
from accelerate_tpu_torch import GenerationConfig, LlamaConfig, LlamaForCausalLM
from accelerate_tpu_torch.models.convert import lora_tree_from_flax, torch_state_from_flax
from accelerate_tpu_torch.resilience import FaultEvent, FaultPlan, fault_plan
from accelerate_tpu_torch.serving import (
    AdapterStore,
    DisaggregatedPair,
    FleetRouter,
    ServingEngine,
    fleet_chaos_replay,
    fleet_replay,
    replay,
    synthesize_trace,
)
from accelerate_tpu_torch.telemetry import SLOMonitor, twin_registry
from accelerate_tpu_torch.utils.dataclasses import LoraPlugin, ServingPlugin

MAX_NEW = 16
GEOMETRY = dict(num_slots=4, page_size=4, pages_per_slot=8, num_pages=24, prefill_chunk=8,
                prefill_buckets=(4, 8), decode_kernel="native")
SAME = ("requests", "completed", "goodput_frac", "ttft_p50_ticks", "prefix_hit_rate",
        "adapter_pool_hit_rate", "page_transfer_bytes", "replicas", "alive", "policy",
        "routed_by_prefix", "routed_by_adapter", "routed_by_load", "drain_events",
        "fleet_clock", "results")


@pytest.fixture(scope="module")
def models():
    jmodel = jl.LlamaForCausalLM(jl.LlamaConfig.tiny(dtype=jnp.float32))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tmodel = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device="cpu")
    tmodel.load_state_dict(torch_state_from_flax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


def _jengine(models, store=None, **kw):
    jmodel, params, _ = models
    return JaxServingEngine(jmodel, params, JaxServingPlugin(**GEOMETRY, **kw),
                            JaxGenerationConfig(max_new_tokens=MAX_NEW), adapters=store)


def _engine(models, store=None, **kw):
    return ServingEngine(models[2], ServingPlugin(**GEOMETRY, **kw),
                         GenerationConfig(max_new_tokens=MAX_NEW), device="cpu", adapters=store)


def _fleets(models, n=2, policy="affinity", **kw):
    kw.setdefault("prefix_cache", "on")
    return (JaxFleetRouter([_jengine(models, **kw) for _ in range(n)], policy=policy),
            FleetRouter([_engine(models, **kw) for _ in range(n)], policy=policy))


def _stores(models, n_tenants=2):
    """A JAX store and a port store with the same seeded f32 adapters."""
    _, params, tmodel = models
    plugin = dict(rank=2, pool_slots=2, kernel="native")
    jstore = JaxAdapterStore(params, JaxLoraPlugin(**plugin), dtype=jnp.float32)
    tstore = AdapterStore(tmodel, LoraPlugin(**plugin), dtype=torch.float32)
    spec = jlora.lora_spec(params)
    for t in range(1, n_tenants + 1):
        tree = jlora.init_adapter_params(jax.random.PRNGKey(1000 + t), spec, 2,
                                         init_b="normal", dtype=jnp.float32)
        jstore.publish(t, tree)
        tstore.publish(t, lora_tree_from_flax(jax.tree.map(np.asarray, tree)))
    return jstore, tstore


def _shared_trace(seed, n, share=0.9, groups=2, pre_len=12, inter=1.0):
    return synthesize_trace(seed, n, vocab_size=256, mean_interarrival_steps=inter,
                            prompt_len_range=(4, 12), new_tokens_range=(4, 8),
                            prefix_share=share, shared_prefixes=groups,
                            shared_prefix_len=pre_len)


def _jax_trace(trace):
    return [JaxRequest(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                       arrival_step=r.arrival_step, adapter_id=r.adapter_id,
                       deadline_ticks=r.deadline_ticks) for r in trace]


def _placements(router):
    """``(replica, uid)`` of every submit on each replica's admitting
    engine, in order."""
    out = []
    for rep in router.replicas:
        eng = rep.backend.prefill_engine if rep.is_pair else rep.backend
        out += [(rep.index, ev[1]) for ev in eng.sched.events if ev[0] == "submit"]
    return out


def _assert_same_fleet(rep, jrep, router, jrouter):
    for key in SAME:
        assert rep[key] == jrep[key], key
    assert rep["per_replica"] == [{k: v for k, v in row.items() if k != "compiles_warmup"}
                                  for row in jrep["per_replica"]]
    assert _placements(router) == _placements(jrouter)


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------


def test_router_rejects_empty_fleet_unknown_policy_and_prewarm(models):
    with pytest.raises(ValueError, match="at least one replica"):
        FleetRouter([])
    with pytest.raises(ValueError, match="routing policy"):
        FleetRouter([_engine(models)], policy="random")
    with pytest.raises(ValueError, match="compile cache"):
        FleetRouter([_engine(models)]).warmup(prewarm_dir="packs")


def test_replica_kill_is_a_registered_fault_kind():
    FaultEvent("replica_kill", at=3)
    assert FaultEvent("replica_kill").site == "fleet_route"
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultEvent("replica_smite", at=3)


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------


def test_engine_fleet_parity_vs_fused_and_jax(models):
    """2 fused engines behind affinity routing: JAX's placements, routed-by
    counts and per-replica rows; tokens equal one fused engine's."""
    trace = _shared_trace(3, 10)
    jrouter, router = _fleets(models)
    jrep = jax_fleet_replay(jrouter, _jax_trace(trace))
    rep = fleet_replay(router, trace)
    _assert_same_fleet(rep, jrep, router, jrouter)
    fused = _engine(models, prefix_cache="on")
    replay(fused, trace)
    assert rep["results"] == fused.results
    assert rep["goodput_frac"] == 1.0 and rep["routed_by_prefix"] > 0
    assert all(row["routed"] > 0 for row in rep["per_replica"])


def test_pair_fleet_parity_all_armed(models):
    """2 disaggregated pairs (prefix cache, adapters and speculation armed,
    one store per role per replica): JAX's placements and results, tokens
    equal one fused speculative engine's with the same adapters, pages
    crossed the wire."""
    jmodel, params, tmodel = models
    trace = synthesize_trace(23, 12, vocab_size=256, mean_interarrival_steps=1.0,
                             prompt_len_range=(4, 12), new_tokens_range=(4, 8), adapters=2,
                             prefix_share=0.6, shared_prefix_len=8)
    knobs = dict(prefix_cache="on", speculate="ngram", speculate_k=2)
    jpairs, pairs = [], []
    for _ in range(2):
        (jd, td), (jp, tp) = _stores(models), _stores(models)
        jpairs.append(JaxDisaggregatedPair(jmodel, params, JaxServingPlugin(**GEOMETRY, **knobs),
                                           JaxGenerationConfig(max_new_tokens=MAX_NEW),
                                           adapters=jd, prefill_adapters=jp))
        pairs.append(DisaggregatedPair(tmodel, ServingPlugin(**GEOMETRY, **knobs),
                                       GenerationConfig(max_new_tokens=MAX_NEW), device="cpu",
                                       adapters=td, prefill_adapters=tp))
    jrouter, router = JaxFleetRouter(jpairs), FleetRouter(pairs)
    jrep = jax_fleet_replay(jrouter, _jax_trace(trace))
    rep = fleet_replay(router, trace)
    _assert_same_fleet(rep, jrep, router, jrouter)
    fused = _engine(models, store=_stores(models)[1], **knobs)
    replay(fused, trace)
    assert rep["results"] == fused.results
    assert rep["goodput_frac"] == 1.0 and rep["page_transfer_bytes"] > 0
    assert rep["adapter_pool_hit_rate"] > 0
    assert all(row["role"] == "pair" for row in rep["per_replica"])


# ---------------------------------------------------------------------------
# affinity
# ---------------------------------------------------------------------------


def test_prefix_affinity_beats_round_robin(models):
    """On a loaded 4-preamble trace affinity routing beats round robin on
    the fleet prefix hit rate and p50 TTFT ticks, each policy's report
    JAX's; both keep the same tokens."""
    trace = _shared_trace(3, 24, share=0.95, groups=4, inter=0.5)
    by_policy = {}
    for policy in ("affinity", "round_robin"):
        jrouter, router = _fleets(models, policy=policy)
        jrep = jax_fleet_replay(jrouter, _jax_trace(trace))
        rep = fleet_replay(router, trace)
        _assert_same_fleet(rep, jrep, router, jrouter)
        by_policy[policy] = rep
    aff, rr = by_policy["affinity"], by_policy["round_robin"]
    assert rr["routed_by_prefix"] == 0 and aff["routed_by_prefix"] > len(trace) // 2
    assert aff["prefix_hit_rate"] > rr["prefix_hit_rate"]
    assert aff["ttft_p50_ticks"] < rr["ttft_p50_ticks"]
    assert aff["results"] == rr["results"]


def test_adapter_affinity_keeps_tenants_home(models):
    trace = synthesize_trace(7, 12, vocab_size=256, mean_interarrival_steps=1.0,
                             prompt_len_range=(4, 12), new_tokens_range=(4, 8), adapters=2)
    stores = [_stores(models) for _ in range(2)]
    jrouter = JaxFleetRouter([_jengine(models, store=j) for j, _ in stores])
    router = FleetRouter([_engine(models, store=t) for _, t in stores])
    jrep = jax_fleet_replay(jrouter, _jax_trace(trace))
    rep = fleet_replay(router, trace)
    _assert_same_fleet(rep, jrep, router, jrouter)
    assert rep["goodput_frac"] == 1.0 and rep["routed_by_adapter"] > 0
    assert rep["adapter_pool_hit_rate"] > 0


# ---------------------------------------------------------------------------
# replica_kill: drain, re-route, respawn
# ---------------------------------------------------------------------------


def test_replica_kill_drain_reroute_bitwise_parity(models):
    """A kill at fleet tick 8 drains the victim, re-routes each pending
    request exactly once (JAX's drain event and placements), and the
    survivors' tokens equal the fault-free fleet's."""
    trace = _shared_trace(5, 12)
    jrep = jax_fleet_chaos_replay(lambda: _fleets(models)[0], _jax_trace(trace),
                                  jfaults.FaultPlan([jfaults.FaultEvent("replica_kill", at=8)]))
    rep = fleet_chaos_replay(lambda: _fleets(models)[1], trace,
                             FaultPlan([FaultEvent("replica_kill", at=8)]))
    for key in ("token_parity", "goodput_frac", "completed", "faults_fired", "drain_events",
                "alive", "routed_by_prefix", "routed_by_load", "results"):
        assert rep[key] == jrep[key], key
    assert rep["token_parity"] is True
    assert rep["completed"] == len(trace) and rep["alive"] == 1
    assert len(rep["drain_events"]) == 1 and rep["drain_events"][0]["survivors"] > 0


def test_drain_counts_offered_traffic_once(models):
    def offered(router):
        return sum(eng.prefix.stats["admission_lookups"] for rep in router.replicas
                   for eng in rep.engines if eng.prefix is not None)

    trace = _shared_trace(5, 12)
    clean = _fleets(models)[1]
    fleet_replay(clean, trace)
    chaos = _fleets(models)[1]
    chaos.warmup()
    with fault_plan(FaultPlan([FaultEvent("replica_kill", at=8)])):
        chaos.run(trace)
    assert len(chaos.drain_events) == 1 and chaos.drain_events[0]["survivors"] > 0
    assert offered(chaos) == offered(clean)
    survivors = [uid for rep in chaos.replicas for ev in rep.backend.sched.events
                 if ev[0] == "submit" for uid in [ev[1]]]
    assert sorted(set(survivors)) == [r.uid for r in trace]
    assert len(survivors) == len(trace) + chaos.drain_events[0]["survivors"]


def test_respawn_restores_fleet_capacity(models):
    trace = _shared_trace(9, 12, inter=0.5)
    router = FleetRouter([_engine(models, prefix_cache="on") for _ in range(2)],
                         respawn=lambda i: _engine(models, prefix_cache="on"))
    rep = fleet_chaos_replay(lambda: router, trace,
                             FaultPlan([FaultEvent("replica_kill", at=6)]),
                             baseline_parity=False)
    assert rep["goodput_frac"] == 1.0
    assert rep["replicas"] == 3 and rep["alive"] == 2
    assert rep["per_replica"][2]["routed"] > 0


def test_single_replica_fleet_ignores_kill(models):
    trace = _shared_trace(11, 6)
    rep = fleet_chaos_replay(lambda: _fleets(models, n=1)[1], trace,
                             FaultPlan([FaultEvent("replica_kill", at=5)]))
    assert rep["goodput_frac"] == 1.0 and rep["drain_events"] == [] and rep["alive"] == 1


# ---------------------------------------------------------------------------
# fleet-wide degradation and twins
# ---------------------------------------------------------------------------


def test_fleet_ladder_escalates_in_lockstep(models):
    router = _fleets(models)[1]
    paged = []
    mon = SLOMonitor({"token_latency_s": {"p50_trip": 0.5}},
                     on_trip=lambda m, q, v: paged.append(m))
    router.attach(mon)
    for _ in range(8):
        mon.observe("token_latency_s", 2.0)
    assert {eng.ladder.stage for rep in router.replicas for eng in rep.engines} == \
        {"despeculate"}
    assert paged == ["token_latency_s"]
    for _ in range(200):
        mon.observe("token_latency_s", 0.001)
    assert {eng.ladder.stage for rep in router.replicas for eng in rep.engines} == {"normal"}


def test_fleet_twins_recorded_and_zeros_clean(models):
    rep = fleet_replay(_fleets(models)[1], _shared_trace(13, 8))
    assert rep["goodput_frac"] == 1.0
    reg = twin_registry()
    good = reg.get("fleet.request_goodput")
    assert good is not None and good.status == "ok"
    assert good.measured == good.predicted == 1.0
    prefix_twin = reg.get("fleet.prefix_hit_rate")
    assert prefix_twin.measured == pytest.approx(rep["prefix_hit_rate"])
    assert prefix_twin.predicted is not None
    idle = fleet_replay(_fleets(models)[1], [])
    assert idle["requests"] == idle["completed"] == 0
    for key in ("goodput_frac", "ttft_p50_ticks", "prefix_hit_rate", "adapter_pool_hit_rate",
                "page_transfer_bytes"):
        assert idle[key] == 0, key
    assert idle["drain_events"] == []
