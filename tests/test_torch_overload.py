"""The port's overload controls held against the JAX package's: the bounded
queue and shedding, per-request deadlines, cancellation at every stage,
the degradation ladder, the SLO monitor and ``chaos_replay`` — one
counterpart per case of ``tests/test_overload.py``.

Both engines serve the same f32 weights (``torch_state_from_flax``) with
``"native"`` attention on the CPU, driven by the same calls: the
scheduler's event log (submit / admit / shed / cancel / ladder / verify /
despeculate ...), results, counters and free stacks must be equal, and the
resource contract (``verify_serving_invariants``) must hold on both.  SLO
quantiles, callbacks and Prometheus text, ``predicted_pool_utilization``
and ``static_batching_report`` are host arithmetic: equal to JAX's.
Every engine shares one geometry (slots 4, pages of 4, pool 24, chunk 8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.generation import GenerationConfig as JaxGenerationConfig
from accelerate_tpu.models import llama as jl
from accelerate_tpu.resilience import faults as jfaults
from accelerate_tpu.serving import Request as JaxRequest
from accelerate_tpu.serving import ServingEngine as JaxServingEngine
from accelerate_tpu.serving import chaos_replay as jax_chaos_replay
from accelerate_tpu.serving import harness as jharness
from accelerate_tpu.serving import synthesize_trace as jax_synthesize_trace
from accelerate_tpu.serving import verify_serving_invariants as jax_invariants
from accelerate_tpu.telemetry import SLOMonitor as JaxSLOMonitor
from accelerate_tpu.telemetry import StreamingQuantile as JaxStreamingQuantile
from accelerate_tpu.telemetry import TwinRegistry as JaxTwinRegistry
from accelerate_tpu.telemetry import prometheus_text as jax_prometheus_text
from accelerate_tpu.utils.dataclasses import ServingPlugin as JaxServingPlugin
from accelerate_tpu_torch import GenerationConfig, LlamaConfig, LlamaForCausalLM, generate
from accelerate_tpu_torch.models.convert import torch_state_from_flax
from accelerate_tpu_torch.resilience import FaultEvent, FaultPlan, fault_plan
from accelerate_tpu_torch.serving import (
    DegradationLadder,
    Request,
    ServingEngine,
    chaos_replay,
    predicted_pool_utilization,
    replay,
    static_batching_report,
    synthesize_trace,
    verify_serving_invariants,
)
from accelerate_tpu_torch.telemetry import (
    SLOMonitor,
    StreamingQuantile,
    TwinRegistry,
    prometheus_text,
    twin_registry,
)
from accelerate_tpu_torch.utils.dataclasses import ServingPlugin

MAX_NEW = 16
GEOMETRY = dict(num_slots=4, page_size=4, pages_per_slot=8, num_pages=24, prefill_chunk=8,
                prefill_buckets=(4, 8), decode_kernel="native")
COUNTERS = ("requests_shed", "deadline_misses", "cancelled", "pages_reclaimed_on_cancel")


@pytest.fixture(scope="module")
def models():
    jmodel = jl.LlamaForCausalLM(jl.LlamaConfig.tiny(dtype=jnp.float32))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tmodel = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device="cpu")
    tmodel.load_state_dict(torch_state_from_flax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


class Both:
    """A JAX engine and a port engine on the same weights and plugin,
    driven by the same calls."""

    def __init__(self, models, **kw):
        jmodel, params, tmodel = models
        plugin = {**GEOMETRY, **kw}
        self.j = JaxServingEngine(jmodel, params, JaxServingPlugin(**plugin),
                                  JaxGenerationConfig(max_new_tokens=MAX_NEW))
        self.t = ServingEngine(tmodel, ServingPlugin(**plugin),
                               GenerationConfig(max_new_tokens=MAX_NEW), device="cpu")

    def add(self, uid, prompt, **kw):
        self.j.add_request(JaxRequest(uid=uid, prompt=prompt, max_new_tokens=MAX_NEW, **kw))
        self.t.add_request(Request(uid=uid, prompt=prompt, max_new_tokens=MAX_NEW, **kw))

    def step(self, n=1):
        for _ in range(n):
            self.j.step()
            self.t.step()

    def cancel(self, uid):
        self.j.cancel(uid)
        self.t.cancel(uid)

    def until(self, cond):
        while not cond(self.t):
            self.step()

    def drain(self):
        self.until(lambda e: e.idle())

    def run(self, trace, plan=None):
        with jfaults.fault_plan(plan[0] if plan else None):
            jres = self.j.run(_jax_trace(trace))
        with fault_plan(plan[1] if plan else None):
            tres = self.t.run(trace)
        return jres, tres

    def assert_same(self):
        j, t = self.j, self.t
        assert t.sched.events == j.sched.events
        assert t.results == j.results
        for name in COUNTERS:
            assert getattr(t.sched, name) == getattr(j.sched, name), name
        assert t.sched.retired_uids == j.sched.retired_uids
        np.testing.assert_array_equal(t.cache["free_stack"].numpy(),
                                      np.asarray(j.cache["free_stack"]))
        assert verify_serving_invariants(t) == []
        assert jax_invariants(j) == []


def _jax_trace(trace):
    return [JaxRequest(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                       arrival_step=r.arrival_step, adapter_id=r.adapter_id,
                       deadline_ticks=r.deadline_ticks) for r in trace]


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [tuple(int(x) for x in rng.integers(1, 255, n)) for n in lengths]


def _solo(models, prompt):
    out = generate(models[2], np.asarray([prompt], np.int32),
                   GenerationConfig(max_new_tokens=MAX_NEW))
    return [int(x) for x in out[0]]


def _plans(events):
    return (jfaults.FaultPlan([jfaults.FaultEvent(**e) for e in events]),
            FaultPlan([FaultEvent(**e) for e in events]))


# ---------------------------------------------------------------------------
# remaining_requests after a drain with a cancel pending
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("processed", [False, True])
def test_remaining_requests_pending_cancel_exactly_once(models, processed):
    """A cancel the drain beats comes back once; a processed one never."""
    b = Both(models)
    for i, p in enumerate(_prompts(0, (6,) * 5)):
        b.add(i, p)
    b.step(4)
    victim = b.t.unfinished_requests()[0].uid
    assert victim == b.j.unfinished_requests()[0].uid
    b.cancel(victim)
    if processed:
        b.step()
        assert victim in b.t.sched.retired_uids
    plans = _plans([dict(kind="preempt", at=1, site="serve_step")])
    with jfaults.fault_plan(plans[0]):
        b.j.step()
    with fault_plan(plans[1]):
        b.t.step()
    assert b.t.interrupted and b.j.interrupted
    remaining = [r.uid for r in b.t.remaining_requests()]
    assert remaining == [r.uid for r in b.j.remaining_requests()]
    assert remaining.count(victim) == (0 if processed else 1)
    assert len(remaining) == len(set(remaining))
    b.assert_same()


# ---------------------------------------------------------------------------
# cancellation at every stage
# ---------------------------------------------------------------------------


def test_cancel_releases_resources_at_every_stage(models):
    """Cancel a queued, a mid-prefill and a decoding request: the events,
    counters and free stack are JAX's after each, and the survivors emit
    their solo tokens."""
    b = Both(models)
    prompts = _prompts(1, (6, 13, 5, 5, 5))
    for i, p in enumerate(prompts):
        b.add(i, p)
    b.step()
    b.cancel(4)  # queued: 4 slots
    b.step()
    b.assert_same()
    b.until(lambda e: any(st.request.uid == 1 and 0 < st.prefilled < 13
                          for st in e.sched.slots.values()))
    before = b.t.sched.pages_reclaimed_on_cancel
    b.cancel(1)
    b.step()
    assert b.t.sched.pages_reclaimed_on_cancel > before
    b.assert_same()
    b.until(lambda e: any(st.request.uid == 0 and st.tokens for st in e.sched.slots.values()))
    b.cancel(0)
    b.step()
    b.assert_same()
    b.drain()
    b.assert_same()
    stages = {ev[1]: ev[2] for ev in b.t.sched.events if ev[0] == "cancel"}
    assert stages == {4: "queued", 1: "prefill", 0: "decode"}
    assert b.t.sched.cancelled == 3
    for uid in (2, 3):
        assert b.t.results[uid] == _solo(models, prompts[uid])


def test_cancel_mid_speculative_verify_rolls_back_exactly(models):
    """A slot cancelled between verify passes releases the KV its passes
    wrote (``kv_len`` past the host stream); the resource contract holds
    after every tick."""
    b = Both(models, speculate="ngram", speculate_k=4)
    prompts = _prompts(2, (6, 7, 8))
    for i, p in enumerate(prompts):
        b.add(i, p)
    b.until(lambda e: e.metrics["verify_steps"] > 0)
    victim = [st.request.uid for st in b.t.sched.slots.values() if st.tokens][0]
    b.cancel(victim)
    b.step()
    assert victim in b.t.sched.retired_uids
    b.assert_same()
    while not b.t.idle():
        b.step()
        assert verify_serving_invariants(b.t) == []
    b.assert_same()
    assert victim not in b.t.results
    for uid in set(range(3)) - {victim}:
        assert b.t.results[uid] == _solo(models, prompts[uid])


# ---------------------------------------------------------------------------
# deadlines and the shed policy
# ---------------------------------------------------------------------------


def test_deadline_retires_queued_and_inflight(models):
    """An expired queued request sheds, an expired in-flight one cancels;
    both count as deadline misses, as JAX counts them."""
    prompts = _prompts(3, (6,) * 6)
    b = Both(models)
    for i in range(4):
        b.add(i, prompts[i])
    b.add(4, prompts[4], deadline_ticks=2)
    b.add(5, prompts[5])
    b.drain()
    b.assert_same()
    assert ("shed", 4, "deadline") in b.t.sched.events
    assert b.t.results[5] == _solo(models, prompts[5])

    b2 = Both(models)
    b2.add(0, prompts[0], deadline_ticks=6)
    b2.add(1, prompts[1])
    b2.drain()
    b2.assert_same()
    cancels = [ev for ev in b2.t.sched.events if ev[0] == "cancel"]
    assert cancels and cancels[0][1] == 0 and cancels[0][3] == "deadline"
    assert b2.t.sched.deadline_misses == 1 and b2.t.sched.pages_reclaimed_on_cancel > 0
    assert b2.t.results[1] == _solo(models, prompts[1])


def test_shed_policy_bounded_queue_and_watermark(models):
    """The queue bound sheds the newcomer (or the oldest past its
    deadline); the KV-pressure watermark sheds queued demand — each shed
    JAX's, never an admitted request."""
    prompts = _prompts(4, (6,) * 8)
    b = Both(models, max_queue=2)
    for i in range(4):
        b.add(i, prompts[i])
        if i % 2:
            b.step()
    for i in range(4, 8):
        b.add(i, prompts[i], arrival_step=i)
    assert [(ev[1], ev[2]) for ev in b.t.sched.events if ev[0] == "shed"] == \
        [(6, "queue"), (7, "queue")]
    b.drain()
    b.assert_same()
    for uid in range(6):
        assert b.t.results[uid] == _solo(models, prompts[uid])

    b2 = Both(models, max_queue=1)
    b2.j.sched.tick = b2.t.sched.tick = 100
    b2.add(20, prompts[4], deadline_ticks=1)
    b2.add(21, prompts[5])
    assert [ev[1] for ev in b2.t.sched.events if ev[0] == "shed"] == [20]
    assert b2.t.sched.events == b2.j.sched.events

    b3 = Both(models, kv_shed_watermark=0.5)
    for i in range(8):
        b3.add(30 + i, prompts[i])
    assert b3.t.sched.predicted_kv_pressure() == b3.j.sched.predicted_kv_pressure()
    b3.step()
    assert any(ev[0] == "shed" and ev[2] == "kv_pressure" for ev in b3.t.sched.events)
    b3.drain()
    b3.assert_same()


# ---------------------------------------------------------------------------
# determinism under fault plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fault_seed", [0, 3])
def test_scheduler_determinism_extends_to_chaos_events(models, fault_seed):
    """A cancellation storm and a deadline storm over a trace with
    deadlines: the event log (cancel / shed / ladder entries included) and
    the results are JAX's."""
    trace = synthesize_trace(7, 8, vocab_size=255, prompt_len_range=(3, 10),
                             new_tokens_range=(2, 6), deadline_range=(4, 40))
    b = Both(models)
    b.run(trace, _plans([dict(kind="cancel", at=4 + fault_seed),
                         dict(kind="deadline", at=9 + fault_seed)]))
    b.assert_same()
    kinds = {ev[0] for ev in b.t.sched.events}
    assert "cancel" in kinds and "ladder" in kinds


# ---------------------------------------------------------------------------
# chaos replay
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("knobs", [{}, dict(max_queue=3, default_deadline_ticks=60)])
def test_chaos_replay_surviving_tokens_bitwise(models, knobs):
    """Cancel and deadline storms and serve-step preempts through
    drain-and-restart: the survivors and their tokens are JAX's soak's,
    bitwise equal to a fault-free replay of the survivors, with the
    invariants checked after every tick of every engine life."""
    jmodel, params, tmodel = models
    trace = synthesize_trace(11, 10, vocab_size=255, prompt_len_range=(3, 10),
                             new_tokens_range=(2, 8))
    probs = dict(p_cancel=0.08, p_deadline=0.04, p_preempt=0.05, serving=True)
    plugin = {**GEOMETRY, **knobs}
    jrep = jax_chaos_replay(
        lambda: JaxServingEngine(jmodel, params, JaxServingPlugin(**plugin),
                                 JaxGenerationConfig(max_new_tokens=MAX_NEW)),
        _jax_trace(trace), jfaults.FaultPlan.from_seed(5, 40, **probs))
    ticks = []

    def factory():
        # every tick of every life checks the resource contract
        engine = ServingEngine(tmodel, ServingPlugin(**plugin),
                               GenerationConfig(max_new_tokens=MAX_NEW), device="cpu")
        step = engine.step

        def checked_step():
            event = step()
            ticks.append(engine.steps)
            assert verify_serving_invariants(engine) == []
            return event

        engine.step = checked_step
        return engine

    rep = chaos_replay(factory, trace, FaultPlan.from_seed(5, 40, **probs))
    assert rep["token_parity"] and rep["invariant_problems"] == [] and ticks
    assert rep["results"] == jrep["results"]
    for key in ("completed", "restarts", "faults_fired", *COUNTERS):
        assert rep[key] == jrep[key], key
    assert rep["completed"] + rep["requests_shed"] + rep["cancelled"] \
        + rep["deadline_misses"] >= rep["requests"]


def test_preempt_mid_verify_drains_clean_and_resumes(models):
    """A preempt at ``verify_step`` drains before the pass, as JAX's; a
    fresh engine serving the rest reproduces the uninterrupted tokens."""
    trace = synthesize_trace(13, 6, vocab_size=255, prompt_len_range=(4, 10),
                             new_tokens_range=(4, 10))
    spec = dict(speculate="ngram", speculate_k=4)
    full = Both(models, **spec).t.run(trace)
    b = Both(models, **spec)
    b.run(trace, _plans([dict(kind="preempt", at=3, site="verify_step")]))
    assert b.t.interrupted and b.j.interrupted
    b.assert_same()
    remaining = b.t.remaining_requests()
    assert [r.uid for r in remaining] == [r.uid for r in b.j.remaining_requests()]
    resumed = Both(models, **spec).t.run([
        Request(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens)
        for r in remaining])
    assert {**b.t.results, **resumed} == full


# ---------------------------------------------------------------------------
# the degradation ladder and the SLO monitor
# ---------------------------------------------------------------------------


def test_ladder_full_escalation_and_round_trip(models):
    """All four stages mid-traffic (escalated at tick 5 on both engines):
    despeculate stops verify passes, prefill chunks clamp to the smallest
    bucket, admission tightens, shed arms — events and tokens JAX's; then
    relaxing restores every knob."""
    b = Both(models, speculate="ngram", speculate_k=4)
    prompts = _prompts(6, (9, 10, 11, 9, 10, 9))
    for i, p in enumerate(prompts):
        b.add(i, p)
    while not b.t.idle():
        if b.t.steps == 5:
            for _ in range(4):
                b.j.ladder.escalate()
                b.t.ladder.escalate()
        b.step()
    b.assert_same()
    assert b.t.ladder.stage == "shed" and b.t.ladder.report() == b.j.ladder.report()
    assert b.t.sched.prefill_chunk == 4
    assert b.t.sched.admission_reserve_pages == b.j.sched.admission_reserve_pages > 0
    assert b.t.sched.shed_armed and b.t.despeculated
    verify_at = [i for i, ev in enumerate(b.t.sched.events) if ev[0] == "verify"]
    ladder_at = b.t.sched.events.index(("ladder", "despeculate"))
    assert verify_at and max(verify_at) < ladder_at  # no verify pass after
    for uid, p in enumerate(prompts):
        if uid in b.t.results:
            assert b.t.results[uid] == _solo(models, p)
    for _ in range(4):
        b.t.ladder.relax()
    assert b.t.ladder.stage == "normal" and not b.t.despeculated
    assert b.t.sched.prefill_chunk == GEOMETRY["prefill_chunk"]
    assert b.t.sched.admission_reserve_pages == 0 and not b.t.sched.shed_armed
    assert [ev for ev in b.t.sched.events if ev[0] == "ladder"][-4:] == [
        ("ladder", s) for s in ("tighten_admission", "shrink_prefill", "despeculate",
                                "normal")]
    assert DegradationLadder.STAGES == type(b.j.ladder).STAGES


def test_slo_monitor_drives_ladder(models):
    """A trip escalates one stage, a recovery relaxes it, the monitor's own
    callback keeps firing — on both engines alike."""
    b = Both(models)
    paged = {"j": [], "t": []}
    jmon = JaxSLOMonitor({"token_latency_s": {"p50_trip": 0.5}},
                         on_trip=lambda m, q, v: paged["j"].append(m))
    tmon = SLOMonitor({"token_latency_s": {"p50_trip": 0.5}},
                      on_trip=lambda m, q, v: paged["t"].append(m))
    assert b.t.attach_slo(tmon) is b.t.ladder
    b.j.attach_slo(jmon)
    for mon in (jmon, tmon):
        for _ in range(8):
            mon.observe("token_latency_s", 2.0)
    assert b.t.ladder.stage == b.j.ladder.stage == "despeculate"
    assert tmon.trip_count == jmon.trip_count == 1
    assert paged["t"] == paged["j"] == ["token_latency_s"]
    for mon in (jmon, tmon):
        for _ in range(200):
            mon.observe("token_latency_s", 0.001)
    assert b.t.ladder.stage == "normal"
    assert b.t.sched.events == b.j.sched.events == [("ladder", "despeculate"),
                                                    ("ladder", "normal")]


@pytest.mark.parametrize("q", [0.5, 0.9, 0.99])
def test_streaming_quantile_and_monitor_equal_jax(q):
    """P² estimates, SLO statuses, warn / trip / recover transitions and
    the Prometheus text on the same seeded stream are JAX's, value for
    value."""
    rng = np.random.default_rng(int(q * 100))
    stream = np.concatenate([rng.lognormal(-3, 0.5, 300), rng.lognormal(-1, 0.3, 200),
                             rng.lognormal(-4, 0.2, 500)])
    est, jest = StreamingQuantile(q), JaxStreamingQuantile(q)
    for x in stream:
        est.observe(x)
        jest.observe(x)
        assert est.value() == jest.value()
    with pytest.raises(ValueError):
        StreamingQuantile(1.0)
    log = {"j": [], "t": []}
    thr = {"token_latency_s": {"p50_warn": 0.1, "p99_trip": 0.5}, "goodput_frac": {"p50_trip": 0.9}}

    def cb(side, kind):
        return lambda m, qq, v: log[side].append((kind, m, qq, v))

    mons = {side: cls(thr, on_warn=cb(side, "warn"), on_trip=cb(side, "trip"),
                      on_recover=cb(side, "recover"))
            for side, cls in (("j", JaxSLOMonitor), ("t", SLOMonitor))}
    for mon in mons.values():
        mon.observe_many("token_latency_s", stream)
        mon.observe_many("goodput_frac", [1.0, 0.5, 0.4, 0.95, 0.99, 1.0, 1.0])
        mon.observe("ttft_s", 0.2)
    assert log["t"] == log["j"] and log["t"]
    assert mons["t"].report() == mons["j"].report()
    assert mons["t"].flat_metrics() == mons["j"].flat_metrics()
    assert prometheus_text(TwinRegistry(), {"serve": mons["t"]}, {"x": 1}) == \
        jax_prometheus_text(JaxTwinRegistry(), {"serve": mons["j"]}, {"x": 1})
    assert mons["t"].status("idle_metric").status == "idle"


# ---------------------------------------------------------------------------
# the invariant checker, the report, the knobs
# ---------------------------------------------------------------------------


def test_verify_invariants_detects_planted_violations(models):
    b = Both(models)
    b.add(0, (5, 9, 3))
    b.drain()
    assert verify_serving_invariants(b.t) == []
    b.t.sched.free_pages -= 1
    problems = verify_serving_invariants(b.t)
    assert any("mirror" in p for p in problems) and any("conservation" in p for p in problems)
    b.t.sched.free_pages += 1
    b.t.sched.free_slots.pop()
    assert any("slot accounting" in p for p in verify_serving_invariants(b.t))


def test_replay_emits_overload_fields_and_clean_twins(models):
    """A clean replay: the overload block is zeros and goodput 1.0, the
    ``serving.*`` twins are ok, the KV-pool utilization and its prediction
    are JAX's."""
    jmodel, params, tmodel = models
    trace = synthesize_trace(17, 6, vocab_size=255, prompt_len_range=(3, 8),
                             new_tokens_range=(2, 6))
    jrep = jharness.replay(JaxServingEngine(jmodel, params, JaxServingPlugin(**GEOMETRY),
                                            JaxGenerationConfig(max_new_tokens=MAX_NEW)),
                           _jax_trace(trace))
    mon = SLOMonitor()
    eng = ServingEngine(tmodel, ServingPlugin(**GEOMETRY),
                        GenerationConfig(max_new_tokens=MAX_NEW), device="cpu")
    rep = replay(eng, trace, slo_monitor=mon, verify_invariants=True)
    for field in ("requests_shed", "deadline_misses", "cancelled", "pages_reclaimed_on_cancel",
                  "request_goodput_frac", "transfer_retries", "ladder_stage",
                  "ladder_engagements", "kv_pool_utilization_predicted",
                  "scheduled_token_efficiency"):
        got = round(rep[field], 4) if isinstance(rep[field], float) else rep[field]
        assert got == jrep[field], field
    assert rep["request_goodput_frac"] == 1.0 and rep["ladder_stage"] == "normal"
    assert round(rep["kv_pool_utilization"], 4) == jrep["kv_pool_utilization"]
    assert mon.status("token_latency_s").n == len(eng.token_gaps_s) > 0
    assert mon.status("ttft_s").n == len(trace)
    reg = twin_registry()
    for name in ("serving.requests_shed", "serving.deadline_misses", "serving.cancelled",
                 "serving.pages_reclaimed_on_cancel", "serving.request_goodput_frac"):
        twin = reg.get(name)
        assert twin is not None and twin.status == "ok", (name, twin)


def test_adapter_transfer_retry_surfaced_in_the_report(models, tmp_path):
    """An injected staging failure mid-swap is absorbed by the bounded
    retry and counted into the report's ``transfer_retries``."""
    from accelerate_tpu_torch.serving import AdapterStore
    from accelerate_tpu_torch.utils.dataclasses import LoraPlugin

    tmodel = models[2]
    store = AdapterStore(tmodel, LoraPlugin(rank=2, pool_slots=2, kernel="native"),
                         dtype=torch.float32, offload_dir=str(tmp_path))
    store.publish_random(4, torch.Generator().manual_seed(104))
    eng = ServingEngine(tmodel, ServingPlugin(**GEOMETRY),
                        GenerationConfig(max_new_tokens=MAX_NEW), device="cpu", adapters=store)
    trace = [Request(uid=0, prompt=(7, 11, 13), max_new_tokens=3, adapter_id=4),
             Request(uid=1, prompt=(5, 3), max_new_tokens=3)]
    with fault_plan(FaultPlan([FaultEvent("transfer", at=1, site="adapter_transfer")])):
        rep = replay(eng, trace, verify_invariants=True)
    assert rep["transfer_retries"] >= 1 and rep["completed"] == 2


@pytest.mark.parametrize("seed", [0, 5])
def test_trace_deadlines_pool_prediction_and_static_batching_equal_jax(seed):
    kw = dict(vocab_size=255, prompt_len_range=(3, 20), new_tokens_range=(2, 12),
              deadline_range=(4, 40))
    trace = synthesize_trace(seed, 12, **kw)
    jtrace = jax_synthesize_trace(seed, 12, **kw)
    assert [(r.uid, r.prompt, r.max_new_tokens, r.arrival_step, r.deadline_ticks)
            for r in trace] == [(r.uid, r.prompt, r.max_new_tokens, r.arrival_step,
                                 r.deadline_ticks) for r in jtrace]
    geom = dict(num_slots=4, num_pages=24, page_size=4, pages_per_slot=8, prefill_chunk=8)
    assert predicted_pool_utilization(trace, **geom) == \
        jharness.predicted_pool_utilization(jtrace, **geom)
    assert predicted_pool_utilization([], **geom) == 0.0
    pairs = [(r.prompt_len, r.max_new_tokens) for r in trace]
    assert static_batching_report(pairs, 4) == jharness.static_batching_report(pairs, 4)
    assert static_batching_report([], 4) == jharness.static_batching_report([], 4)


def test_serving_plugin_overload_knobs(monkeypatch):
    monkeypatch.setenv("ACCELERATE_SERVE_MAX_QUEUE", "7")
    monkeypatch.setenv("ACCELERATE_SERVE_KV_WATERMARK", "0.8")
    monkeypatch.setenv("ACCELERATE_SERVE_DEADLINE", "64")
    p = ServingPlugin()
    assert (p.max_queue, p.kv_shed_watermark, p.default_deadline_ticks) == (7, 0.8, 64)
    assert ServingPlugin(max_queue=3).max_queue == 3
    for bad in (dict(max_queue=-1), dict(kv_shed_watermark=1.5),
                dict(default_deadline_ticks=-2), dict(ladder_reserve_frac=0.0)):
        with pytest.raises(ValueError):
            ServingPlugin(**bad)


def test_default_deadline_stamped_on_submit(models):
    b = Both(models, default_deadline_ticks=5)
    b.add(0, (4, 4))
    b.add(1, (4, 4), deadline_ticks=9)
    assert [r.deadline_ticks for r in b.t.sched.waiting] == \
        [r.deadline_ticks for r in b.j.sched.waiting] == [5, 9]
    with pytest.raises(ValueError, match="deadline_ticks"):
        b.t.add_request(Request(uid=2, prompt=(4, 4), max_new_tokens=2, deadline_ticks=-1))


def test_overload_spans_equal_jax(models):
    """Tracing under a storm with a queue bound and deadlines: the
    ``shed`` / ``cancel`` / ``ladder`` instants and every other span are
    the JAX engine's, event for event, on a virtual clock."""
    from accelerate_tpu.telemetry import VirtualClock as JaxVirtualClock
    from accelerate_tpu_torch.telemetry import VirtualClock

    trace = synthesize_trace(7, 10, vocab_size=255, prompt_len_range=(3, 12),
                             new_tokens_range=(2, 8), mean_interarrival_steps=0.5,
                             deadline_range=(6, 30))
    b = Both(models, max_queue=3)
    jtr = b.j.enable_tracing(clock=JaxVirtualClock(1.0))
    ttr = b.t.enable_tracing(clock=VirtualClock(1.0))
    b.j.warmup()
    b.t.warmup()
    b.run(trace, _plans([dict(kind="cancel", at=5), dict(kind="deadline", at=12)]))
    b.assert_same()
    assert ttr.recorder.events() == jtr.recorder.events()
    names = {e[1] for e in ttr.recorder.events()}
    assert {"shed", "cancel", "ladder"} <= names
