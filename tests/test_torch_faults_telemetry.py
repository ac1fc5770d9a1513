"""The port's fault plans (``accelerate_tpu_torch/resilience/faults.py``),
twin registry and trace spans (``accelerate_tpu_torch/telemetry/``) and
logger held against the JAX package's, and the serving engine's fault sites
and tracing hooks against the JAX engine's.

Plans, fired events, twin rows and span events are host logic: they must be
equal.  The engines serve the same f32 weights (``torch_state_from_flax``);
the JAX engine runs its ``"native"`` attention on the CPU.
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.generation import GenerationConfig as JaxGenerationConfig
from accelerate_tpu.models import llama as jl
from accelerate_tpu.resilience import faults as jfaults
from accelerate_tpu.serving import ServingEngine as JaxServingEngine
from accelerate_tpu.serving import synthesize_trace as jax_synthesize_trace
from accelerate_tpu.telemetry import RequestTracer as JaxRequestTracer
from accelerate_tpu.telemetry import STANDARD_TWINS as JAX_STANDARD_TWINS
from accelerate_tpu.telemetry import SpanRecorder as JaxSpanRecorder
from accelerate_tpu.telemetry import TwinRegistry as JaxTwinRegistry
from accelerate_tpu.telemetry import VirtualClock as JaxVirtualClock
from accelerate_tpu.telemetry import validate_chrome_trace as jax_validate
from accelerate_tpu.utils.dataclasses import ServingPlugin as JaxServingPlugin
from accelerate_tpu_torch import (
    GenerationConfig,
    LlamaConfig,
    LlamaForCausalLM,
    ServingEngine,
    ServingPlugin,
    replay,
    synthesize_trace,
)
from accelerate_tpu_torch.logging import get_logger
from accelerate_tpu_torch.models.convert import torch_state_from_flax
from accelerate_tpu_torch.resilience import (
    FaultEvent,
    FaultPlan,
    InjectedTransferError,
    TransientIOError,
    active_fault_plan,
    fault_plan,
    fault_point,
    maybe_fail_transfer,
    with_retries,
)
from accelerate_tpu_torch.resilience.retry import RetryPolicy
from accelerate_tpu_torch.serving import verify_serving_invariants
from accelerate_tpu_torch.utils.dataclasses import TelemetryPlugin
from accelerate_tpu_torch.telemetry import (
    STANDARD_TWINS,
    RequestTracer,
    SpanRecorder,
    TwinRegistry,
    VirtualClock,
    validate_chrome_trace,
)

GEOMETRY = dict(num_slots=4, page_size=4, pages_per_slot=16, num_pages=40, prefill_chunk=16)
TRACE = dict(vocab_size=255, mean_interarrival_steps=0.5, prompt_len_range=(4, 24),
             new_tokens_range=(4, 24))


@pytest.fixture(scope="module")
def models():
    jmodel = jl.LlamaForCausalLM(jl.LlamaConfig.tiny(dtype=jnp.float32))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tmodel = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device="cpu")
    tmodel.load_state_dict(torch_state_from_flax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


# ---------------------------------------------------------------------------
# fault plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
@pytest.mark.parametrize("probs, serving", [
    (dict(p_preempt=0.1, p_nan=0.2, p_transfer=0.3, p_corrupt=0.1), False),
    (dict(p_preempt=0.2, p_transfer=0.2, p_cancel=0.2, p_deadline=0.1), True),
    (dict(p_nan=0.5, p_corrupt=0.5), False),
])
def test_from_seed_equals_jax(seed, probs, serving):
    got = FaultPlan.from_seed(seed, 40, serving=serving, **probs)
    want = jfaults.FaultPlan.from_seed(seed, 40, serving=serving, **probs)
    assert got.to_spec() == want.to_spec()
    assert json.dumps(got.to_spec()) == json.dumps(want.to_spec())
    assert repr(got).replace("accelerate_tpu_torch", "") == \
        repr(want).replace("accelerate_tpu", "")


def test_from_spec_from_env_and_fire_equal_jax(monkeypatch):
    spec = {"seed": 3, "events": [
        {"kind": "preempt", "at": 4, "site": "serve_step"},
        {"kind": "transfer", "at": 2, "count": 2},
        {"kind": "prefix", "at": 3},
        {"kind": "corrupt_ckpt", "at": 1, "mode": "bitflip"},
        {"kind": "preempt", "at": 2, "site": "verify_step"}]}
    got, want = FaultPlan.from_spec(spec), jfaults.FaultPlan.from_spec(spec)
    assert got.to_spec() == want.to_spec()
    sites = ["serve_step", "transfer", "verify_step", "serve_step", "transfer", "transfer",
             "serve_step", "serve_step", "post_save", "verify_step", "transfer"]
    for site in sites:
        assert [e.kind for e in got.fire(site)] == [e.kind for e in want.fire(site)]
        assert got.occurrences(site) == want.occurrences(site)
    assert [(s, o, e.kind, e.at) for s, o, e in got.fired] == \
        [(s, o, e.kind, e.at) for s, o, e in want.fired]
    monkeypatch.setenv("ACCELERATE_FAULT_PLAN", json.dumps(spec))
    assert FaultPlan.from_env().to_spec() == jfaults.FaultPlan.from_env().to_spec()
    monkeypatch.delenv("ACCELERATE_FAULT_PLAN")
    assert FaultPlan.from_env() is None
    for bad in (dict(kind="meteor"), dict(kind="preempt", at=0),
                dict(kind="corrupt_ckpt", mode="shred")):
        with pytest.raises(ValueError):
            FaultEvent(**bad)
        with pytest.raises(ValueError):
            jfaults.FaultEvent(**bad)
    assert FaultEvent("prefix").site == jfaults.FaultEvent("prefix").site == "serve_step"


def test_fault_points_and_injected_transfers_take_the_retry_path():
    assert fault_point("serve_step") == () and active_fault_plan() is None
    plan = FaultPlan([FaultEvent("transfer", at=1, count=2, site="adapter_transfer")])
    retries = []

    def attempt():
        maybe_fail_transfer("adapter_transfer")
        return "staged"

    with fault_plan(plan):
        assert active_fault_plan() is plan
        out = with_retries(attempt, policy=RetryPolicy(retries=3, backoff_s=0.0),
                           site="t", on_retry=lambda *a: retries.append(a))
    assert active_fault_plan() is None
    assert out == "staged" and len(retries) == 2
    assert issubclass(InjectedTransferError, TransientIOError)
    with fault_plan(FaultPlan([FaultEvent("transfer", at=1, site="x")])):
        with pytest.raises(InjectedTransferError, match="occurrence 1"):
            maybe_fail_transfer("x")


def test_logger_contract(monkeypatch, caplog):
    log = get_logger("accelerate_tpu_torch.test", log_level="INFO")
    with caplog.at_level(logging.INFO, logger="accelerate_tpu_torch.test"):
        log.info("once %d", 1, main_process_only=True)
        log.warning_once("twice")
        log.warning_once("twice")
        log.info("ordered", in_order=True)
    assert [r.getMessage() for r in caplog.records] == ["once 1", "twice", "ordered"]
    monkeypatch.setenv("ACCELERATE_LOG_LEVEL", "40")
    log.warning("dropped")
    assert not log.isEnabledFor(logging.WARNING)


# ---------------------------------------------------------------------------
# twins and spans
# ---------------------------------------------------------------------------


def _record_script(reg):
    reg.declare_standard_twins()
    reg.record("speculate.accept_rate", predicted=0.5, measured=0.45, source="a")
    reg.record("speculate.tokens_per_step", predicted=1.5, measured=2.4)
    reg.record("prefix_cache.hit_rate", predicted=0.3, measured=0.0)
    reg.record_measured("compiles.steady_state", 1)
    reg.record_predicted("compiles.steady_state", 0)
    reg.record("custom.thing", predicted=2.0, measured=3.0, units="x", tolerance=0.1)
    reg.register("custom.thing", units="ignored", tolerance=0.9)
    return (reg.drift_report(), reg.flat_metrics(),
            [t.name for t in reg.drifting("warn")], [t.name for t in reg.drifting("error")],
            reg.names())


def test_twin_rows_equal_jax():
    assert STANDARD_TWINS == JAX_STANDARD_TWINS
    assert _record_script(TwinRegistry()) == _record_script(JaxTwinRegistry())
    reg = TwinRegistry()
    reg.record("speculate.accept_rate", measured=0.5)
    assert reg.get("speculate.accept_rate").status == "idle"
    reg.reset()
    assert reg.names() == []


def _span_script(recorder_cls, clock_cls):
    rec = recorder_cls(capacity=6, clock=clock_cls(1.0))
    t = rec.stamp()
    rec.complete("a", "engine", t, cat="step", k=1)
    rec.instant("b", "req 3", cat="request", reason="x")
    with rec.span("c", "engine"):
        rec.instant("d", "engine")
    for i in range(5):
        rec.instant("e", f"req {i}")
    return rec.events(), rec.dropped, rec.recorded, rec.to_chrome_trace()


def test_span_recorder_equals_jax_and_its_traces_validate(tmp_path):
    got = _span_script(SpanRecorder, VirtualClock)
    want = _span_script(JaxSpanRecorder, JaxVirtualClock)
    assert got == want
    assert got[1] > 0 and len(got[0]) == 6
    assert validate_chrome_trace(got[3]) == []
    bad = [{"traceEvents": [{"ph": "Q", "name": "", "pid": 0, "tid": 0, "ts": -1}]},
           {"nope": 1}, {"traceEvents": {}},
           {"traceEvents": [{"ph": "X", "name": "n", "pid": 0, "tid": 0, "ts": 1}]}]
    for trace in bad:
        assert validate_chrome_trace(trace) == jax_validate(trace) != []
    rec = SpanRecorder(clock=VirtualClock(1.0))
    rec.instant("x", "t", value=1)
    rec.write_chrome_trace(tmp_path / "t.json")
    rec.write_jsonl(tmp_path / "t.jsonl")
    assert validate_chrome_trace(json.loads((tmp_path / "t.json").read_text())) == []
    assert json.loads((tmp_path / "t.jsonl").read_text())["args"] == {"value": 1}
    off = SpanRecorder(enabled=False)
    off.instant("x", "t")
    assert len(off) == 0 and off.stamp() == 0.0


def test_request_tracer_over_the_same_event_log_equals_jax(models):
    """One scheduler event log (speculation and the prefix cache on, so
    verify / prefix_hit / cow_fork / evict events appear) fed to both
    tracers at the same ticks: the recorded span events are equal."""
    jmodel, params, _ = models
    kw = dict(TRACE, prefix_share=0.8, shared_prefix_len=9, prompt_len_range=(4, 12),
              new_tokens_range=(4, 10))
    jeng = JaxServingEngine(jmodel, params,
                            JaxServingPlugin(**{**GEOMETRY, "pages_per_slot": 8, "num_pages": 14},
                                             decode_kernel="native", speculate="ngram",
                                             prefix_cache="on"),
                            JaxGenerationConfig(max_new_tokens=16))
    jeng.run(jax_synthesize_trace(5, 10, **kw))
    events = jeng.sched.events
    kinds = {ev[0] for ev in events}
    assert {"verify", "prefix_hit", "evict", "finish"} <= kinds
    got, want = RequestTracer(clock=VirtualClock(1.0)), JaxRequestTracer(clock=JaxVirtualClock(1.0))
    for cut in range(0, len(events) + 7, 7):
        for tr in (got, want):
            tr.phase("schedule", tr.stamp(), step=cut)
            tr.consume_scheduler_events(events[:cut], cut, window=(cut, cut + 0.5))
    assert got.recorder.events() == want.recorder.events()
    assert validate_chrome_trace(got.to_chrome_trace()) == []


# ---------------------------------------------------------------------------
# the engine's tracing hooks and fault sites
# ---------------------------------------------------------------------------


def test_engine_arms_tracing_from_the_telemetry_plugin(models, monkeypatch):
    """``TelemetryPlugin.trace_requests`` (and its environment variable)
    arms the engine's request spans at construction with the plugin's ring
    size, as JAX's engine does; an explicit plugin wins over the
    environment."""
    from accelerate_tpu.utils.dataclasses import TelemetryPlugin as JaxTelemetryPlugin

    jmodel, params, tmodel = models
    monkeypatch.setenv("ACCELERATE_TELEMETRY_TRACE_REQUESTS", "1")
    monkeypatch.setenv("ACCELERATE_TELEMETRY_RING", "64")
    engines = []
    for telemetry, jtelemetry in ((None, None), (TelemetryPlugin(trace_requests=False),
                                                 JaxTelemetryPlugin(trace_requests=False))):
        jeng = JaxServingEngine(jmodel, params, JaxServingPlugin(**GEOMETRY,
                                                                 decode_kernel="native"),
                                JaxGenerationConfig(max_new_tokens=8), telemetry=jtelemetry)
        teng = ServingEngine(tmodel, ServingPlugin(**GEOMETRY), GenerationConfig(max_new_tokens=8),
                             device="cpu", telemetry=telemetry)
        engines.append((teng, jeng))
    (armed, jarmed), (off, joff) = engines
    assert armed.trace is not None and jarmed.trace is not None
    assert armed.trace.recorder.capacity == jarmed.trace.recorder.capacity == 64
    assert off.trace is None and joff.trace is None
    assert armed.enable_tracing() is armed.trace
    trace = synthesize_trace(2, 4, **TRACE)
    assert armed.run(trace) == off.run(synthesize_trace(2, 4, **TRACE))
    assert armed.trace.recorder.events()


@pytest.mark.parametrize("spec", [{}, dict(speculate="ngram", prefix_cache="on")])
def test_engine_trace_equals_jax_and_changes_no_token(models, spec):
    """The same trace through both engines with a virtual clock: the port's
    spans (phases, dispatch / host-sync windows, lifecycle) are the JAX
    engine's, span for span, and tracing changes no token."""
    jmodel, params, tmodel = models
    jeng = JaxServingEngine(jmodel, params, JaxServingPlugin(**GEOMETRY, decode_kernel="native",
                                                             **spec),
                            JaxGenerationConfig(max_new_tokens=32))
    jtr = jeng.enable_tracing(clock=JaxVirtualClock(1.0))
    jres = jeng.run(jax_synthesize_trace(3, 8, **TRACE))
    plain = ServingEngine(tmodel, ServingPlugin(**GEOMETRY, **spec),
                          GenerationConfig(max_new_tokens=32), device="cpu")
    plain_rep = replay(plain, synthesize_trace(3, 8, **TRACE))
    teng = ServingEngine(tmodel, ServingPlugin(**GEOMETRY, **spec),
                         GenerationConfig(max_new_tokens=32), device="cpu")
    ttr = teng.enable_tracing(clock=VirtualClock(1.0))
    assert teng.enable_tracing() is ttr
    teng.warmup()
    tres = teng.run(synthesize_trace(3, 8, **TRACE))
    assert tres == jres == dict(plain.results)
    assert ttr.recorder.events() == jtr.recorder.events()
    chrome = ttr.to_chrome_trace()
    assert validate_chrome_trace(chrome) == []
    names = {e["name"] for e in chrome["traceEvents"]}
    want = {"submit", "queued", "admit", "prefill_chunk", "decode", "retire", "schedule",
            "host_sync"}
    want |= {"dispatch:verify", "verify"} if spec else {"dispatch:decode"}
    assert want <= names
    assert plain_rep["trace_spans"] == 0 and plain_rep["telemetry_overhead_frac"] == 0.0
    teng.disable_tracing()
    assert teng.trace is None


@pytest.mark.parametrize("site, at", [("serve_step", 9), ("verify_step", 4)])
def test_preempt_fault_drains_and_a_fresh_engine_resumes(models, site, at):
    """A ``preempt`` at the tick boundary or before a verify pass: the
    engine drains at the same step as JAX's, hands back the same unfinished
    requests, the resource contract holds, and a fresh engine serving them
    reproduces the uninterrupted tokens."""
    jmodel, params, tmodel = models
    spec = dict(speculate="ngram", prefix_cache="on")
    plan = [FaultEvent("preempt", at=at, site=site)]
    jplan = [jfaults.FaultEvent("preempt", at=at, site=site)]
    with jfaults.fault_plan(jfaults.FaultPlan(jplan)):
        jeng = JaxServingEngine(jmodel, params,
                                JaxServingPlugin(**GEOMETRY, decode_kernel="native", **spec),
                                JaxGenerationConfig(max_new_tokens=32))
        jeng.run(jax_synthesize_trace(3, 8, **TRACE))
    trace = synthesize_trace(3, 8, **TRACE)
    with fault_plan(FaultPlan(plan)):
        eng = ServingEngine(tmodel, ServingPlugin(**GEOMETRY, **spec),
                            GenerationConfig(max_new_tokens=32), device="cpu")
        eng.run(trace)
    assert eng.interrupted and jeng.interrupted and eng.steps == jeng.steps
    assert eng.sched.events == jeng.sched.events
    assert [r.uid for r in eng.remaining_requests()] == \
        [r.uid for r in jeng.remaining_requests()]
    assert verify_serving_invariants(eng) == []
    full = ServingEngine(tmodel, ServingPlugin(**GEOMETRY, **spec),
                         GenerationConfig(max_new_tokens=32), device="cpu")
    want = full.run(trace)
    fresh = ServingEngine(tmodel, ServingPlugin(**GEOMETRY, **spec),
                          GenerationConfig(max_new_tokens=32), device="cpu")
    resumed = fresh.run([r for r in eng.remaining_requests()])
    assert {**eng.results, **resumed} == want


def test_prefix_flush_fault_keeps_tokens_and_matches_jax(models):
    """Cache-invalidation storms mid-traffic: every index hold drops, live
    slots keep theirs; tokens are the fault-free serve's, the
    ``prefix_flush`` events and the free stack JAX's."""
    jmodel, params, tmodel = models
    kw = dict(TRACE, prefix_share=0.9, shared_prefix_len=9, prompt_len_range=(4, 12))
    events = [(6, "prefix"), (18, "prefix"), (30, "prefix")]
    with jfaults.fault_plan(jfaults.FaultPlan([jfaults.FaultEvent(k, at=a)
                                               for a, k in events])):
        jeng = JaxServingEngine(jmodel, params,
                                JaxServingPlugin(**GEOMETRY, decode_kernel="native",
                                                 prefix_cache="on"),
                                JaxGenerationConfig(max_new_tokens=16))
        jres = jeng.run(jax_synthesize_trace(7, 12, **kw))
    with fault_plan(FaultPlan([FaultEvent(k, at=a) for a, k in events])):
        eng = ServingEngine(tmodel, ServingPlugin(**GEOMETRY, prefix_cache="on",
                                                  decode_kernel="native"),
                            GenerationConfig(max_new_tokens=16), device="cpu")
        res = eng.run(synthesize_trace(7, 12, **kw))
    clean = ServingEngine(tmodel, ServingPlugin(**GEOMETRY, decode_kernel="native"),
                          GenerationConfig(max_new_tokens=16), device="cpu")
    assert res == jres == clean.run(synthesize_trace(7, 12, **kw))
    assert eng.sched.events == jeng.sched.events
    assert sum(ev[0] == "prefix_flush" for ev in eng.sched.events) == 3
    np.testing.assert_array_equal(eng.cache["free_stack"].numpy(),
                                  np.asarray(jeng.cache["free_stack"]))
    assert verify_serving_invariants(eng) == []


@pytest.mark.parametrize("kind", ["cancel", "deadline"])
def test_overload_faults_raise_naming_a11d(models, kind):
    """The ``cancel`` / ``deadline`` faults, once refused, fire at
    ``serve_step``: the cancellation storm retires the oldest live request,
    the deadline storm expires every live one and escalates the ladder —
    the events, results and free stack are the JAX engine's under the same
    plan, and the resource contract holds."""
    jmodel, params, tmodel = models
    with jfaults.fault_plan(jfaults.FaultPlan([jfaults.FaultEvent(kind, at=6)])):
        jeng = JaxServingEngine(jmodel, params,
                                JaxServingPlugin(**GEOMETRY, decode_kernel="native"),
                                JaxGenerationConfig(max_new_tokens=16))
        jres = jeng.run(jax_synthesize_trace(0, 6, **TRACE))
    plan = FaultPlan([FaultEvent(kind, at=6)])
    with fault_plan(plan):
        eng = ServingEngine(tmodel, ServingPlugin(**GEOMETRY, decode_kernel="native"),
                            GenerationConfig(max_new_tokens=16), device="cpu")
        res = eng.run(synthesize_trace(0, 6, **TRACE))
    assert plan.fired and res == jres
    assert eng.sched.events == jeng.sched.events
    assert any(ev[0] == "cancel" and ev[3] == kind for ev in eng.sched.events)
    assert eng.ladder.stage == jeng.ladder.stage == ("normal" if kind == "cancel"
                                                     else "despeculate")
    np.testing.assert_array_equal(eng.cache["free_stack"].numpy(),
                                  np.asarray(jeng.cache["free_stack"]))
    assert verify_serving_invariants(eng) == []
