"""The port's disaggregated prefill -> decode slice held against the JAX
package's: the wire schema (``analysis/distributed_audit.py``), the KV
page transport and ``DisaggregatedPair`` (``serving/transfer.py``).

Schemas are host arithmetic: equal dicts, dtypes named as JAX names them,
the same mismatches refused.  Both pairs serve the same f32 weights
(``torch_state_from_flax``) with ``"native"`` attention on the CPU: each
transfer's payload of live pages equals the first pages of JAX's whole-row
payload, and the port's whole-row send equals JAX's (int8 / e4m3 codes
bitwise; f32 pages and the
f32 scales, each page's amax of the K / V each framework computed, to 1e-6
of the payload's largest |value|), the pair's tokens equal the fused
engine's and JAX's pair's, and the page bytes equal ``transfer_accounting``
exactly.  Every
engine shares one geometry (slots 4, pages of 4, pool 24, chunk 8).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.analysis import distributed_audit as jaudit
from accelerate_tpu.generation import GenerationConfig as JaxGenerationConfig
from accelerate_tpu.models import llama as jl
from accelerate_tpu.serving import DisaggregatedPair as JaxDisaggregatedPair
from accelerate_tpu.serving import Request as JaxRequest
from accelerate_tpu.serving import transfer_accounting as jax_transfer_accounting
from accelerate_tpu.utils.dataclasses import ServingPlugin as JaxServingPlugin
from accelerate_tpu_torch import GenerationConfig, LlamaConfig, LlamaForCausalLM
from accelerate_tpu_torch.analysis import check_wire_schemas, pair_preflight, wire_schema
from accelerate_tpu_torch.models.convert import torch_state_from_flax
from accelerate_tpu_torch.serving import (
    DisaggregatedPair,
    PagedKVTransport,
    Request,
    ServingEngine,
    page_bytes,
    synthesize_trace,
    transfer_accounting,
    verify_serving_invariants,
)
from accelerate_tpu_torch.telemetry import twin_registry
from accelerate_tpu_torch.utils.dataclasses import ServingPlugin

MAX_NEW = 16
GEOMETRY = dict(num_slots=4, page_size=4, pages_per_slot=8, num_pages=24, prefill_chunk=8,
                prefill_buckets=(4, 8), decode_kernel="native")


@pytest.fixture(scope="module")
def models():
    jmodel = jl.LlamaForCausalLM(jl.LlamaConfig.tiny(dtype=jnp.float32))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tmodel = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device="cpu")
    tmodel.load_state_dict(torch_state_from_flax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


def _trace(seed, n, new=(3, 8)):
    return synthesize_trace(seed, n, vocab_size=256, mean_interarrival_steps=1.0,
                            prompt_len_range=(4, 12), new_tokens_range=new,
                            prefix_share=0.85, shared_prefix_len=9)


def _jax_trace(trace):
    return [JaxRequest(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                       arrival_step=r.arrival_step, adapter_id=r.adapter_id,
                       deadline_ticks=r.deadline_ticks) for r in trace]


def _gc():
    return GenerationConfig(max_new_tokens=MAX_NEW)


def _fused(models, trace, **kw):
    eng = ServingEngine(models[2], ServingPlugin(**GEOMETRY, **kw), _gc(), device="cpu")
    return eng.run(trace)


# ---------------------------------------------------------------------------
# the wire schema
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["", "int8", "fp8"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_wire_schema_equals_jax(kv_dtype, dtype):
    jcfg = jl.LlamaConfig.tiny(dtype=getattr(jnp, dtype))
    tcfg = LlamaConfig.tiny(dtype=getattr(torch, dtype))
    plugin = dict(GEOMETRY, kv_dtype=kv_dtype, prefix_cache="on")
    got = wire_schema(tcfg, ServingPlugin(**plugin))
    assert got == jaudit.wire_schema(jcfg, JaxServingPlugin(**plugin))
    assert got["page_dtype"] == {"": dtype, "int8": "int8", "fp8": "float8_e4m3fn"}[kv_dtype]
    assert got["page_bytes"] == page_bytes(tcfg, 4, 2 if dtype == "bfloat16" else 4, kv_dtype)


@pytest.mark.parametrize("change", [dict(page_size=8), dict(kv_dtype="int8"),
                                   dict(prefix_cache="on"), dict(pages_per_slot=6)])
def test_check_wire_schemas_refuses_what_jax_refuses(change):
    jcfg, tcfg = jl.LlamaConfig.tiny(dtype=jnp.float32), LlamaConfig.tiny(dtype=torch.float32)
    src, dst = dict(GEOMETRY), dict(GEOMETRY, **change)
    with pytest.raises(ValueError) as want:
        jaudit.check_wire_schemas(jaudit.wire_schema(jcfg, JaxServingPlugin(**src)),
                                  jaudit.wire_schema(jcfg, JaxServingPlugin(**dst)))
    with pytest.raises(ValueError) as got:
        check_wire_schemas(wire_schema(tcfg, ServingPlugin(**src)),
                           wire_schema(tcfg, ServingPlugin(**dst)))
    assert str(got.value) == str(want.value)
    findings, summary = pair_preflight(tcfg, ServingPlugin(**src), ServingPlugin(**dst))
    assert [f.rule for f in findings] == ["GL403"] and not summary["schema_ok"]
    assert summary["not_run"] == ["GL401", "GL402", "GL404"]
    findings, summary = pair_preflight(tcfg, ServingPlugin(**src), ServingPlugin(**src))
    assert findings == [] and summary["schema_ok"]
    assert twin_registry().get("distributed.wire_bytes_per_page").predicted == \
        summary["roles"]["prefill"]["page_bytes"]


def test_transfer_accounting_equals_jax():
    jcfg, tcfg = jl.LlamaConfig.tiny(dtype=jnp.float32), LlamaConfig.tiny(dtype=torch.float32)
    trace = _trace(15, 8)
    for kv in ("", "int8"):
        assert transfer_accounting(tcfg, trace, 4, dtype_bytes=4, kv_dtype=kv) == \
            jax_transfer_accounting(jcfg, _jax_trace(trace), 4, dtype_bytes=4, kv_dtype=kv)


# ---------------------------------------------------------------------------
# the transport's payload and the pair
# ---------------------------------------------------------------------------


def _captured_pairs(models, trace, **plugin):
    """Both pairs over ``trace`` with every send's payload kept, in order."""
    jmodel, params, tmodel = models
    jpair = JaxDisaggregatedPair(jmodel, params, JaxServingPlugin(**GEOMETRY, **plugin),
                                 JaxGenerationConfig(max_new_tokens=MAX_NEW))
    pair = DisaggregatedPair(tmodel, ServingPlugin(**GEOMETRY, **plugin), _gc(), device="cpu")
    jsent, sent = [], []
    jsend, send = jpair.transport._send, pair.transport.send
    jpair.transport._send = lambda c, s: jsent.append(jsend(c, s)) or jsent[-1]
    # each transfer's live-page payload, beside the whole row it came from
    pair.transport.send = lambda s, n=None: sent.append((send(s, n), send(s))) or sent[-1][0]
    jpair.warmup()
    pair.warmup()
    jsent.clear()
    sent.clear()
    return jpair, jpair.run(_jax_trace(trace)), pair, pair.run(trace), jsent, sent


@pytest.mark.parametrize("kv_dtype", ["", "int8", "fp8"])
def test_send_payload_equals_jax(models, kv_dtype):
    trace = _trace(15, 6)
    jpair, jres, pair, res, jsent, sent = _captured_pairs(models, trace, kv_dtype=kv_dtype)
    assert res == jres and len(sent) == len(jsent) == pair.transport.transfers > 0
    for (live, row), want in zip(sent, jsent):
        assert set(live) == set(row) == set(want)
        n = live["k"].shape[2]
        assert 0 < n < row["k"].shape[2]
        for key, t in [*row.items(), *live.items()]:
            w = np.asarray(want[key])[:, :, :t.shape[2]]
            assert tuple(t.shape) == w.shape
            if key in ("k", "v") and kv_dtype:
                np.testing.assert_array_equal(t.view(torch.uint8).numpy(), w.view(np.uint8))
            else:
                # f32 pages and scales (each page's running amax) come from
                # the K / V each framework's f32 projection computed: equal
                # to 1e-6 of the payload's largest |value|
                assert np.abs(t.numpy() - w).max() <= 1e-6 * np.abs(w).max()


@pytest.mark.parametrize("plugin", [{}, dict(prefix_cache="on"), dict(kv_dtype="int8"),
                                    dict(speculate="ngram", speculate_k=2)])
def test_pair_tokens_equal_fused_and_jax_and_bytes_equal_the_accounting(models, plugin):
    """The pair's tokens are the fused engine's and JAX's pair's; its page
    bytes equal ``transfer_accounting`` (the twin's rel_err is 0); the
    decode scheduler's events (``page_transfer`` included) are JAX's; the
    resource contract holds on both engines."""
    trace = _trace(15, 8)
    jpair, jres, pair, res, _, _ = _captured_pairs(models, trace, **plugin)
    assert res == jres == _fused(models, trace, **{k: v for k, v in plugin.items()
                                                   if k != "prefix_cache"})
    rep = pair.report()
    assert rep == {k: v for k, v in jpair.report().items() if not k.startswith("compiles")}
    acc = transfer_accounting(models[2].config, trace, 4, dtype_bytes=4,
                              kv_dtype=plugin.get("kv_dtype", ""))
    assert rep["page_transfer_bytes"] == acc["page_transfer_bytes"] > 0
    assert twin_registry().get("transfer.page_bytes").rel_err == 0.0
    for eng, jeng in ((pair.prefill_engine, jpair.prefill_engine),
                      (pair.decode_engine, jpair.decode_engine)):
        assert eng.sched.events == jeng.sched.events
        assert verify_serving_invariants(eng) == []
    assert pair.decode_engine.metrics["page_transfer_bytes"] == rep["page_transfer_bytes"]
    assert pair.remaining_requests() == [] and not pair.busy()
    if plugin.get("prefix_cache"):
        assert pair.prefill_engine.prefix.stats["prefill_tokens_skipped"] > 0


def test_recv_writes_only_the_live_pages(models):
    """``recv`` of 2 pages into an empty pool pops exactly 2, writes only
    them (every other page untouched) and sets the slot's length."""
    tmodel = models[2]
    src = ServingEngine(tmodel, ServingPlugin(**GEOMETRY), _gc(), device="cpu",
                        hold_finished=True)
    dst = ServingEngine(tmodel, ServingPlugin(**GEOMETRY), _gc(), device="cpu")
    t = PagedKVTransport(src, dst)
    payload = t.send(0)
    payload = {k: torch.full_like(v, 7.0) for k, v in payload.items()}
    t.recv(1, payload, 2, 7)
    row = dst.cache["block_tables"][1, :2].tolist()
    assert int(dst.cache["free_top"]) == GEOMETRY["num_pages"] - 2
    assert int(dst.cache["seq_lens"][1]) == 7
    k = dst.cache["layers"][0]["k_pages"]
    written = torch.zeros(k.shape[1], dtype=torch.bool)
    written[row] = True
    assert (k[:, written] == 7).all() and (k[:, ~written] == 0).all()
    with pytest.raises(ValueError, match="page geometry"):
        PagedKVTransport(src, ServingEngine(tmodel, ServingPlugin(**{**GEOMETRY,
                                                                     "page_size": 8}),
                                            _gc(), device="cpu"))


def test_pair_needs_both_adapter_stores_or_neither(models):
    with pytest.raises(ValueError, match="BOTH role stores"):
        DisaggregatedPair(models[2], ServingPlugin(**GEOMETRY), _gc(), device="cpu",
                          adapters=object())


def test_pair_immune_to_default_deadline(models):
    """A plugin's ``default_deadline_ticks`` is disarmed on both roles: no
    held prefill is cancelled and every request completes."""
    trace = _trace(15, 6)
    pair = DisaggregatedPair(models[2], ServingPlugin(**GEOMETRY, default_deadline_ticks=2),
                             _gc(), device="cpu")
    pair.warmup()
    out = pair.run(trace)
    assert set(out) == {r.uid for r in trace}
    assert out == _fused(models, trace)


def test_held_finished_slot_never_evicted_or_cancelled(models):
    """A prefill-role engine's parked slots survive page pressure, the
    deadline sweep and cancels, exactly as JAX's: the same events, and the
    resource contract after release."""
    jmodel, params, tmodel = models
    rng = np.random.default_rng(23)
    prompts = [tuple(int(x) for x in rng.integers(1, 255, 21)) for _ in range(3)]
    late = tuple(int(x) for x in rng.integers(1, 255, 28))
    from accelerate_tpu.serving import ServingEngine as JaxServingEngine

    jeng = JaxServingEngine(jmodel, params, JaxServingPlugin(**GEOMETRY),
                            JaxGenerationConfig(max_new_tokens=MAX_NEW), hold_finished=True)
    eng = ServingEngine(tmodel, ServingPlugin(**GEOMETRY), _gc(), device="cpu",
                        hold_finished=True)
    for e, R in ((jeng, JaxRequest), (eng, Request)):
        e.warmup()
        for uid, p in enumerate(prompts):
            e.add_request(R(uid=uid, prompt=p, max_new_tokens=1, deadline_ticks=20))
        while len(e.held) < 3:
            e.step()
        e.add_request(R(uid=9, prompt=late, max_new_tokens=1))
        for s in list(e.held):
            e.cancel(e.sched.slots[s].request.uid)
        for _ in range(50):  # past tick 20: the deadline sweep meets the held slots
            if e.steps > 25 and (9 in e.sched.retired_uids or 9 in e.results):
                break
            e.step()
    held_uids = {eng.sched.slots[s].request.uid for s in eng.held}
    assert held_uids == {0, 1, 2} and eng.held == jeng.held
    assert eng.sched.events == jeng.sched.events
    assert all(ev[1] not in held_uids for ev in eng.sched.events if ev[0] == "evict")
    assert verify_serving_invariants(eng) == []
    for s in list(eng.held):
        eng.release_held(s)
    assert not eng.held and 9 not in eng.sched.slots
    assert verify_serving_invariants(eng) == []


def test_pair_drives_step_by_step_and_hands_back_the_rest(models):
    """``submit`` / ``tick`` / ``busy`` run the same loop as ``run``; a
    pair drained mid-traffic hands back every unfinished original once."""
    trace = _trace(19, 6)
    pair = DisaggregatedPair(models[2], ServingPlugin(**GEOMETRY), _gc(), device="cpu")
    pair.warmup()
    for r in trace:
        pair.submit(r)
    for _ in range(12):
        pair.tick()
    left = pair.remaining_requests()
    assert {r.uid for r in left} | set(pair.results) == {r.uid for r in trace}
    assert len({r.uid for r in left}) == len(left) and pair.busy()
    while pair.tick():
        pass
    assert pair.results == _fused(models, [dataclasses.replace(r) for r in trace])


def test_pair_spans_equal_jax(models):
    """The decode engine of a traced pair records a ``page_transfer``
    instant per handoff, the JAX pair's events, on a virtual clock."""
    from accelerate_tpu.telemetry import VirtualClock as JaxVirtualClock
    from accelerate_tpu_torch.telemetry import VirtualClock

    jmodel, params, tmodel = models
    trace = _trace(15, 5)
    jpair = JaxDisaggregatedPair(jmodel, params, JaxServingPlugin(**GEOMETRY),
                                 JaxGenerationConfig(max_new_tokens=MAX_NEW))
    pair = DisaggregatedPair(tmodel, ServingPlugin(**GEOMETRY), _gc(), device="cpu")
    jtr = jpair.decode_engine.enable_tracing(clock=JaxVirtualClock(1.0))
    ttr = pair.decode_engine.enable_tracing(clock=VirtualClock(1.0))
    jpair.warmup()
    pair.warmup()
    assert pair.run(trace) == jpair.run(_jax_trace(trace))
    assert ttr.recorder.events() == jtr.recorder.events()
    assert sum(e[1] == "page_transfer" for e in ttr.recorder.events()) == len(trace)
