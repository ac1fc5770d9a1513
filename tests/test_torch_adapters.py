"""The port's multi-tenant adapter path (``serving/adapters.py``, the
scheduler's adapter admission, ``ServingEngine(adapters=)``,
``generate_paged(adapters=, adapter_ids=)``, the replay fields) held against
the JAX package's.

Host logic is held exactly: the same publish / prefetch / pin / unpin
sequence gives the same slots, evictions, hits, swaps and ``swap_bytes``;
the same trace gives the same scheduler events (``swap``, ``bypass``
included) and greedy tokens.  Both sides serve the same f32 weights (the JAX
tree carried across by ``torch_state_from_flax``) and JAX's own bf16
adapters (carried across by ``lora_tree_from_flax``), so a token flips only
if a float differs by enough to move an argmax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.generation import GenerationConfig as JaxGenerationConfig
from accelerate_tpu.generation import generate_paged as jax_generate_paged
from accelerate_tpu.models import llama as jl
from accelerate_tpu.ops import lora as jlora
from accelerate_tpu.serving import AdapterPoolFullError as JaxPoolFull
from accelerate_tpu.serving import AdapterStore as JaxAdapterStore
from accelerate_tpu.serving import ContinuousBatchingScheduler as JaxScheduler
from accelerate_tpu.serving import Request as JaxRequest
from accelerate_tpu.serving import ServingEngine as JaxServingEngine
from accelerate_tpu.serving import adapter_pool_accounting as jax_pool_accounting
from accelerate_tpu.serving import predicted_adapter_hit_rate as jax_predicted
from accelerate_tpu.serving import synthesize_trace as jax_synthesize_trace
from accelerate_tpu.serving.harness import _adapter_fields as jax_adapter_fields
from accelerate_tpu.utils.dataclasses import LoraPlugin as JaxLoraPlugin
from accelerate_tpu.utils.dataclasses import ServingPlugin as JaxServingPlugin
from accelerate_tpu_torch import (
    GenerationConfig,
    LlamaConfig,
    LlamaForCausalLM,
    LoraPlugin,
    Request,
    ServingEngine,
    ServingPlugin,
    generate_paged,
    replay,
    synthesize_trace,
)
from accelerate_tpu_torch.models.convert import flax_module_to_port_name, lora_tree_from_flax
from accelerate_tpu_torch.models.convert import torch_state_from_flax
from accelerate_tpu_torch.ops import lora as tlora
from accelerate_tpu_torch.serving import (
    AdapterPoolFullError,
    AdapterStore,
    ContinuousBatchingScheduler,
    LoraTrainer,
    adapter_pool_accounting,
    predicted_adapter_hit_rate,
)
from accelerate_tpu_torch.serving.harness import _adapter_fields

# the JAX LoRA tests' geometry (tests/test_lora.py): an undersized pool and
# a page pool tight enough for evictions
TIGHT = dict(num_slots=4, page_size=2, pages_per_slot=10, num_pages=14, prefill_chunk=8)
GEOMETRY = dict(num_slots=4, page_size=4, pages_per_slot=8, num_pages=24, prefill_chunk=8)
TRACE = dict(vocab_size=255, prompt_len_range=(3, 9), new_tokens_range=(3, 6), adapters=3)


@pytest.fixture(scope="module")
def models():
    jmodel = jl.LlamaForCausalLM(jl.LlamaConfig.tiny(dtype=jnp.float32))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tmodel = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device="cpu")
    tmodel.load_state_dict(torch_state_from_flax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


def _adapters(params, tenants):
    """JAX's own bf16 adapters (``publish_random``'s draw), by tenant."""
    spec = jlora.lora_spec(params)
    return {t: jlora.init_adapter_params(jax.random.PRNGKey(100 + t), spec, 4,
                                         init_b="normal") for t in tenants}


def _stores(models, tenants=(1, 2, 3), offload=None, **plugin):
    """A JAX store and a port store over the same model, the same bf16
    adapters published to both."""
    _, params, tmodel = models
    plugin = {"rank": 4, "pool_slots": 2, "kernel": "native", **plugin}
    jstore = JaxAdapterStore(params, JaxLoraPlugin(**plugin),
                             offload_dir=None if offload is None else str(offload / "jax"))
    tstore = AdapterStore(tmodel, LoraPlugin(**plugin),
                          offload_dir=None if offload is None else str(offload / "port"))
    for t, tree in _adapters(params, tenants).items():
        jstore.publish(t, tree)
        tstore.publish(t, lora_tree_from_flax(jax.tree.map(np.asarray, tree)))
    return jstore, tstore


def _pool_equal(jstore, tstore):
    jpool = lora_tree_from_flax(jax.tree.map(np.asarray, jstore.pool))
    assert set(jpool) == set(tstore.pool)
    for name, fac in tstore.pool.items():
        for f in ("a", "b"):
            assert torch.equal(fac[f], jpool[name][f]), (name, f)


def _counters(store):
    return (dict(store.slot_of), dict(store.tid_of), list(store.free_slots),
            dict(store.refcount), store.hits, store.swaps, store.swap_bytes,
            store.stats.fetches, store.stats.prefetch_hits, store.pool_report())


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("offload", [False, True])
def test_adapter_store_matches_jax(models, tmp_path, offload):
    """tests/test_lora.py:162's sequence on both stores, from host memory and
    from the disk tier: the same slots, swaps, hits, refcounts, LRU victims
    and swap bytes; the same pool contents (slot 0 zeros throughout);
    ``AdapterPoolFullError`` on both; a re-publish of a resident tenant
    refreshes its slot in place on both."""
    jstore, tstore = _stores(models, offload=tmp_path if offload else None)
    assert tstore.spec == {flax_module_to_port_name(k): v for k, v in jstore.spec.items()}
    _pool_equal(jstore, tstore)

    def both(fn):
        return fn(jstore), fn(tstore)

    for step in (lambda s: s.pin(1), lambda s: s.pin(2), lambda s: s.can_pin(3)):
        j, t = both(step)
        assert j == t
    assert _counters(jstore) == _counters(tstore)
    with pytest.raises(JaxPoolFull):
        jstore.pin(3)
    with pytest.raises(AdapterPoolFullError):
        tstore.pin(3)
    _pool_equal(jstore, tstore)
    for step in (lambda s: s.unpin(1), lambda s: s.pin(3), lambda s: s.resident(1),
                 lambda s: s.pin(2), lambda s: s.unpin(2), lambda s: s._evictable(),
                 lambda s: s.unpin(2), lambda s: s.unpin(3), lambda s: s._evictable(),
                 lambda s: s.slot(2), lambda s: s.slot(0), lambda s: s.hit_rate()):
        j, t = both(step)
        assert j == t
        assert _counters(jstore) == _counters(tstore)
    _pool_equal(jstore, tstore)
    assert tstore.swap_bytes == 3 * sum(v.numel() * v.element_size()
                                        for fac in tstore._host_tree(2).values()
                                        for v in fac.values())
    fresh = jlora.init_adapter_params(jax.random.PRNGKey(99), jstore.spec, 4, init_b="normal")
    jstore.publish(2, fresh)
    tstore.publish(2, lora_tree_from_flax(jax.tree.map(np.asarray, fresh)))
    _pool_equal(jstore, tstore)
    assert _counters(jstore) == _counters(tstore)
    with pytest.raises(KeyError):
        tstore.pin(9)
    with pytest.raises(ValueError, match="null adapter"):
        tstore.publish(0, {})
    with pytest.raises(ValueError, match="does not match"):
        tstore.publish(4, {"model.layers.0.self_attn.q_proj": {"a": torch.zeros(1)}})


def test_prefetch_before_pin_matches_jax(models):
    """tests/test_lora.py:225: prefetch stages early, the later pin is a
    prefetch hit, resident tenants never re-stage — the same answers and
    stats on both; ``warmup_insert`` keeps slot 0 zeros."""
    jstore, tstore = _stores(models, tenants=(1, 2))
    for step in (lambda s: s.prefetch(1), lambda s: s.prefetch(1), lambda s: s.prefetch(0),
                 lambda s: s.prefetch(7), lambda s: s.pin(1), lambda s: s.prefetch(1),
                 lambda s: s.prefetch(2), lambda s: s.pin(2), lambda s: s.warmup_insert()):
        assert step(jstore) == step(tstore)
        assert _counters(jstore) == _counters(tstore)
    assert tstore.stats.prefetch_hits == 2
    _pool_equal(jstore, tstore)


def test_predicted_hit_rate_and_pool_accounting_match_jax(models):
    for ids in ([], [0, 0], [1, 2, 1, 3, 2], [1, 2, 1, 2, 1], [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]):
        for pool in (1, 2, 4):
            assert predicted_adapter_hit_rate(ids, pool) == jax_predicted(ids, pool)
    jstore, tstore = _stores(models)
    for kw in (dict(rank=4, pool_slots=8, decode_step_s=0.005), dict(rank=16, pool_slots=4)):
        want = jax_pool_accounting(jstore.spec, **kw)
        got = adapter_pool_accounting(tstore.spec, **kw)
        assert set(got.pop("hbm_frac")) == {"h100_80GB"}
        want.pop("hbm_frac")
        assert got == want
    assert adapter_pool_accounting(tstore.spec, rank=4, pool_slots=8)["hbm_frac"][
        "h100_80GB"] == round(adapter_pool_accounting(tstore.spec, rank=4, pool_slots=8)[
            "pool_bytes"] / (80 * 2**30), 8)
    # LoraTrainer trains (held to JAX's in tests/test_torch_lora_trainer.py):
    # a base-row + tenant step moves the tenant's adapter, on a fresh model
    # (the trainer freezes its base)
    trainer = LoraTrainer(LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device="cpu"),
                          LoraPlugin(rank=4, pool_slots=2))
    trainer.add_adapter(1)
    before = [t.clone() for t in trainer._flat(trainer.adapters[1])]
    toks = torch.from_numpy(np.random.default_rng(0).integers(1, 255, (2, 8)))
    loss = trainer.step({"input_ids": toks, "labels": toks}, [1, 0])
    assert np.isfinite(loss)
    assert any(not torch.equal(a, b) for a, b in zip(before, trainer._flat(trainer.adapters[1])))


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------


def _bypass_events(sched_cls, request_cls, store, max_bypass_age):
    """tests/test_lora.py:343's trace: tenant 1 holds the one pool slot, the
    head of the line needs tenant 2, zero-swap arrivals queue behind it."""
    sched = sched_cls(num_slots=2, num_pages=64, page_size=4, pages_per_slot=8,
                      prefill_chunk=8, prefill_buckets=(8,), adapters=store,
                      max_bypass_age=max_bypass_age)
    sched.submit(request_cls(uid=0, prompt=(1, 2), max_new_tokens=2, adapter_id=1))
    admitted = [sched.admit()]
    sched.submit(request_cls(uid=1, prompt=(1, 2), max_new_tokens=2, adapter_id=2))
    for uid in (2, 3, 4):
        sched.submit(request_cls(uid=uid, prompt=(1, 2), max_new_tokens=2))
    for _ in range(4):
        new = sched.admit()
        admitted.append(new)
        for s in new:
            if sched.slots[s].request.adapter_id == 0:
                sched.slots[s].prefilled = 2
                sched.slots[s].tokens = [0, 0]
                sched.finish(s)
    sched.slots[0].prefilled = 2
    sched.slots[0].tokens = [0, 0]
    sched.finish(0)
    admitted.append(sched.admit())
    return sched.events, admitted, [st.adapter_slot for st in sched.slots.values()]


@pytest.mark.parametrize("age", [2, 0])
def test_bounded_age_bypass_matches_jax(models, age):
    """Bounded-age bypass (and strict FIFO at age 0): the same events,
    admissions and adapter slots as the JAX scheduler."""
    jstore, tstore = _stores(models, tenants=(1, 2), pool_slots=1, max_bypass_age=age)
    want = _bypass_events(JaxScheduler, JaxRequest, jstore, age)
    got = _bypass_events(ContinuousBatchingScheduler, Request, tstore, age)
    assert got == want
    bypasses = [e for e in got[0] if e[0] == "bypass"]
    assert bypasses == ([("bypass", 2, 1), ("bypass", 3, 1)] if age else [])
    assert ("swap", 2, 1) in got[0]
    assert _counters(jstore) == _counters(tstore)


def test_submit_checks_match_jax(models):
    _, tstore = _stores(models, tenants=(1,))
    eng = ServingEngine(models[2], ServingPlugin(**GEOMETRY), device="cpu", adapters=tstore)
    with pytest.raises(ValueError, match="never published"):
        eng.add_request(Request(uid=0, prompt=(3, 4), max_new_tokens=2, adapter_id=9))
    plain = ServingEngine(models[2], ServingPlugin(**GEOMETRY), device="cpu")
    with pytest.raises(ValueError, match="no AdapterStore"):
        plain.add_request(Request(uid=0, prompt=(3, 4), max_new_tokens=2, adapter_id=1))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _serve_both(models, jkernel, tkernel, geometry, trace_kw, decode_kernel="native",
                max_new=6):
    jmodel, params, tmodel = models
    jstore, _ = _stores(models, kernel=jkernel)
    _, tstore = _stores(models, kernel=tkernel)
    jeng = JaxServingEngine(jmodel, params, JaxServingPlugin(**geometry,
                                                             decode_kernel=decode_kernel),
                            JaxGenerationConfig(max_new_tokens=max_new), adapters=jstore)
    jeng.warmup()
    jtrace = jax_synthesize_trace(**trace_kw)
    jres = jeng.run(jtrace)
    teng = ServingEngine(tmodel, ServingPlugin(**geometry, decode_kernel=decode_kernel),
                         GenerationConfig(max_new_tokens=max_new), device="cpu", adapters=tstore)
    trace = synthesize_trace(**trace_kw)
    rep = replay(teng, trace)
    return jeng, jres, jtrace, teng, teng.results, trace, rep


@pytest.mark.parametrize("jkernel, tkernel, decode_kernel", [
    ("native", "native", "native"), ("bgmv", "auto", "native"), ("native", "native", "flash")])
def test_engine_with_adapters_matches_jax_engine(models, jkernel, tkernel, decode_kernel):
    """A 7-request, 3-tenant trace on a pool of 2 with a tight page pool:
    the same greedy tokens, scheduler events (swaps and evictions), step
    metrics and pool counters as the JAX engine — both on the native LoRA
    route, and the port's ``auto`` (bgmv at T = 1) against JAX's
    ``kernel="bgmv"`` (its Pallas kernel in interpret mode); the replay's
    adapter fields equal JAX's."""
    jeng, jres, jtrace, teng, tres, trace, rep = _serve_both(
        models, jkernel, tkernel, TIGHT, dict(seed=3, n_requests=7, **TRACE),
        decode_kernel=decode_kernel)
    assert tres == jres and len(tres) == 7
    assert teng.sched.events == jeng.sched.events
    for key in ("decode_steps", "prefill_steps", "idle_steps", "evictions", "generated_tokens",
                "page_step_sum"):
        assert teng.metrics[key] == jeng.metrics[key], key
    assert teng.metrics["evictions"] > 0 and teng.adapters.swaps > 0
    assert any(e[0] == "swap" for e in teng.sched.events)
    assert _counters(teng.adapters) == _counters(jeng.adapters)
    assert teng.free_page_mirror_in_sync()
    assert {k: rep[k] for k in _adapter_fields(teng, trace)} == jax_adapter_fields(jeng, jtrace)
    assert rep["adapter_swap_bytes"] == rep["adapter_swaps"] * sum(
        v.numel() * v.element_size() for fac in teng.adapters._host_tree(1).values()
        for v in fac.values())
    assert tlora.bgmv.launches == 0


def test_engine_bypass_trace_matches_jax(models):
    """A trace whose head of line waits on a pool of one: the engine's
    admission (prefetches, the head-block age, bypasses) gives JAX's events
    and tokens."""
    kw = dict(seed=11, n_requests=8, mean_interarrival_steps=0.5, **TRACE)
    jmodel, params, tmodel = models
    jstore, tstore = _stores(models, pool_slots=1, max_bypass_age=1)
    jeng = JaxServingEngine(jmodel, params, JaxServingPlugin(**GEOMETRY, decode_kernel="native"),
                            JaxGenerationConfig(max_new_tokens=6), adapters=jstore)
    jres = jeng.run(jax_synthesize_trace(**kw))
    teng = ServingEngine(tmodel, ServingPlugin(**GEOMETRY, decode_kernel="native"),
                         GenerationConfig(max_new_tokens=6), device="cpu", adapters=tstore)
    tres = teng.run(synthesize_trace(**kw))
    assert tres == jres
    assert teng.sched.events == jeng.sched.events
    assert any(e[0] == "bypass" for e in teng.sched.events)
    assert _counters(tstore) == _counters(jstore)


def test_generate_paged_with_adapters_matches_jax(models):
    """``generate_paged(adapters=, adapter_ids=)``: JAX's array, EOS padding
    included, rows through tenants 0..3 on a pool of 2."""
    jmodel, params, tmodel = models
    jstore, tstore = _stores(models)
    batch = np.asarray([[5, 42, 7, 9, 1, 3], [11, 3, 0, 0, 0, 0], [9, 8, 7, 6, 5, 0],
                        [4, 4, 4, 0, 0, 0]], np.int32)
    lens = np.asarray([6, 2, 5, 3], np.int32)
    tenants = [1, 0, 3, 1]
    want = jax_generate_paged(jmodel, params, jnp.asarray(batch),
                              JaxGenerationConfig(max_new_tokens=6, eos_token_id=2),
                              prompt_lengths=jnp.asarray(lens), adapters=jstore,
                              adapter_ids=tenants)
    got = generate_paged(tmodel, batch, GenerationConfig(max_new_tokens=6, eos_token_id=2),
                         prompt_lengths=lens, adapters=tstore, adapter_ids=tenants)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert _counters(tstore) == _counters(jstore)
    base = generate_paged(tmodel, batch[1:2], GenerationConfig(max_new_tokens=6, eos_token_id=2),
                          prompt_lengths=lens[1:2])
    assert torch.equal(base[0], got[1])


def test_batched_serve_matches_per_request_reference(models, tmp_path):
    """tests/test_lora.py:267's contract on the port: a mixed-tenant trace
    served batched, with hot-swaps from the disk tier and page-pressure
    evictions, emits per request the tokens of that request served alone
    through ``generate_paged`` with its adapter."""
    _, tstore = _stores(models, offload=tmp_path)
    eng = ServingEngine(models[2], ServingPlugin(**TIGHT, decode_kernel="native"),
                        GenerationConfig(max_new_tokens=6), device="cpu", adapters=tstore)
    trace = synthesize_trace(3, 7, **TRACE)
    rep = replay(eng, trace)
    assert rep["completed"] == 7 and rep["adapter_swaps"] > 0 and rep["evictions"] > 0
    _, ref_store = _stores(models)
    for r in trace:
        out = generate_paged(models[2], np.asarray([r.prompt], np.int32),
                             GenerationConfig(max_new_tokens=r.max_new_tokens),
                             serving_plugin=ServingPlugin(**GEOMETRY, decode_kernel="native"),
                             adapters=ref_store, adapter_ids=[r.adapter_id])
        assert eng.results[r.uid] == out[0].tolist()[:len(eng.results[r.uid])], r.uid


def test_trace_and_replay_fields(models):
    """``synthesize_trace(adapters=N)`` equals JAX's (the tenant drawn after
    the prompt); without a store the replay's adapter fields are zeros."""
    kw = dict(vocab_size=32000, mean_interarrival_steps=0.5, prompt_len_range=(64, 512),
              new_tokens_range=(32, 256), adapters=8)
    want = jax_synthesize_trace(0, 16, **kw)
    assert synthesize_trace(0, 16, **kw) == [
        Request(r.uid, r.prompt, r.max_new_tokens, r.arrival_step, r.adapter_id) for r in want]
    assert len({r.adapter_id for r in want}) > 4
    eng = ServingEngine(models[2], ServingPlugin(**GEOMETRY), GenerationConfig(max_new_tokens=3),
                        device="cpu")
    rep = replay(eng, synthesize_trace(1, 3, vocab_size=255, prompt_len_range=(3, 9),
                                       new_tokens_range=(3, 6)))
    zeros = {"adapters": 0, "adapter_requests": 0, "adapter_pool_slots": 0, "lora_rank": 0,
             "adapter_pool_hit_rate": 0.0, "adapter_pool_hit_rate_predicted": 0.0,
             "adapter_swaps": 0, "adapter_swap_bytes": 0}
    assert {k: rep[k] for k in zeros} == zeros
