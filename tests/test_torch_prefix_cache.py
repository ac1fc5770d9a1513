"""The port's content-addressed prefix cache (``accelerate_tpu_torch/
serving/prefix_cache.py``, the engine's adopt / COW release / push-free
steps, the scheduler's prefix admission) held against the JAX package's.

Hashes, refcounts, free stacks, block tables, scheduler event logs and the
prefix statistics must be equal, integer for integer and byte for byte;
tokens must be equal with the prefix cache on and off, exactly, within the
port (JAX pins the same bitwise), and equal to JAX's on the same f32
weights.  The JAX engine runs its ``"native"`` attention on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.generation import GenerationConfig as JaxGenerationConfig
from accelerate_tpu.models import llama as jl
from accelerate_tpu.ops import lora as jlora
from accelerate_tpu.serving import AdapterStore as JaxAdapterStore
from accelerate_tpu.serving import PrefixCache as JaxPrefixCache
from accelerate_tpu.serving import ServingEngine as JaxServingEngine
from accelerate_tpu.serving import block_hashes as jax_block_hashes
from accelerate_tpu.serving import prefix_cache_accounting as jax_accounting
from accelerate_tpu.serving import synthesize_trace as jax_synthesize_trace
from accelerate_tpu.serving import unbounded_prefix_hit_rate as jax_unbounded
from accelerate_tpu.serving import verify_serving_invariants as jax_invariants
from accelerate_tpu.serving.harness import predicted_prefix_hit_rate as jax_predicted
from accelerate_tpu.utils.dataclasses import LoraPlugin as JaxLoraPlugin
from accelerate_tpu.utils.dataclasses import ServingPlugin as JaxServingPlugin
from accelerate_tpu_torch import (
    AdapterStore,
    GenerationConfig,
    LlamaConfig,
    LlamaForCausalLM,
    LoraPlugin,
    Request,
    ServingEngine,
    ServingPlugin,
    generate,
    generate_paged,
    replay,
    synthesize_trace,
)
from accelerate_tpu_torch.models.convert import lora_tree_from_flax, torch_state_from_flax
from accelerate_tpu_torch.serving import (
    PrefixCache,
    block_hashes,
    predicted_prefix_hit_rate,
    prefix_cache_accounting,
    unbounded_prefix_hit_rate,
    verify_serving_invariants,
)
from accelerate_tpu_torch.telemetry import twin_registry

MAX_NEW = 16
PLUGIN = dict(num_slots=4, page_size=4, pages_per_slot=8, num_pages=24, prefill_chunk=8,
              prefill_buckets=(4, 8))
PREFIX_STATS = ("lookup_pages", "hit_pages", "admission_hits", "admission_lookups",
                "cow_forks", "prefill_tokens_skipped", "pages_shared_peak",
                "prefix_evictions", "inserted_pages")


@pytest.fixture(scope="module")
def models():
    jmodel = jl.LlamaForCausalLM(jl.LlamaConfig.tiny(dtype=jnp.float32))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tmodel = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device="cpu")
    tmodel.load_state_dict(torch_state_from_flax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


def _trace_kw(seed, n, share=0.85, pre_len=9, new=(4, 8), adapters=0):
    return dict(seed=seed, n_requests=n, vocab_size=256, mean_interarrival_steps=1.0,
                prompt_len_range=(4, 12), new_tokens_range=new, prefix_share=share,
                shared_prefix_len=pre_len, adapters=adapters)


# ---------------------------------------------------------------------------
# hashing and the host-side refcount contract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("adapter_id", [0, 3])
def test_block_hashes_are_jax_bytes(kv_dtype, adapter_id):
    rng = np.random.default_rng(len(kv_dtype) + adapter_id)
    for n in (1, 3, 4, 5, 12, 13, 40):
        prompt = tuple(int(x) for x in rng.integers(1, 32000, n))
        for page in (1, 4, 16):
            got = block_hashes(prompt, page, adapter_id, kv_dtype)
            assert got == jax_block_hashes(prompt, page, adapter_id, kv_dtype)
            assert len(got) == (n - 1) // page
            assert all(isinstance(h, bytes) and len(h) == 16 for h in got)


def test_hash_chain_is_keyed_by_kv_dtype_tenant_and_prefix():
    p = tuple(range(1, 14))
    h = block_hashes(p, 4)
    assert block_hashes(p, 4, kv_dtype="bf16") == h
    int8, fp8 = block_hashes(p, 4, kv_dtype="int8"), block_hashes(p, 4, kv_dtype="fp8")
    assert not set(int8) & set(h) and not set(int8) & set(fp8)
    assert int8 == jax_block_hashes(p, 4, kv_dtype="int8")
    assert PrefixCache(4, kv_dtype="int8").block_hashes(p) == int8
    assert block_hashes(p, 4, adapter_id=1) != h
    assert block_hashes((99,) + p[1:], 4)[1] != h[1]
    assert len(block_hashes(tuple(range(1, 13)), 4)) == 2


def _state(pc):
    return (dict(pc.index), dict(pc.page_hash), dict(pc.refcount), list(pc.pending_free),
            dict(pc.stats), pc.report(), pc.hit_rate())


def _lifecycle(cls, hash_fn):
    """The JAX tests' refcount lifecycle, LRU reclaim, protection, flush and
    insert conflict, one cache class; the state after every step."""
    pc = cls(4)
    h = hash_fn(tuple(range(1, 14)), 4)
    g = hash_fn(tuple(range(50, 63)), 4)
    out = []

    def note(x):
        out.append((x, _state(pc)))

    note(pc.insert_owned(h, [10, 11, 12]))
    note(pc.adopt(h))
    note(pc.adopt(h[:2] + g[2:]))          # a proper-prefix hit: a cow fork
    note(pc.adopt(g))                      # a miss
    note(pc.unref_pages([10, 11, 12]))
    note(pc.unref_pages([10, 11]))
    note(pc.reclaim_one())
    note(pc.unref_pages([10, 11, 12]))
    note(pc.reclaim_one(protect=frozenset({10, 11, 12})))
    note(pc.insert_owned(g, [20, 21, 22]))
    note(pc.insert_owned(g, [30, 31, 32]))  # the race's loser keeps its pages
    note(pc.insert_owned(h[:2], [40, 41]))  # stops at the indexed conflict
    note(pc.reclaim_one())
    note(pc.pop_pending())
    note(pc.adopt(g, count=False))
    note(pc.flush())
    note(sorted(pc.pop_pending()))
    pc.ref_pages([7])
    pc.pending_free.append(7)              # planted: freed while referenced
    with pytest.raises(RuntimeError, match="double-free"):
        pc.pop_pending()
    note(pc.hit_tokens(tuple(range(50, 63))))
    with pytest.raises(RuntimeError, match="refcount"):
        pc.unref_pages([999])
    return out


def test_refcount_lifecycle_reclaim_and_guards_match_jax():
    got = _lifecycle(PrefixCache, block_hashes)
    want = _lifecycle(JaxPrefixCache, jax_block_hashes)
    assert got == want
    # the hand-checked landmarks (JAX tests/test_prefix_cache.py)
    assert got[0][0] == [10, 11, 12] and got[1][0] == [10, 11, 12]
    assert got[2][1][4]["cow_forks"] == 1
    assert got[6][0] is None and got[10][0] == []


@pytest.mark.parametrize("seed", [0, 3])
def test_accounting_and_unbounded_hit_rate_match_jax(seed):
    kw = _trace_kw(seed, 10)
    trace, jtrace = synthesize_trace(**kw), jax_synthesize_trace(**kw)
    for page in (2, 4):
        assert unbounded_prefix_hit_rate(trace, page) == jax_unbounded(jtrace, page)
        got = prefix_cache_accounting(LlamaConfig.tiny(), trace, page, dtype_bytes=4)
        assert got == jax_accounting(jl.LlamaConfig.tiny(), jtrace, page, dtype_bytes=4)
        assert got["prefill_tokens_skippable"] > 0 and 0.0 < got["dedup_frac"] < 1.0


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("share", [0.5, 0.85])
def test_synthesize_trace_with_shared_prefixes_equals_jax(seed, share):
    kw = _trace_kw(seed, 12, share=share, adapters=2)
    got = synthesize_trace(**kw)
    want = jax_synthesize_trace(**kw)
    assert [dataclasses.astuple(r) for r in got] == [dataclasses.astuple(r) for r in want]
    kw = dict(vocab_size=32000, mean_interarrival_steps=0.5, prompt_len_range=(64, 512),
              new_tokens_range=(32, 256), prefix_share=0.5)
    assert [dataclasses.astuple(r) for r in synthesize_trace(seed, 16, **kw)] == \
        [dataclasses.astuple(r) for r in jax_synthesize_trace(seed, 16, **kw)]


@pytest.mark.parametrize("num_pages", [12, 24])
def test_predicted_prefix_hit_rate_matches_jax(num_pages):
    kw = _trace_kw(7, 12, new=(4, 10))
    geo = dict(num_slots=4, num_pages=num_pages, page_size=4, pages_per_slot=8,
               prefill_chunk=8)
    got = predicted_prefix_hit_rate(synthesize_trace(**kw), **geo)
    assert got == jax_predicted(jax_synthesize_trace(**kw), **geo)
    assert got > 0


# ---------------------------------------------------------------------------
# the engine: prefix on == off, and == JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["auto", "native"])
def test_generate_paged_prefix_on_equals_off_and_generate(models, kernel):
    tmodel = models[2]
    rng = np.random.default_rng(1)
    pre = tuple(int(x) for x in rng.integers(1, 255, 9))
    prompts = [pre + tuple(int(x) for x in rng.integers(1, 255, k)) for k in (3, 5, 4)]
    ids = np.zeros((3, max(len(p) for p in prompts)), np.int32)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    lens = [len(p) for p in prompts]
    gc = GenerationConfig(max_new_tokens=MAX_NEW)
    plug = ServingPlugin(**{**PLUGIN, "num_slots": 3}, decode_kernel=kernel)
    off = generate_paged(tmodel, ids, gc, prompt_lengths=lens, serving_plugin=plug)
    on = generate_paged(tmodel, ids, gc, prompt_lengths=lens, serving_plugin=plug,
                        prefix_cache=True)
    assert torch.equal(on, off)
    assert torch.equal(on, generate(tmodel, ids, gc, prompt_lengths=lens))


def _serve_both(models, trace_kw, engine_kw=None, adapters=None, plugin=PLUGIN):
    """The same trace through both engines; the port's resource contract
    checked after every tick."""
    jmodel, params, tmodel = models
    engine_kw = {"prefix_cache": "on", **(engine_kw or {})}
    jstore, tstore = adapters if adapters is not None else (None, None)
    jeng = JaxServingEngine(jmodel, params,
                            JaxServingPlugin(**plugin, decode_kernel="native", **engine_kw),
                            JaxGenerationConfig(max_new_tokens=MAX_NEW), adapters=jstore)
    jeng.run(jax_synthesize_trace(**trace_kw))
    teng = ServingEngine(tmodel, ServingPlugin(**plugin, decode_kernel="native", **engine_kw),
                         GenerationConfig(max_new_tokens=MAX_NEW), device="cpu",
                         adapters=tstore)
    pending = sorted(synthesize_trace(**trace_kw), key=lambda r: (r.arrival_step, r.uid))
    i = 0
    while i < len(pending) or not teng.idle():
        while i < len(pending) and pending[i].arrival_step <= teng.steps:
            teng.add_request(pending[i])
            i += 1
        teng.step()
        assert verify_serving_invariants(teng) == [], teng.steps
    return jeng, teng


def _assert_same_prefix_serving(jeng, teng):
    assert teng.results == jeng.results
    assert teng.sched.events == jeng.sched.events
    for key in ("evictions", "prefill_steps", "decode_steps", "prompt_tokens", "page_step_sum",
                "peak_used_pages", "verify_steps", "draft_tokens", "accepted_draft_tokens",
                "speculative_rollbacks"):
        assert teng.metrics[key] == jeng.metrics[key], key
    assert teng.ttft_ticks == jeng.ttft_ticks
    assert {k: teng.prefix.stats[k] for k in PREFIX_STATS} == \
        {k: jeng.prefix.stats[k] for k in PREFIX_STATS}
    assert teng.prefix.index == jeng.prefix.index
    assert teng.prefix.refcount == jeng.prefix.refcount
    assert int(teng.cache["free_top"]) == int(jeng.cache["free_top"])
    np.testing.assert_array_equal(teng.cache["free_stack"].numpy(),
                                  np.asarray(jeng.cache["free_stack"]))
    np.testing.assert_array_equal(teng.cache["block_tables"].numpy(),
                                  np.asarray(jeng.cache["block_tables"]))
    assert verify_serving_invariants(teng) == [] and jax_invariants(jeng) == []


@pytest.mark.parametrize("seed, num_pages", [(7, 24), (7, 14), (3, 12)])
def test_engine_prefix_matches_jax_under_evictions(models, seed, num_pages):
    """Recompute-on-readmit under pool pressure with the cache on: hits,
    copy-on-write forks, reclaims and evictions land on the same ticks as
    JAX's, on the same page ids, and the tokens equal the cache-off
    serve."""
    trace_kw = _trace_kw(seed, 12, new=(4, 10))
    plugin = {**PLUGIN, "num_pages": num_pages}
    jeng, teng = _serve_both(models, trace_kw, plugin=plugin)
    off = ServingEngine(models[2], ServingPlugin(**plugin, decode_kernel="native"),
                        GenerationConfig(max_new_tokens=MAX_NEW), device="cpu")
    off_results = off.run(synthesize_trace(**trace_kw))
    _assert_same_prefix_serving(jeng, teng)
    assert teng.results == off_results
    assert any(ev[0] == "prefix_hit" for ev in teng.sched.events)
    assert teng.prefix.stats["prefill_tokens_skipped"] > 0
    if num_pages < 24:
        assert teng.metrics["evictions"] > 0


def test_speculative_rollback_never_frees_an_aliased_page(models):
    """Speculation and prefix reuse together: the verify pass's worst-case
    allocate and rollback touch only pages popped in that pass, so after
    every tick no referenced page is on the free stack and the refcounts
    balance; tokens equal the plain serve's and JAX's."""
    trace_kw = _trace_kw(7, 10, new=(4, 10))
    jeng, teng = _serve_both(models, trace_kw,
                             engine_kw={"speculate": "ngram", "speculate_k": 4})
    _assert_same_prefix_serving(jeng, teng)
    assert teng.metrics["verify_steps"] > 0
    assert teng.metrics["speculative_rollbacks"] > 0
    assert any(ev[0] == "prefix_hit" for ev in teng.sched.events)
    plain = ServingEngine(models[2], ServingPlugin(**PLUGIN, decode_kernel="native"),
                          GenerationConfig(max_new_tokens=MAX_NEW), device="cpu")
    assert plain.run(synthesize_trace(**trace_kw)) == teng.results


def test_mixed_tenants_never_alias_and_match_jax(models):
    """Tenant-keyed hashing: a prompt under two adapters never shares pages
    (no ``prefix_hit`` across tenants), and the multi-tenant serve with the
    cache on equals JAX's and the cache-off serve."""
    jmodel, params, tmodel = models
    plugin = dict(rank=4, pool_slots=2, kernel="native")
    spec = jlora.lora_spec(params)
    trees = {t: jlora.init_adapter_params(jax.random.PRNGKey(100 + t), spec, 4,
                                          init_b="normal") for t in (1, 2)}

    def stores():
        jstore = JaxAdapterStore(params, JaxLoraPlugin(**plugin))
        tstore = AdapterStore(tmodel, LoraPlugin(**plugin))
        for t, tree in trees.items():
            jstore.publish(t, tree)
            tstore.publish(t, lora_tree_from_flax(jax.tree.map(np.asarray, tree)))
        return jstore, tstore

    trace_kw = _trace_kw(5, 12, share=0.9, adapters=2)
    jeng, teng = _serve_both(models, trace_kw, adapters=stores())
    _assert_same_prefix_serving(jeng, teng)
    assert any(ev[0] == "prefix_hit" for ev in teng.sched.events)
    _, tstore = stores()
    off = ServingEngine(tmodel, ServingPlugin(**PLUGIN, decode_kernel="native"),
                        GenerationConfig(max_new_tokens=MAX_NEW), device="cpu", adapters=tstore)
    assert off.run(synthesize_trace(**trace_kw)) == teng.results
    # serve-then-serve one prompt on a fresh engine: its tenant hits, the
    # other tenant and the base model miss (their K/V differ)
    _, tstore = stores()
    eng = ServingEngine(tmodel, ServingPlugin(**PLUGIN, decode_kernel="native",
                                              prefix_cache="on"),
                        GenerationConfig(max_new_tokens=MAX_NEW), device="cpu", adapters=tstore)
    prompt = tuple(range(7, 20))
    for uid, tid in ((0, 1), (1, 2), (2, 0), (3, 1)):
        eng.add_request(Request(uid=uid, prompt=prompt, max_new_tokens=2, adapter_id=tid))
        while not eng.idle():
            eng.step()
    hits = {ev[1] for ev in eng.sched.events if ev[0] == "prefix_hit"}
    assert hits == {3}
    assert verify_serving_invariants(eng) == []


def test_replay_prefix_fields_match_jax_and_record_the_twin(models):
    """Serve-then-serve traffic (staggered arrivals, so later requests hit
    what earlier ones inserted): the report's prefix block equals JAX's
    replay of the same trace, zeros with the cache off."""
    from accelerate_tpu.serving import replay as jax_replay
    from accelerate_tpu.telemetry import twin_registry as jax_twin_registry

    jmodel, params, tmodel = models
    trace_kw = _trace_kw(7, 12, new=(4, 10))
    keys = ("prefix_cache", "prefix_hit_rate", "prefix_hit_rate_predicted",
            "pages_shared_peak", "cow_forks", "prefill_tokens_skipped", "prefix_evictions",
            "ttft_p50_ticks")
    twin_registry().reset()
    for mode in ("off", "on"):
        jeng = JaxServingEngine(jmodel, params,
                                JaxServingPlugin(**PLUGIN, decode_kernel="native",
                                                 prefix_cache=mode),
                                JaxGenerationConfig(max_new_tokens=MAX_NEW))
        want = jax_replay(jeng, jax_synthesize_trace(**trace_kw))
        teng = ServingEngine(tmodel, ServingPlugin(**PLUGIN, prefix_cache=mode),
                             GenerationConfig(max_new_tokens=MAX_NEW), device="cpu")
        got = replay(teng, synthesize_trace(**trace_kw), verify_invariants=True)
        assert {k: got[k] for k in keys} == {k: want[k] for k in keys}, mode
        assert dict(teng.results) == want["results"]
    assert got["prefix_hit_rate"] > 0 and got["prefill_tokens_skipped"] > 0
    twin = twin_registry().get("prefix_cache.hit_rate")
    assert twin.row() == jax_twin_registry().get("prefix_cache.hit_rate").row()
    twin_registry().reset()
    jax_twin_registry().reset()


def test_engine_refuses_only_the_overload_knobs(models):
    """The engine refuses no knob now: the overload controls serve beside
    the prefix cache — a shared-preamble trace under a bounded queue, a
    watermark and per-request deadlines cancels and sheds slots holding
    shared pages exactly as JAX's (hits, refcounts, index, free stack), and
    the refcounted resource contract holds after every tick."""
    trace_kw = {**_trace_kw(7, 12, new=(4, 10)), "mean_interarrival_steps": 0.5}
    knobs = dict(max_queue=4, kv_shed_watermark=0.9, default_deadline_ticks=18)
    jeng, teng = _serve_both(models, trace_kw, engine_kw=knobs)
    _assert_same_prefix_serving(jeng, teng)
    assert any(ev[0] == "cancel" for ev in teng.sched.events)
    assert teng.sched.pages_reclaimed_on_cancel == jeng.sched.pages_reclaimed_on_cancel
    assert teng.prefix.stats["hit_pages"] > 0
