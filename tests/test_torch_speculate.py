"""Speculative decode in the port (``accelerate_tpu_torch/serving/
speculate.py``, the engine's verify step, the scheduler's speculative
reservations) held against the JAX package's, and against the port's own
greedy decode.

Both frameworks get the same numpy inputs and the same f32 weights (the JAX
tree carried across by ``torch_state_from_flax``).  Host logic — drafts,
buckets, page arithmetic, scheduler event logs, metrics, free stacks — must
be equal; tokens must be equal too (f32 tiny models, greedy argmax, no
near-ties on these traces).  The port's speculative tokens must equal its
own greedy tokens exactly, under eviction pressure too (JAX's own pin of
that, ``tests/test_speculate.py::test_speculate_parity_under_eviction_pressure``,
asserts acceptances its bf16 model does not make; these traces repeat a
short cycle, so drafts accept).  The JAX engine runs its ``"native"``
attention on the CPU; the port runs ``"native"`` or, under ``"auto"``, its
kernels' plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.generation import GenerationConfig as JaxGenerationConfig
from accelerate_tpu.generation import generate_paged as jax_generate_paged
from accelerate_tpu.models import llama as jl
from accelerate_tpu.serving import AdapterStore as JaxAdapterStore
from accelerate_tpu.serving import DraftModelDraft as JaxDraftModelDraft
from accelerate_tpu.serving import NgramDraft as JaxNgramDraft
from accelerate_tpu.serving import Request as JaxRequest
from accelerate_tpu.serving import ServingEngine as JaxServingEngine
from accelerate_tpu.serving import Speculator as JaxSpeculator
from accelerate_tpu.serving import predicted_acceptance as jax_predicted_acceptance
from accelerate_tpu.serving import synthesize_trace as jax_synthesize_trace
from accelerate_tpu.serving.scheduler import ContinuousBatchingScheduler as JaxScheduler
from accelerate_tpu.serving.speculate import speculative_page_need as jax_page_need
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
    DraftModelDraft,
    NgramDraft,
    Speculator,
    predicted_acceptance,
    speculative_page_need,
    verify_serving_invariants,
)
from accelerate_tpu_torch.serving.scheduler import ContinuousBatchingScheduler
from accelerate_tpu_torch.telemetry import twin_registry

GEOMETRY = dict(num_slots=4, page_size=4, pages_per_slot=16, num_pages=40, prefill_chunk=16)
# pools small enough that speculation degrades draft depths and evicts
TIGHT = [dict(num_slots=3, page_size=2, pages_per_slot=12, num_pages=12, prefill_chunk=8),
         dict(num_slots=3, page_size=2, pages_per_slot=14, num_pages=14, prefill_chunk=8),
         dict(num_slots=4, page_size=2, pages_per_slot=12, num_pages=16, prefill_chunk=8)]
SPEC_METRICS = ("verify_steps", "draft_tokens", "accepted_draft_tokens",
                "speculative_rollbacks")
STEP_METRICS = ("decode_steps", "prefill_steps", "idle_steps", "scheduled_decode_slots",
                "useful_decode_tokens", "prefill_scheduled_tokens", "prefill_useful_tokens",
                "evictions", "page_step_sum", "peak_used_pages", "prompt_tokens",
                "generated_tokens", "decode_lane_passes", "decode_emitted_tokens")


@pytest.fixture(scope="module")
def models():
    jmodel = jl.LlamaForCausalLM(jl.LlamaConfig.tiny(dtype=jnp.float32))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tmodel = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device="cpu")
    tmodel.load_state_dict(torch_state_from_flax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


def _cycle_prompts(seed, lens):
    """Prompts repeating a 3-token cycle: prompt lookup proposes the cycle,
    and the tiny model's greedy continuation follows it often enough that
    drafts accept."""
    rng = np.random.default_rng(seed)
    out = []
    for n in lens:
        cyc = [int(x) for x in rng.integers(1, 255, 3)]
        out.append(tuple((cyc * 20)[:n]))
    return out


def _greedy(tmodel, prompt, n):
    out = generate(tmodel, np.asarray([prompt], np.int32), GenerationConfig(max_new_tokens=n))
    return [int(x) for x in out[0]]


# ---------------------------------------------------------------------------
# draft providers, buckets, page arithmetic (host logic, exact)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ngram_proposals_match_jax(seed):
    rng = np.random.default_rng(seed)
    contexts = [[int(x) for x in rng.integers(1, 6, int(rng.integers(1, 40)))]
                for _ in range(12)]
    for max_ngram in (1, 3):
        port, ref = NgramDraft(max_ngram=max_ngram), JaxNgramDraft(max_ngram=max_ngram)
        for k in (1, 3, 5):
            for ctx in contexts:
                assert port.propose_one(ctx, k) == ref.propose_one(ctx, k)
            got, want = port.propose(contexts, k), ref.propose(contexts, k)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    assert NgramDraft().propose_one([1, 7, 8, 9, 10, 2, 7, 8], 3) == [9, 10, 2]
    with pytest.raises(ValueError):
        NgramDraft(max_ngram=1, min_ngram=2)


@pytest.mark.parametrize("buckets", [(4,), (2, 4), (1, 3, 6)])
def test_speculator_buckets_and_clamp_match_jax(buckets):
    k = max(buckets)
    port, ref = Speculator(NgramDraft(), k, buckets), JaxSpeculator(JaxNgramDraft(), k, buckets)
    assert port.buckets == ref.buckets
    for depth in range(k + 2):
        assert port.bucket_for(depth) == ref.bucket_for(depth)
    contexts = [[5, 6, 5, 6, 5, 6, 5, 6], [1, 2, 3], [9] * 9, [4, 4]]
    remaining = [8, 1, 3, 2]
    for got, want in zip(port.draft(contexts, remaining), ref.draft(contexts, remaining)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        Speculator(NgramDraft(), k + 1, buckets)


def test_speculative_page_need_matches_jax():
    for page in (1, 2, 4, 5):
        for kv in range(0, 21):
            for depth in range(0, 6):
                assert speculative_page_need(kv, depth, page) == jax_page_need(kv, depth, page)


def _script(sched_cls):
    """The JAX package's hand-checked speculative page accounting, then its
    degrade-before-evict planner, on one scheduler class."""
    sched = sched_cls(num_slots=2, num_pages=8, page_size=4, pages_per_slot=4,
                      prefill_chunk=8, prefill_buckets=(8,), speculate_k=3)
    req = (1, 2, 3, 4, 5)
    out = [sched.admission_page_need(_req(sched_cls, 0, req, 8)),
           sched.admission_page_need(_req(sched_cls, 1, (1, 2, 3), 1))]
    sched.submit(_req(sched_cls, 0, req, 8))
    sched.admit()
    slot = next(iter(sched.slots))
    st = sched.slots[slot]
    st.prefilled = 5
    sched.free_pages = sched.num_pages - 2
    st.tokens.append(42)
    out.append(sched.verify_page_need([slot], {slot: 3}))
    sched.note_verify({slot: 2})
    out.append((st.kv_len, sched.free_pages))
    out.append(sched.verify_page_need([slot], {slot: 1}))
    sched.note_verify({slot: 1})
    out.append((st.kv_len, sched.free_pages))
    sched.finish(slot)
    out.append(sched.free_pages)
    pressed = sched_cls(num_slots=3, num_pages=6, page_size=2, pages_per_slot=4,
                        prefill_chunk=4, prefill_buckets=(4,), speculate_k=2)
    for uid in range(3):
        pressed.submit(_req(sched_cls, uid, (1, 2), 6))
    admitted = pressed.admit()
    for s in admitted:
        pressed.slots[s].prefilled = 2
        pressed.slots[s].tokens.append(7)
    pressed.free_pages = 2
    spec = {s: 2 for s in admitted}
    out.append(pressed.plan_speculative_evictions(list(admitted), spec))
    out.append(dict(spec))
    return out, sched.events, pressed.events


def _req(sched_cls, uid, prompt, n):
    cls = JaxRequest if sched_cls is JaxScheduler else Request
    return cls(uid=uid, prompt=prompt, max_new_tokens=n)


def test_scheduler_speculative_accounting_matches_jax():
    got, got_events, got_pressed = _script(ContinuousBatchingScheduler)
    want, want_events, want_pressed = _script(JaxScheduler)
    assert got == want
    assert got_events == want_events and got_pressed == want_pressed
    # the hand-checked values: prompt + first verify, depth clamped by budget
    assert got[:2] == [3, 1]
    assert got[3] == (8, 6) and got[5] == (10, 5) and got[6] == 8
    assert all(d == 0 for d in got[-1].values())
    assert any(ev[0] == "despeculate" for ev in got_pressed)


# ---------------------------------------------------------------------------
# the acceptance twin and the draft model
# ---------------------------------------------------------------------------


def test_predicted_acceptance_matches_jax(models):
    tmodel = models[2]
    trace = synthesize_trace(3, 6, vocab_size=255, prompt_len_range=(4, 16),
                             new_tokens_range=(4, 12))
    eng = ServingEngine(tmodel, ServingPlugin(**GEOMETRY, speculate="ngram"),
                        GenerationConfig(max_new_tokens=16), device="cpu")
    results = eng.run(trace)
    jtrace = [JaxRequest(r.uid, r.prompt, r.max_new_tokens, r.arrival_step) for r in trace]
    for k in (2, 4):
        assert predicted_acceptance(trace, results, NgramDraft(), k) == \
            jax_predicted_acceptance(jtrace, results, JaxNgramDraft(), k)
    hand = predicted_acceptance([Request(0, (5, 6, 5, 6), 4)], {0: [9, 5, 6, 5]}, NgramDraft(), 4)
    assert (hand["verify_passes"], hand["drafted"], hand["accepted"]) == (2, 1, 1)


@pytest.mark.parametrize("impl", ["native", "flash"])
def test_draft_model_proposals_match_jax(models, impl):
    """The windowed, cache-free draft forward: contexts shorter than the
    window right-pad, longer ones slide; proposals equal JAX's (under
    ``"flash"`` the port's forward takes kernel #1's plain version)."""
    jmodel, params, _ = models
    cfg = LlamaConfig.tiny(dtype=torch.float32, attn_implementation=impl)
    draft = LlamaForCausalLM(cfg, device="cpu")
    draft.load_state_dict(torch_state_from_flax(jax.tree.map(np.asarray, params)))
    port, ref = DraftModelDraft(draft, window=8), JaxDraftModelDraft(jmodel, params, window=8)
    contexts = [[5, 42, 7], list(range(1, 20)), [3] * 8, [200]]
    got, want = port.propose(contexts, 3), ref.propose(contexts, 3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(ValueError):
        DraftModelDraft(draft, window=1)


# ---------------------------------------------------------------------------
# THE pin: speculative tokens == greedy tokens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode, kernel", [("ngram", "auto"), ("ngram", "native"),
                                          ("draft", "auto")])
def test_generate_paged_speculate_equals_greedy(models, mode, kernel):
    """Variable-length rows, an EOS mid-stream and padding after it:
    speculation changes no token (the draft model here is the target
    itself, so every draft is accepted)."""
    tmodel = models[2]
    batch = np.asarray([[5, 42, 7, 9, 5, 42, 7, 9], [11, 3, 11, 3, 0, 0, 0, 0],
                        [8, 8, 8, 8, 8, 8, 0, 0]], np.int32)
    lens = [8, 4, 6]
    gc = GenerationConfig(max_new_tokens=10, eos_token_id=2, pad_token_id=0)
    plugin = ServingPlugin(num_slots=3, page_size=4, pages_per_slot=6, num_pages=18,
                           prefill_chunk=8, decode_kernel=kernel)
    want = generate(tmodel, batch, gc, prompt_lengths=lens)
    got = generate_paged(tmodel, batch, gc, prompt_lengths=lens, serving_plugin=plugin,
                         speculate=mode, speculate_k=3,
                         draft_model=tmodel if mode == "draft" else None)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    off = generate_paged(tmodel, batch, gc, prompt_lengths=lens,
                         serving_plugin=ServingPlugin(num_slots=3, page_size=4, pages_per_slot=6,
                                                      num_pages=18, prefill_chunk=8,
                                                      speculate="ngram"),
                         speculate=False)
    np.testing.assert_array_equal(off.numpy(), want.numpy())


def test_generate_paged_speculate_matches_jax(models):
    jmodel, params, tmodel = models
    batch = np.asarray([[5, 42, 7, 9, 5, 42], [11, 3, 11, 3, 0, 0]], np.int32)
    lens = [6, 4]
    got = generate_paged(tmodel, batch, GenerationConfig(max_new_tokens=9),
                         prompt_lengths=lens, speculate="ngram", speculate_k=2)
    want = jax_generate_paged(jmodel, params, jnp.asarray(batch),
                              JaxGenerationConfig(max_new_tokens=9), prompt_lengths=lens,
                              speculate="ngram", speculate_k=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _serve_both(models, geometry, prompts, n_new, kernel="native", **spec):
    jmodel, params, tmodel = models
    spec = {"speculate": "ngram", "speculate_k": 3, **spec}
    jeng = JaxServingEngine(jmodel, params,
                            JaxServingPlugin(**geometry, decode_kernel="native", **spec),
                            JaxGenerationConfig(max_new_tokens=n_new))
    teng = ServingEngine(tmodel, ServingPlugin(**geometry, decode_kernel=kernel, **spec),
                         GenerationConfig(max_new_tokens=n_new), device="cpu")
    for i, p in enumerate(prompts):
        jeng.add_request(JaxRequest(uid=i, prompt=p, max_new_tokens=n_new))
        teng.add_request(Request(uid=i, prompt=p, max_new_tokens=n_new))
    while not teng.idle():
        teng.step()
        assert verify_serving_invariants(teng) == []
    while not jeng.idle():
        jeng.step()
    return jeng, teng


def _assert_same_speculation(jeng, teng):
    assert teng.results == jeng.results
    assert teng.sched.events == jeng.sched.events
    for key in STEP_METRICS + SPEC_METRICS:
        assert teng.metrics[key] == jeng.metrics[key], key
    assert teng.ttft_ticks == jeng.ttft_ticks and teng.steps == jeng.steps
    assert teng.free_page_mirror_in_sync() and jeng.free_page_mirror_in_sync()
    np.testing.assert_array_equal(teng.cache["free_stack"].numpy(),
                                  np.asarray(jeng.cache["free_stack"]))
    np.testing.assert_array_equal(teng.cache["block_tables"].numpy(),
                                  np.asarray(jeng.cache["block_tables"]))


@pytest.mark.parametrize("geometry", TIGHT)
@pytest.mark.parametrize("seed", [0, 2])
def test_engine_speculate_under_eviction_pressure_matches_jax_and_greedy(models, geometry,
                                                                         seed):
    """A pool too small for the load: draft depths degrade (``despeculate``
    events), sequences are evicted and recomputed, rejected drafts roll
    pages back — and every request emits its solo greedy tokens, with the
    event log, the page accounting and the four speculation metrics equal
    to JAX's, and the resource contract holding after every tick."""
    prompts = _cycle_prompts(seed, (9, 7, 8, 6))[:geometry["num_slots"] + 1]
    jeng, teng = _serve_both(models, geometry, prompts, 12)
    _assert_same_speculation(jeng, teng)
    m = teng.metrics
    assert m["evictions"] > 0 and m["speculative_rollbacks"] > 0
    assert m["accepted_draft_tokens"] > 0
    assert any(ev[0] == "despeculate" for ev in teng.sched.events)
    for i, p in enumerate(prompts):
        assert teng.results[i] == _greedy(models[2], p, 12), i


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kernel", ["native", "auto"])
def test_engine_speculate_trace_matches_jax(models, seed, kernel):
    """A seeded trace at a roomy geometry: tokens, events (the per-pass
    accepted counts included), metrics and pages equal JAX's, under the
    port's native attention and its kernels' plain versions alike."""
    trace = synthesize_trace(seed, 8, vocab_size=255, mean_interarrival_steps=0.5,
                             prompt_len_range=(4, 16), new_tokens_range=(4, 16))
    jmodel, params, tmodel = models
    jeng = JaxServingEngine(jmodel, params, JaxServingPlugin(**GEOMETRY, speculate="ngram"),
                            JaxGenerationConfig(max_new_tokens=32))
    jres = jeng.run(jax_synthesize_trace(seed, 8, vocab_size=255, mean_interarrival_steps=0.5,
                                         prompt_len_range=(4, 16), new_tokens_range=(4, 16)))
    teng = ServingEngine(tmodel, ServingPlugin(**GEOMETRY, speculate="ngram",
                                               decode_kernel=kernel),
                         GenerationConfig(max_new_tokens=32), device="cpu")
    tres = teng.run(trace)
    assert tres == jres
    _assert_same_speculation(jeng, teng)
    assert any(ev[0] == "verify" for ev in teng.sched.events)


def test_replay_reports_speculation_and_records_twins(models):
    tmodel = models[2]
    twin_registry().reset()
    trace = synthesize_trace(0, 10, vocab_size=255, mean_interarrival_steps=0.5,
                             prompt_len_range=(4, 24), new_tokens_range=(4, 24))
    eng = ServingEngine(tmodel, ServingPlugin(**GEOMETRY, speculate="ngram"),
                        GenerationConfig(max_new_tokens=64), device="cpu")
    rep = replay(eng, trace, verify_invariants=True)
    assert rep["completed"] == len(trace) and rep["speculate"] == "ngram"
    assert rep["verify_steps"] > 0 and rep["tokens_per_step"] > 1.0
    assert rep["accepted_draft_tokens"] > 0 and rep["drafted_tokens"] > 0
    # no eviction in this pool: the model-free replay is exact
    assert rep["accept_rate"] == rep["accept_rate_predicted"]
    assert rep["tokens_per_step"] == rep["tokens_per_step_predicted"]
    for name in ("speculate.accept_rate", "speculate.tokens_per_step"):
        assert twin_registry().get(name).status == "ok"
    off = ServingEngine(tmodel, ServingPlugin(**GEOMETRY), GenerationConfig(max_new_tokens=64),
                        device="cpu")
    plain = replay(off, trace)
    assert dict(off.results) == dict(eng.results)
    assert (plain["speculate"], plain["verify_steps"], plain["tokens_per_step"]) == ("off", 0, 1.0)
    twin_registry().reset()


def test_engine_speculate_with_draft_model_accepts_everything(models):
    """The draft model is the target: every draft is accepted, tokens are
    greedy's."""
    tmodel = models[2]
    prompts = [(5, 42, 7), (9, 11), (3, 8, 2, 6)]
    eng = ServingEngine(tmodel, ServingPlugin(**GEOMETRY, speculate="draft", speculate_k=2),
                        GenerationConfig(max_new_tokens=9), device="cpu", draft_model=tmodel)
    eng.warmup()
    for i, p in enumerate(prompts):
        eng.add_request(Request(uid=i, prompt=p, max_new_tokens=9))
    while not eng.idle():
        eng.step()
    assert eng.metrics["accepted_draft_tokens"] == eng.metrics["draft_tokens"] > 0
    for i, p in enumerate(prompts):
        assert eng.results[i] == _greedy(tmodel, p, 9)


def test_speculate_with_lora_tenant_mix_matches_jax(models, tmp_path):
    """Mixed-tenant traffic, hot-swaps and page pressure served
    speculatively: tokens, events and metrics equal JAX's engine, and each
    request's tokens equal the port's single-request ``generate_paged``
    with its adapter."""
    from accelerate_tpu.ops import lora as jlora

    jmodel, params, tmodel = models
    plugin = dict(rank=4, pool_slots=2, kernel="native")
    jstore = JaxAdapterStore(params, JaxLoraPlugin(**plugin))
    tstore = AdapterStore(tmodel, LoraPlugin(**plugin))
    spec = jlora.lora_spec(params)
    trees = {t: jlora.init_adapter_params(jax.random.PRNGKey(100 + t), spec, 4,
                                          init_b="normal") for t in (1, 2, 3)}
    for t, tree in trees.items():
        jstore.publish(t, tree)
        tstore.publish(t, lora_tree_from_flax(jax.tree.map(np.asarray, tree)))
    geo = dict(num_slots=4, page_size=2, pages_per_slot=10, num_pages=14, prefill_chunk=8)
    kw = dict(vocab_size=255, prompt_len_range=(3, 9), new_tokens_range=(3, 6), adapters=3)
    jeng = JaxServingEngine(jmodel, params,
                            JaxServingPlugin(**geo, decode_kernel="native", speculate="ngram",
                                             speculate_k=3),
                            JaxGenerationConfig(max_new_tokens=32), adapters=jstore)
    jres = jeng.run(jax_synthesize_trace(3, 7, **kw))
    teng = ServingEngine(tmodel, ServingPlugin(**geo, decode_kernel="native", speculate="ngram",
                                               speculate_k=3),
                         GenerationConfig(max_new_tokens=32), device="cpu", adapters=tstore)
    trace = synthesize_trace(3, 7, **kw)
    tres = teng.run(trace)
    assert tres == jres and teng.sched.events == jeng.sched.events
    for key in SPEC_METRICS + ("evictions",):
        assert teng.metrics[key] == jeng.metrics[key], key
    assert verify_serving_invariants(teng) == []
    ref_store = AdapterStore(tmodel, LoraPlugin(**plugin))
    for t, tree in trees.items():
        ref_store.publish(t, lora_tree_from_flax(jax.tree.map(np.asarray, tree)))
    for r in trace:
        out = generate_paged(tmodel, np.asarray([r.prompt], np.int32),
                             GenerationConfig(max_new_tokens=r.max_new_tokens),
                             adapters=ref_store, adapter_ids=[r.adapter_id])
        assert tres[r.uid] == [int(x) for x in out[0]], r.uid


def test_speculate_guards(models):
    tmodel = models[2]
    with pytest.raises(ValueError, match="greedy"):
        ServingEngine(tmodel, ServingPlugin(**GEOMETRY, speculate="ngram"),
                      GenerationConfig(max_new_tokens=4, do_sample=True), device="cpu")
    with pytest.raises(ValueError, match="draft_model"):
        ServingEngine(tmodel, ServingPlugin(**GEOMETRY, speculate="draft"),
                      GenerationConfig(max_new_tokens=4), device="cpu")
    out = generate_paged(tmodel, np.asarray([[5, 42, 7, 9]], np.int32),
                         GenerationConfig(max_new_tokens=3, do_sample=True),
                         serving_plugin=ServingPlugin(num_slots=1, page_size=4, pages_per_slot=8,
                                                      num_pages=8, prefill_chunk=8,
                                                      speculate="ngram", speculate_k=2),
                         speculate=False)
    assert out.shape == (1, 3)
