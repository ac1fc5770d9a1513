"""The port's serving engine (``accelerate_tpu_torch/serving/``) held against
the JAX package's, and against the port's own ``generate()``.

Both engines serve the same seeded trace on the same f32 weights (the JAX
tree carried across by ``torch_state_from_flax``): greedy tokens, the
scheduler's ``events`` log and the step metrics must be identical.  With
``decode_kernel="flash"`` the JAX engine runs its Pallas kernels in
interpret mode and the port its kernels' plain versions (CPU tensors).
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.generation import GenerationConfig as JaxGenerationConfig
from accelerate_tpu.models import llama as jl
from accelerate_tpu.serving import ServingEngine as JaxServingEngine
from accelerate_tpu.serving import synthesize_trace as jax_synthesize_trace
from accelerate_tpu.utils.dataclasses import ServingPlugin as JaxServingPlugin
from accelerate_tpu_torch import (
    GenerationConfig,
    LlamaConfig,
    LlamaForCausalLM,
    Request,
    ServingEngine,
    ServingPlugin,
    generate,
    replay,
    synthesize_trace,
)
from accelerate_tpu_torch.models.convert import torch_state_from_flax
from accelerate_tpu_torch.ops import flash_attention as tfa

REPO = Path(__file__).resolve().parent.parent
GEOMETRY = dict(num_slots=4, page_size=4, pages_per_slot=10, num_pages=24, prefill_chunk=8)
# a pool small enough that the trace forces preempt-and-recompute evictions
TIGHT = dict(num_slots=3, page_size=2, pages_per_slot=14, num_pages=14, prefill_chunk=8)
STEP_METRICS = ("decode_steps", "prefill_steps", "idle_steps", "scheduled_decode_slots",
                "useful_decode_tokens", "prefill_scheduled_tokens", "prefill_useful_tokens",
                "evictions", "page_step_sum", "peak_used_pages", "prompt_tokens",
                "generated_tokens", "decode_lane_passes", "decode_emitted_tokens")


@pytest.fixture(scope="module")
def models():
    jmodel = jl.LlamaForCausalLM(jl.LlamaConfig.tiny(dtype=jnp.float32))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tmodel = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device="cpu")
    tmodel.load_state_dict(torch_state_from_flax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


def _serve_both(models, kernel, geometry, trace_kw, max_new=16):
    jmodel, params, tmodel = models
    jeng = JaxServingEngine(jmodel, params, JaxServingPlugin(**geometry, decode_kernel=kernel),
                            JaxGenerationConfig(max_new_tokens=max_new))
    jeng.warmup()
    jres = jeng.run(jax_synthesize_trace(**trace_kw))
    teng = ServingEngine(tmodel, ServingPlugin(**geometry, decode_kernel=kernel),
                         GenerationConfig(max_new_tokens=max_new), device="cpu")
    teng.warmup()
    tres = teng.run(synthesize_trace(**trace_kw))
    return jeng, jres, teng, tres


def _assert_same_serving(jeng, jres, teng, tres):
    assert tres == jres
    assert teng.sched.events == jeng.sched.events
    for key in STEP_METRICS:
        assert teng.metrics[key] == jeng.metrics[key], key
    assert teng.ttft_ticks == jeng.ttft_ticks
    assert teng.steps == jeng.steps
    assert teng.free_page_mirror_in_sync() and jeng.free_page_mirror_in_sync()
    np.testing.assert_array_equal(teng.cache["free_stack"].numpy(),
                                  np.asarray(jeng.cache["free_stack"]))


@pytest.mark.parametrize("kernel", ["flash", "native"])
@pytest.mark.parametrize("seed", [0, 1])
def test_engine_matches_jax_engine(models, kernel, seed):
    jeng, jres, teng, tres = _serve_both(models, kernel, GEOMETRY, dict(seed=seed, n_requests=6))
    assert len(tres) == 6
    _assert_same_serving(jeng, jres, teng, tres)
    assert tfa.paged_decode_attention.launches == 0      # CPU tensors: plain versions


def test_engine_matches_jax_engine_under_evictions(models):
    jeng, jres, teng, tres = _serve_both(
        models, "flash", TIGHT,
        dict(seed=2, n_requests=5, mean_interarrival_steps=0.5, prompt_len_range=(6, 12),
             new_tokens_range=(8, 14)))
    assert teng.metrics["evictions"] > 0
    _assert_same_serving(jeng, jres, teng, tres)


def test_trace_equals_jax_trace():
    kw = dict(vocab_size=32000, mean_interarrival_steps=0.5, prompt_len_range=(64, 512),
              new_tokens_range=(32, 256))
    assert synthesize_trace(0, 16, **kw) == [
        Request(r.uid, r.prompt, r.max_new_tokens, r.arrival_step)
        for r in jax_synthesize_trace(0, 16, **kw)]


def _ref_tokens(model, prompt, n):
    out = generate(model, np.asarray([prompt], np.int32), GenerationConfig(max_new_tokens=n))
    return [int(x) for x in out[0]]


@pytest.mark.parametrize("kernel", ["auto", "native"])
def test_engine_matches_generate(models, kernel):
    tmodel = models[2]
    eng = ServingEngine(tmodel, ServingPlugin(**GEOMETRY, decode_kernel=kernel),
                        GenerationConfig(max_new_tokens=5), device="cpu")
    assert eng.attn_implementation == ("flash" if kernel == "auto" else "native")
    prompts = [(5, 42, 7), (11, 3), (9, 8, 7, 6, 5, 4, 3, 2, 1)]
    for uid, p in enumerate(prompts):
        eng.add_request(Request(uid=uid, prompt=p, max_new_tokens=5))
    while not eng.idle():
        eng.step()
    for uid, p in enumerate(prompts):
        assert eng.results[uid] == _ref_tokens(tmodel, p, 5), uid
    assert eng.free_page_mirror_in_sync()


def test_chunked_prefill_matches_generate(models):
    """A prompt split across engine ticks (bucket-padded chunks) emits
    generate()'s tokens."""
    tmodel = models[2]
    rng = np.random.default_rng(3)
    prompt = tuple(int(x) for x in rng.integers(1, 255, 11))
    plugin = ServingPlugin(num_slots=2, page_size=4, pages_per_slot=8, num_pages=16,
                           prefill_chunk=4, prefill_buckets=(4,))
    eng = ServingEngine(tmodel, plugin, GenerationConfig(max_new_tokens=5), device="cpu")
    eng.add_request(Request(uid=0, prompt=prompt, max_new_tokens=5))
    while not eng.idle():
        eng.step()
    assert eng.results[0] == _ref_tokens(tmodel, prompt, 5)
    assert eng.metrics["prefill_steps"] == 3
    assert eng.free_page_mirror_in_sync()


def test_warmup_leaves_no_trace_and_replay_reports(models):
    tmodel = models[2]
    eng = ServingEngine(tmodel, ServingPlugin(**GEOMETRY), GenerationConfig(max_new_tokens=6),
                        device="cpu")
    eng.warmup()
    assert eng.steps == 0 and not eng.sched.events and not eng.results
    assert int(eng.cache["free_top"]) == GEOMETRY["num_pages"]
    assert not eng.cache["seq_lens"].any()
    trace = synthesize_trace(4, 5)
    rep = replay(eng, trace)
    assert rep["completed"] == rep["requests"] == 5
    assert rep["device"] == "cpu"
    assert rep["generated_tokens"] == sum(len(v) for v in eng.results.values())
    assert rep["tokens_per_sec"] > 0
    assert rep["p99_token_latency_ms"] >= rep["p50_token_latency_ms"] > 0
    with pytest.raises(RuntimeError, match="warmup"):
        eng.add_request(Request(uid=99, prompt=(1, 2), max_new_tokens=3))
        eng.step()
        eng.warmup()


def test_entry_points_need_a_card_unless_asked_for_cpu(models, monkeypatch):
    """No GPU and no explicit CPU request: the entry points raise rather
    than quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(models[2], ServingPlugin(**GEOMETRY))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(LlamaConfig.tiny())


@pytest.mark.parametrize("knob", [
    dict(speculate="ngram"), dict(prefix_cache="on"), dict(kv_dtype="int8"),
    dict(max_queue=4),
])
def test_later_slice_knobs_raise(models, knob):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServingEngine(models[2], ServingPlugin(**GEOMETRY, **knob), device="cpu")


def test_request_guards(models):
    eng = ServingEngine(models[2], ServingPlugin(**GEOMETRY), device="cpu")
    with pytest.raises(ValueError, match="empty prompt"):
        eng.add_request(Request(uid=0, prompt=(), max_new_tokens=2))
    with pytest.raises(ValueError, match="capacity"):
        eng.add_request(Request(uid=1, prompt=(1,) * 36, max_new_tokens=8))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.add_request(Request(uid=2, prompt=(1, 2), max_new_tokens=2, adapter_id=1))


@pytest.mark.parametrize("env", [
    {},
    {"ACCELERATE_SERVE_SLOTS": "5", "ACCELERATE_SERVE_PAGE_SIZE": "8",
     "ACCELERATE_SERVE_PAGES_PER_SLOT": "6", "ACCELERATE_SERVE_PREFILL_CHUNK": "48",
     "ACCELERATE_SERVE_KERNEL": "native", "ACCELERATE_SERVE_KV_DTYPE": "int8"},
])
def test_serving_plugin_matches_jax_fields_defaults_and_env(monkeypatch, env):
    import dataclasses

    for key, value in env.items():
        monkeypatch.setenv(key, value)
    port, ref = ServingPlugin(), JaxServingPlugin()
    assert [f.name for f in dataclasses.fields(port)] == [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    with pytest.raises(ValueError):
        ServingPlugin(decode_kernel="pallas")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax():
    """Neither the port nor its scripts for the card (chip_smoke.py,
    profile_serving.py) import JAX, Flax or the JAX package, not even a
    module of it that does not import JAX."""
    files = sorted((REPO / "accelerate_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "profile_serving.py", REPO / "profile_training.py"]
    assert len(files) > 10
    banned = ("jax", "jaxlib", "flax", "optax", "accelerate_tpu")
    for path in files:
        for mod in _imported_modules(path):
            root = mod.split(".")[0]
            assert root not in banned, f"{path.relative_to(REPO)} imports {mod}"
