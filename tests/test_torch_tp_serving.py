"""Tensor-parallel serving and generation (``parallel.sharding.
bind_tp_slices``, the model's cached tp forward, the engine in a tp world)
held against the JAX package and the one-process port on the CPU.

Worlds: in-process virtual worlds of 2, 4 and 8 ranks
(``parallel/virtual.py``, what the card runs) and a gloo gang of 2 CPU
processes (``test_utils/scripts/tp_serving_checks.py``).  Every rank binds
its tp slices of the same f32 weights (a JAX tree carried across by
``torch_state_from_flax``) with the port's tp rules.

Tolerances: logits and hidden states at f32 1e-5 (other summation orders:
the row denses' partial sums meet in a ``psum``); tokens exactly; the
scheduler's event log and block tables exactly; a rank's K / V pages
against the one-process pool's head slice at 1e-5, int8 codes within one
step and scales at 1e-6 relative; the scanned stack's loss and
re-assembled gradients at 1e-5 relative (as
``test_torch_tensor_parallel.py``'s virtual world).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.generation import GenerationConfig as JaxGenerationConfig
from accelerate_tpu.generation import beam_search as jax_beam_search
from accelerate_tpu.generation import generate as jax_generate
from accelerate_tpu.models import llama as jl
from accelerate_tpu.ops import lora as jlora
from accelerate_tpu.serving import ServingEngine as JaxServingEngine
from accelerate_tpu.serving import synthesize_trace as jax_synthesize_trace
from accelerate_tpu.utils import quantization as jq
from accelerate_tpu.utils.dataclasses import ServingPlugin as JaxServingPlugin
from accelerate_tpu_torch import (
    GenerationConfig,
    LlamaConfig,
    LlamaForCausalLM,
    LoraPlugin,
    ServingEngine,
    ServingPlugin,
    beam_search,
    generate,
    generate_paged,
    make_llama_loss_fn,
    synthesize_trace,
)
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import (
    load_converted_state,
    lora_tree_from_flax,
    torch_state_from_flax,
)
from accelerate_tpu_torch.models.layers import DenseRoute
from accelerate_tpu_torch.ops import quantized_matmul as tqm
from accelerate_tpu_torch.ops.collective_matmul import collective_matmul
from accelerate_tpu_torch.parallel.sharding import (
    TRANSFORMER_TP_RULES,
    bind_tp_slices,
    held_bytes,
    make_sharding_plan,
    plan_bytes_per_device,
    tp_shard,
    tp_split_dim,
)
from accelerate_tpu_torch.parallel.virtual import VirtualMesh, module_replica
from accelerate_tpu_torch.parallelism_config import MESH_AXIS_ORDER, ParallelismConfig
from accelerate_tpu_torch.serving import AdapterStore, kv_pool_accounting, verify_serving_invariants
from accelerate_tpu_torch.test_utils.gang import run_gang

GEOMETRY = dict(num_slots=4, page_size=4, pages_per_slot=10, num_pages=24, prefill_chunk=8)
TRACE = dict(seed=0, n_requests=6)
QTRACE = dict(seed=3, n_requests=5, prompt_len_range=(3, 20), new_tokens_range=(4, 10))
PROMPTS = np.asarray([[5, 42, 7, 9], [11, 3, 8, 1]], np.int32)
# a prefill of 18 rows (#11's route) before the decode's 2 (#12's)
QPROMPTS = np.asarray([[5, 42, 7, 9, 60, 2, 77, 31, 4], [11, 3, 8, 1, 90, 14, 6, 250, 19]],
                      np.int32)
TARGETS = {"qv": ("q_proj", "v_proj"),
           "rows_and_head": ("q_proj", "o_proj", "down_proj", "lm_head")}
LORA_IDS = [0, 2, 0]
TOL = dict(rtol=1e-5, atol=1e-5)


def _world(tp: int, dp: int = 1):
    sizes = {"tp": tp, "dp_shard": dp}
    layout = tuple(sizes.get(a, 1) for a in MESH_AXIS_ORDER)
    return VirtualMesh(MESH_AXIS_ORDER, layout), ParallelismConfig(tp_size=tp, dp_shard_size=dp)


def _bound(model, tp: int, dp: int = 1):
    mesh, pcfg = _world(tp, dp)
    ranks = mesh.run(lambda r: bind_tp_slices(model), pcfg)
    return mesh, pcfg, ranks


@pytest.fixture(scope="module")
def tiny():
    jmodel = jl.LlamaForCausalLM(jl.LlamaConfig.tiny(dtype=jnp.float32))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tmodel = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32, attn_implementation="flash"),
                              device="cpu")
    tmodel.load_state_dict(torch_state_from_flax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def qtiny():
    """int8 weights with JAX's skips (embed, norm, bias, scale, lm_head) at
    widths whose every dense takes a W8A16 kernel route in one process
    (hidden 256, intermediate 512: k / v are 128 wide)."""
    kw = dict(hidden_size=256, intermediate_size=512)
    jmodel = jl.LlamaForCausalLM(jl.LlamaConfig.tiny(dtype=jnp.float32, **kw))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))
    qparams = jq.quantize_params(jax.tree.map(np.asarray, params), jq.QuantizationConfig(
        load_in_8bit=True, skip_patterns=("embed", "norm", "bias", "scale", "lm_head")))
    tmodel = load_converted_state(
        LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32, attn_implementation="flash", **kw),
                         device="cpu"),
        torch_state_from_flax(jax.tree.map(np.asarray, qparams)))
    return jmodel, qparams, tmodel


def _jax_pool(params, targets, slot=2, key=1):
    spec = jlora.lora_spec(params, targets)
    pool = jlora.init_lora_pool(spec, pool_slots=3, rank=4, dtype=jnp.float32)
    ad = jlora.init_adapter_params(jax.random.PRNGKey(key), spec, 4, init_b="normal",
                                   dtype=jnp.float32)
    return jax.tree_util.tree_map(lambda p, a: p.at[slot].set(a), pool, ad)


# ---------------------------------------------------------------------------
# C4: the tp LoRA forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("targets", sorted(TARGETS))
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_lora_forward_keeps_its_adapters(tiny, targets, tp):
    """C4: under tp the uncached forward carries ``adapter_ids`` / ``lora``
    into every dense and the vocab-sharded head, so a mixed-tenant batch's
    logits and ``output_hidden`` states are the one-process LoRA forward's
    and JAX's ``model.apply(..., adapter_ids=)`` (before the repair they
    were the base model's); id-0 rows are the rank's base output bitwise."""
    jmodel, params, tmodel = tiny
    jpool = _jax_pool(params, TARGETS[targets])
    pool = lora_tree_from_flax(jax.tree.map(np.asarray, jpool))
    ids_in = np.random.default_rng(0).integers(1, 255, (3, 8)).astype(np.int32)
    want = np.asarray(jmodel.apply({**params, "lora": jpool}, jnp.asarray(ids_in),
                                   adapter_ids=jnp.asarray(LORA_IDS, jnp.int32)))
    want_h = np.asarray(jmodel.apply({**params, "lora": jpool}, jnp.asarray(ids_in),
                                     adapter_ids=jnp.asarray(LORA_IDS, jnp.int32),
                                     output_hidden=True))
    x, slots = torch.from_numpy(ids_in), torch.tensor(LORA_IDS)
    with torch.no_grad():
        one = tmodel(x, adapter_ids=slots, lora=pool)
        one_h = tmodel(x, adapter_ids=slots, lora=pool, output_hidden=True)
        mesh, pcfg, ranks = _bound(tmodel, tp)
        got = mesh.run(lambda r: ranks[r](x, adapter_ids=slots, lora=pool), pcfg)
        got_h = mesh.run(lambda r: ranks[r](x, adapter_ids=slots, lora=pool,
                                            output_hidden=True), pcfg)
        base = mesh.run(lambda r: ranks[r](x), pcfg)
    for r in range(tp):
        np.testing.assert_allclose(got[r].numpy(), one.numpy(), **TOL)
        np.testing.assert_allclose(got[r].numpy(), want, **TOL)
        np.testing.assert_allclose(got_h[r].numpy(), one_h.numpy(), **TOL)
        np.testing.assert_allclose(got_h[r].numpy(), want_h, **TOL)
        assert torch.equal(got[r][0], base[r][0]) and torch.equal(got[r][2], base[r][2])
        assert (got[r][1] - base[r][1]).abs().max() > 1e-2


# ---------------------------------------------------------------------------
# binding a rank's slices
# ---------------------------------------------------------------------------


def test_bind_tp_slices_holds_the_rank_slices(tiny, qtiny, monkeypatch):
    """Each rank holds its tp slices (the plan's, on the port's names);
    the norms and the quantized codes and scales stay whole, shared with
    the source model; the rank's bytes are ``plan_bytes_per_device``'s.
    Outside a world the binding refuses."""
    tmodel = tiny[2]
    shapes = {n: (tuple(t.shape), t.dtype) for n, t in tmodel.state_dict().items()}
    for tp, dp in ((2, 1), (4, 2)):
        mesh, pcfg, ranks = _bound(tmodel, tp, dp)
        assert len(ranks) == tp * dp
        for r, bound in enumerate(ranks):
            i = r % tp
            p = "model.layers.0."
            q = bound.model.layers[0].self_attn.q_proj.weight
            assert tuple(q.shape) == (64 // tp, 64) and not q.requires_grad
            torch.testing.assert_close(q, tmodel.model.layers[0].self_attn.q_proj.weight[
                i * 64 // tp:(i + 1) * 64 // tp], rtol=0, atol=0)
            assert tuple(bound.model.layers[0].self_attn.o_proj.weight.shape) == (64, 64 // tp)
            assert tuple(bound.lm_head.weight.shape) == (256 // tp, 64)
            assert bound.model.norm.weight.data_ptr() == tmodel.model.norm.weight.data_ptr()
            assert bound.tp_plan[p + "mlp.down_proj.weight"][1] == "tp"
            assert held_bytes(bound) == plan_bytes_per_device(shapes, bound.tp_plan, mesh)
            assert held_bytes(bound) < held_bytes(tmodel)
    qmodel = qtiny[2]
    mesh, pcfg, ranks = _bound(qmodel, 2)
    qshapes = {n: (tuple(t.shape), t.dtype) for n, t in qmodel.state_dict().items()}
    for bound in ranks:
        dense, src = bound.model.layers[0].mlp.down_proj, qmodel.model.layers[0].mlp.down_proj
        assert dense.qcodes.data_ptr() == src.qcodes.data_ptr()
        assert tuple(bound.model.embed_tokens.weight.shape) == (128, 256)
        assert held_bytes(bound) == plan_bytes_per_device(qshapes, bound.tp_plan, mesh)
    from accelerate_tpu_torch import state

    # no world: an Accelerator of another test may have left its mesh ambient
    monkeypatch.setitem(state._AMBIENT, "mesh", None)
    with pytest.raises(ValueError, match="inside a world"):
        bind_tp_slices(tmodel)


# ---------------------------------------------------------------------------
# generate and beam_search
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", ["tp2", "dp2_tp4"])
def test_generate_and_beam_search_match_jax_in_tp_worlds(tiny, world):
    """``tests/test_generation.py:285``'s twin: ``generate``,
    ``beam_search`` and ``generate_paged`` on every rank of a tp 2 world and
    a dp_shard 2 x tp 4 world (tiny's 2 kv heads: at tp 4 each rank's cache
    holds the one its query head reads) give JAX's tokens on the same
    weights."""
    jmodel, params, tmodel = tiny
    jgc = JaxGenerationConfig(max_new_tokens=5)
    want = np.asarray(jax_generate(jmodel, params, jnp.asarray(PROMPTS), jgc))
    want_beam = np.asarray(jax_beam_search(jmodel, params, jnp.asarray(PROMPTS), jgc,
                                           num_beams=3))
    tp, dp = (2, 1) if world == "tp2" else (4, 2)
    mesh, pcfg, ranks = _bound(tmodel, tp, dp)
    gc = GenerationConfig(max_new_tokens=5)
    ids = torch.from_numpy(PROMPTS)
    assert mesh.run(lambda r: ranks[r].cache_kv_heads(), pcfg) == [2 // min(tp, 2)] * tp * dp
    got = mesh.run(lambda r: generate(ranks[r], ids, gc), pcfg)
    got_beam = mesh.run(lambda r: beam_search(ranks[r], ids, gc, num_beams=3), pcfg)
    paged = mesh.run(lambda r: generate_paged(ranks[r], ids, gc), pcfg)
    for r in range(tp * dp):
        np.testing.assert_array_equal(got[r].numpy(), want)
        np.testing.assert_array_equal(got_beam[r].numpy(), want_beam)
        np.testing.assert_array_equal(paged[r].numpy(), want)
    assert mesh.calls["all_gather_invariant"] > 0 and mesh.calls["psum"] > 0


def test_quantized_generate_matches_jax_in_tp2(qtiny, monkeypatch):
    """``tests/test_generation.py:313``'s twin in a tp 2 world: int8
    weights beside a vocab-sharded bf16 embedding and head decode JAX's
    quantized tokens.  Every quantized dense takes a kernel route (#11 /
    #12's plain versions here), as in one process: the column denses on
    their whole codes, the row denses on the rank's rows of the codes; no
    dequantize fallback runs."""
    jmodel, qparams, tmodel = qtiny
    jgc = JaxGenerationConfig(max_new_tokens=6)
    want = np.asarray(jax_generate(jmodel, qparams, jnp.asarray(QPROMPTS), jgc))
    want_beam = np.asarray(jax_beam_search(jmodel, qparams, jnp.asarray(QPROMPTS),
                                           JaxGenerationConfig(max_new_tokens=4), num_beams=3))
    routes = []
    route = tqm._route

    def spy(m, qt, wholef):
        routes.append((m, tuple(qt.shape), route(m, qt, wholef)))
        return routes[-1][2]

    def no_fallback(*a, **k):
        raise AssertionError("a quantized dense took the dequantize fallback")

    monkeypatch.setattr(tqm, "_route", spy)
    monkeypatch.setattr(tqm, "dequantize", no_fallback)
    mesh, pcfg, ranks = _bound(tmodel, 2)
    assert mesh.run(lambda r: ranks[r].tp_degree(), pcfg) == [2, 2]
    ids = torch.from_numpy(QPROMPTS)
    got = mesh.run(lambda r: generate(ranks[r], ids, GenerationConfig(max_new_tokens=6)), pcfg)
    got_beam = mesh.run(lambda r: beam_search(ranks[r], ids, GenerationConfig(max_new_tokens=4),
                                              num_beams=3), pcfg)
    for r in range(2):
        np.testing.assert_array_equal(got[r].numpy(), want)
        np.testing.assert_array_equal(got_beam[r].numpy(), want_beam)
    shapes = {s for _, s, _ in routes}
    assert (128, 256) in shapes and (256, 256) in shapes    # o_proj's and down_proj's rows
    assert {r for _, _, r in routes} == {"tiled", "wholef"}


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------


def _jax_engine(jmodel, params, geometry, trace_kw, max_new):
    jeng = JaxServingEngine(jmodel, params, JaxServingPlugin(**geometry, decode_kernel="flash"),
                            JaxGenerationConfig(max_new_tokens=max_new))
    jeng.warmup()
    return jeng, jeng.run(jax_synthesize_trace(**trace_kw))


ENGINE_CASES = {"tp2": (2, ""), "tp4": (4, ""), "int8_tp2": (2, "int8")}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_tp_engine_matches_jax_and_the_one_process_engine(tiny, qtiny, case):
    """The pattern of ``test_torch_serving.py:92`` in tp worlds (bf16 at tp
    2 and 4, int8 weights over int8 pages at tp 2): every rank's tokens are
    the JAX engine's; its event log and block tables are exactly the
    one-process engine's; its pools hold its kv heads only, ``1 / tp`` of
    the one-process pool where tp divides them, their pages the
    one-process pool's head slice; the serving contract holds on every
    rank after every tick."""
    tp, kv_dtype = ENGINE_CASES[case]
    jmodel, params, tmodel = qtiny if kv_dtype else tiny
    geometry = dict(GEOMETRY, kv_dtype=kv_dtype) if kv_dtype else GEOMETRY
    trace_kw, max_new = (QTRACE, 10) if kv_dtype else (TRACE, 16)
    _, jres = _jax_engine(jmodel, params, geometry, trace_kw, max_new)
    plugin = ServingPlugin(**geometry, decode_kernel="flash")
    one = ServingEngine(tmodel, plugin, GenerationConfig(max_new_tokens=max_new), device="cpu")
    one.warmup()
    one.run(synthesize_trace(**trace_kw))
    mesh, pcfg, ranks = _bound(tmodel, tp)

    def serve(r):
        eng = ServingEngine(ranks[r], plugin, GenerationConfig(max_new_tokens=max_new),
                            device="cpu")
        eng.warmup()
        problems = []
        pending = sorted(synthesize_trace(**trace_kw), key=lambda q: (q.arrival_step, q.uid))
        while pending or not eng.idle():
            while pending and pending[0].arrival_step <= eng.steps:
                eng.add_request(pending.pop(0))
            eng.step()
            problems += verify_serving_invariants(eng)
        return eng, problems

    out = mesh.run(serve, pcfg)
    hkv = tmodel.config.num_key_value_heads
    for r, (eng, problems) in enumerate(out):
        assert problems == []
        assert eng.results == jres == one.results
        assert eng.sched.events == one.sched.events
        assert torch.equal(eng.cache["block_tables"], one.cache["block_tables"])
        assert eng.steps == one.steps and eng.metrics == one.metrics
        _, _, kv0, kv1 = tl.rank_heads(tmodel.config, tp, r)
        assert eng.kv_heads == kv1 - kv0 == (hkv // tp if hkv % tp == 0 else 1)
        acc = kv_pool_accounting(tmodel.config, GEOMETRY["num_pages"], GEOMETRY["page_size"],
                                 4, kv_dtype, num_kv_heads=eng.kv_heads)
        held = sum(t.numel() * t.element_size() for layer in eng.cache["layers"]
                   for t in layer.values())
        whole = sum(t.numel() * t.element_size() for layer in one.cache["layers"]
                    for t in layer.values())
        assert held == acc["pool_bytes"] == whole * eng.kv_heads // hkv
        for mine, ref in zip(eng.cache["layers"], one.cache["layers"]):
            for key in ("k_pages", "v_pages"):
                got, want = mine[key], ref[key][kv0:kv1]
                if kv_dtype:
                    assert (got.float() - want.float()).abs().max() <= 1
                else:
                    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
            if kv_dtype:
                for key in ("k_scales", "v_scales"):
                    np.testing.assert_allclose(mine[key].numpy(), ref[key][kv0:kv1].numpy(),
                                               rtol=1e-6, atol=0)


def test_tp_lora_engine_matches_jax_and_base_rows_bitwise(tiny):
    """Multi-tenant LoRA serving under tp 2 (3 tenants on a pool of 2, the
    native LoRA route, as ``test_torch_adapters.py``'s JAX comparison):
    every rank's tokens, event log (swaps included) and store decisions are
    JAX's engine's and the one-process engine's (held to per-request
    serving by ``test_torch_adapters.py``); a cached decode step's id-0
    rows are the rank's base output bitwise."""
    from accelerate_tpu.serving import AdapterStore as JaxAdapterStore
    from accelerate_tpu.utils.dataclasses import LoraPlugin as JaxLoraPlugin

    jmodel, params, tmodel = tiny
    kw = dict(rank=4, pool_slots=2, kernel="native")
    spec = jlora.lora_spec(params)
    adapters = {t: jlora.init_adapter_params(jax.random.PRNGKey(100 + t), spec, 4,
                                             init_b="normal") for t in (1, 2, 3)}
    trace_kw = dict(seed=1, n_requests=8, adapters=3)
    plugin = ServingPlugin(**GEOMETRY, decode_kernel="flash")
    jstore = JaxAdapterStore(params, JaxLoraPlugin(**kw))
    for t, tree in adapters.items():
        jstore.publish(t, tree)
    jeng = JaxServingEngine(jmodel, params, JaxServingPlugin(**GEOMETRY, decode_kernel="flash"),
                            JaxGenerationConfig(max_new_tokens=12), adapters=jstore)
    jres = jeng.run(jax_synthesize_trace(**trace_kw))

    def store_of(model):
        store = AdapterStore(model, LoraPlugin(**kw))
        for t, tree in adapters.items():
            store.publish(t, lora_tree_from_flax(jax.tree.map(np.asarray, tree)))
        return store

    one = ServingEngine(tmodel, plugin, GenerationConfig(max_new_tokens=12), device="cpu",
                        adapters=store_of(tmodel))
    one.run(synthesize_trace(**trace_kw))
    mesh, pcfg, ranks = _bound(tmodel, 2)

    def serve(r):
        eng = ServingEngine(ranks[r], plugin, GenerationConfig(max_new_tokens=12),
                            device="cpu", adapters=store_of(ranks[r]))
        eng.run(synthesize_trace(**trace_kw))
        return eng

    engines = mesh.run(serve, pcfg)
    assert one.adapters.swaps > 2 and one.results == jres
    assert one.sched.events == jeng.sched.events
    for eng in engines:
        assert eng.results == jres and eng.sched.events == one.sched.events
        assert eng.adapters.slot_of == one.adapters.slot_of == jeng.adapters.slot_of
        assert (eng.adapters.swaps, eng.adapters.hits) == (one.adapters.swaps, one.adapters.hits)
        assert verify_serving_invariants(eng) == []

    ids = torch.from_numpy(np.random.default_rng(4).integers(1, 255, (3, 6)))
    store = store_of(tmodel)
    store.pin(2)

    def step(r, slots):
        cache = tl.init_cache(tmodel.config, 3, 8, device="cpu",
                              num_kv_heads=ranks[r].cache_kv_heads())
        kw = {} if slots is None else dict(adapter_ids=torch.tensor(slots), lora=store.pool)
        with torch.no_grad():
            ranks[r](ids, cache=cache, **kw)
            return ranks[r](ids[:, :1], positions=torch.full((3, 1), 6), cache=cache, **kw)[0]

    mixed = mesh.run(lambda r: step(r, [0, 1, 0]), pcfg)
    base = mesh.run(lambda r: step(r, None), pcfg)
    for r in range(2):
        assert torch.equal(mixed[r][0], base[r][0]) and torch.equal(mixed[r][2], base[r][2])
        assert not torch.equal(mixed[r][1], base[r][1])


# ---------------------------------------------------------------------------
# the gloo gang
# ---------------------------------------------------------------------------


def test_gloo_gang_serves_and_generates_as_jax(tiny, tmp_path):
    """A gloo world of 2 processes, each binding its slices and releasing
    the whole model: the LoRA forward (C4), ``generate``, ``beam_search``
    and the engine give JAX's numbers and tokens, every rank the same
    event log and block tables, each pool its kv head."""
    jmodel, params, tmodel = tiny
    torch.save(torch_state_from_flax(jax.tree.map(np.asarray, params)), tmp_path / "tiny.pt")
    jpool = _jax_pool(params, TARGETS["rows_and_head"])
    pool = {k: {f: t.numpy() for f, t in fac.items()}
            for k, fac in lora_tree_from_flax(jax.tree.map(np.asarray, jpool)).items()}
    ids_in = np.random.default_rng(0).integers(1, 255, (3, 8)).astype(np.int32)
    trace = [(r.uid, r.prompt, r.max_new_tokens, r.arrival_step)
             for r in synthesize_trace(**TRACE)]
    reps = run_gang("accelerate_tpu_torch.test_utils.scripts.tp_serving_checks:tp_pair", 2,
                    tmp_path / "gang", timeout=120, state_path=str(tmp_path / "tiny.pt"),
                    lora_pool=pool, lora_ids=LORA_IDS, prompts=ids_in, trace=trace,
                    geometry=GEOMETRY, max_new=5, beams=3)
    want = np.asarray(jmodel.apply({**params, "lora": jpool}, jnp.asarray(ids_in),
                                   adapter_ids=jnp.asarray(LORA_IDS, jnp.int32)))
    want_h = np.asarray(jmodel.apply({**params, "lora": jpool}, jnp.asarray(ids_in),
                                     adapter_ids=jnp.asarray(LORA_IDS, jnp.int32),
                                     output_hidden=True))
    jgc = JaxGenerationConfig(max_new_tokens=5)
    want_gen = np.asarray(jax_generate(jmodel, params, jnp.asarray(ids_in), jgc))
    want_beam = np.asarray(jax_beam_search(jmodel, params, jnp.asarray(ids_in), jgc,
                                           num_beams=3))
    _, jres = _jax_engine(jmodel, params, GEOMETRY, TRACE, 16)
    for rep in reps:
        np.testing.assert_allclose(rep["lora_logits"], want, **TOL)
        np.testing.assert_allclose(rep["lora_hidden"], want_h, **TOL)
        np.testing.assert_array_equal(rep["generate"], want_gen)
        np.testing.assert_array_equal(rep["beam_search"], want_beam)
        assert rep["results"] == jres and rep["invariants"] == []
        assert rep["events"] == reps[0]["events"]
        np.testing.assert_array_equal(rep["block_tables"], reps[0]["block_tables"])
        assert rep["kv_heads"] == 1 and rep["k_pages"].shape[1] == 1
        assert rep["held_bytes"] < rep["whole_bytes"]


# ---------------------------------------------------------------------------
# the scanned stack under tp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
def test_scanned_stack_under_tp_matches_one_process_and_jax(tiny, tp):
    """Each scan slice takes its tp slices of the stacked weights (the
    plan's rule offset by the leading axis): in each collective-matmul
    mode the virtual world's loss and re-assembled gradients are the
    one-process scanned step's at 1e-5, its loss JAX's ``scan_layers=True``
    forward's; the scanned model also generates JAX's tokens under tp."""
    jmodel, params, _ = tiny
    jscan = jl.LlamaForCausalLM(jl.LlamaConfig.tiny(dtype=jnp.float32, scan_layers=True))
    jstacked = jl.stack_layer_params(params)
    ids_np = np.random.default_rng(3).integers(0, 256, (4, 32)).astype(np.int32)
    jloss = float(jl.make_llama_loss_fn(jscan)(jstacked, {"input_ids": jnp.asarray(ids_np),
                                                          "labels": jnp.asarray(ids_np)}))
    cfg = LlamaConfig.tiny(dtype=torch.float32, attn_implementation="flash", scan_layers=True)
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(torch_state_from_flax(jax.tree.map(np.asarray, jstacked)))
    full = {n: p.detach().clone() for n, p in model.named_parameters()}
    ids = torch.from_numpy(ids_np).long()
    batch = {"input_ids": ids, "labels": ids}
    ref_p = {n: t.clone().requires_grad_() for n, t in full.items()}
    ref_loss = make_llama_loss_fn(model, fused_vocab_chunks=4)(ref_p, batch)
    ref_loss.backward()
    np.testing.assert_allclose(ref_loss.item(), jloss, rtol=1e-5)
    mesh, pcfg = _world(tp)
    plan = make_sharding_plan(full, mesh, pcfg, None, TRANSFORMER_TP_RULES)
    assert tp_split_dim(plan["model.layers_scan.block.self_attn.q_proj.weight"]) == 1
    for mode in ("off", "ring"):
        reps = [module_replica(model) for _ in range(tp)]
        shards = [{n: tp_shard(t, tp_split_dim(plan[n]), tp, r).clone().requires_grad_()
                   for n, t in full.items()} for r in range(tp)]
        with collective_matmul(mode):
            losses = mesh.run(lambda r: make_llama_loss_fn(reps[r], fused_vocab_chunks=4)(
                shards[r], batch), pcfg)
        torch.autograd.backward(losses)
        for loss in losses:
            np.testing.assert_allclose(loss.item(), ref_loss.item(), rtol=1e-5)
        for n, t in full.items():
            d = tp_split_dim(plan[n])
            g = torch.cat([s[n].grad for s in shards], dim=d) if d is not None \
                else shards[0][n].grad
            scale = ref_p[n].grad.abs().max().item()
            np.testing.assert_allclose(g.numpy(), ref_p[n].grad.numpy(), rtol=0,
                                       atol=1e-5 * scale, err_msg=f"{mode} {n}")
        if mode == "ring":
            assert mesh.calls["ppermute"] > 0
    ranks = mesh.run(lambda r: bind_tp_slices(model), pcfg)
    got = mesh.run(lambda r: generate(ranks[r], torch.from_numpy(PROMPTS),
                                      GenerationConfig(max_new_tokens=5)), pcfg)
    want = np.asarray(jax_generate(jmodel, params, jnp.asarray(PROMPTS),
                                   JaxGenerationConfig(max_new_tokens=5)))
    for g in got:
        np.testing.assert_array_equal(g.numpy(), want)


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------


GUARDS = ("speculate", "prefix_cache", "attach_slo", "ladder", "transfer", "router",
          "uneven_heads", "ring_lora_dense")


@pytest.mark.parametrize("guard", GUARDS)
def test_tp_refusals_name_their_roadmap_item(tiny, guard):
    """What the tp engine does not port raises ``NotImplementedError``
    naming A13h.7, never degrading silently: speculation, the prefix
    cache, the overload ladder (an SLO monitor, an escalation), KV page
    transfer, the router; cached decoding where tp splits the query heads
    unevenly; a LoRA or quantized dense handed a ring route."""
    from accelerate_tpu_torch.serving.router import FleetRouter
    from accelerate_tpu_torch.serving.transfer import PagedKVTransport
    from accelerate_tpu_torch.telemetry import SLOMonitor

    tmodel = tiny[2]
    mesh, pcfg, ranks = _bound(tmodel, 2)
    plugin = ServingPlugin(**GEOMETRY)

    def attempt(r):
        eng = lambda **kw: ServingEngine(ranks[r], dataclasses.replace(plugin, **kw),  # noqa: E731
                                         device="cpu")
        if guard == "speculate":
            eng(speculate="ngram")
        elif guard == "prefix_cache":
            eng(prefix_cache="on")
        elif guard == "attach_slo":
            monitor = SLOMonitor({"ttft_s": {"p50_trip": 0.0}})
            eng().attach_slo(monitor)
            monitor.observe("ttft_s", 1.0)      # the trip escalates the ladder
        elif guard == "ladder":
            eng().ladder.escalate()
        elif guard == "transfer":
            PagedKVTransport(eng(), eng())
        elif guard == "router":
            FleetRouter([eng()])
        elif guard == "uneven_heads":
            tl.rank_heads(LlamaConfig.tiny(num_attention_heads=4, num_key_value_heads=4), 8, r)
        else:
            dense = ranks[r].model.layers[0].self_attn.q_proj
            pool = {dense.lora_key: {"a": torch.zeros(2, 64, 4), "b": torch.zeros(2, 4, 64)}}
            dense(torch.zeros(1, 2, 64), torch.tensor([1]), pool,
                  route=DenseRoute(mesh, "tp", "ring"))

    with pytest.raises(NotImplementedError, match="A13h.7"):
        mesh.run(attempt, pcfg)
