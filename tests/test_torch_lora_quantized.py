"""Multi-tenant LoRA over an int8-quantized model, held against the JAX
package: JAX's ``quantize_params`` codes carried across bitwise
(``load_converted_state``) and JAX's adapters carried across
(``lora_tree_from_flax``); the adapters add after the W8A16 products on both
sides (JAX ``models/layers.py:118-127``).  A tiny model wide enough (hidden
128, intermediate 256) that q / o / gate / up / down take the W8A16
kernels' plain versions and k / v (64 wide) the dequantize fallback.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.generation import GenerationConfig as JaxGenerationConfig
from accelerate_tpu.models import llama as jl
from accelerate_tpu.ops import lora as jlora
from accelerate_tpu.serving import AdapterStore as JaxAdapterStore
from accelerate_tpu.serving import ServingEngine as JaxServingEngine
from accelerate_tpu.serving import synthesize_trace as jax_synthesize_trace
from accelerate_tpu.utils import quantization as jq
from accelerate_tpu.utils.dataclasses import LoraPlugin as JaxLoraPlugin
from accelerate_tpu.utils.dataclasses import ServingPlugin as JaxServingPlugin
from accelerate_tpu_torch import (
    AdapterStore,
    GenerationConfig,
    LlamaConfig,
    LlamaForCausalLM,
    LoraPlugin,
    ServingEngine,
    ServingPlugin,
    synthesize_trace,
)
from accelerate_tpu_torch.models.convert import (
    load_converted_state,
    lora_tree_from_flax,
    torch_state_from_flax,
)

BF16_STEP = 2.0 ** -8       # one bf16 rounding step, relative


@pytest.fixture(scope="module")
def qmodels():
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, hidden_size=128, intermediate_size=256)
    jmodel = jl.LlamaForCausalLM(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))
    qparams = jq.quantize_params(jax.tree.map(np.asarray, params),
                                 jq.QuantizationConfig(load_in_8bit=True))
    tmodel = load_converted_state(
        LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32, hidden_size=128,
                                          intermediate_size=256), device="cpu"),
        torch_state_from_flax(jax.tree.map(np.asarray, qparams)))
    return jmodel, params, qparams, tmodel


def test_lora_over_int8_quantized_model_matches_jax(qmodels):
    """LoRA on top of int8 weights (JAX ``quantize_params`` codes carried
    across): the q / v adapters add after the W8A16 product on both sides,
    mixed ids, three rows of 4 tokens (12 rows per dense, the tiled route on
    both sides).  Without adapters the logits agree to 1e-5; with them, the
    f32 LoRA sums (another order, ~1e-6 apart) can flip one bf16 rounding
    inside a later W8A16 product, which moves a logit by up to one bf16 step
    of the logits' scale: the tolerance is that step."""
    jmodel, params, qparams, tmodel = qmodels
    spec = jlora.lora_spec(params)
    jpool = jlora.init_lora_pool(spec, pool_slots=3, rank=4, dtype=jnp.float32)
    ad = jlora.init_adapter_params(jax.random.PRNGKey(3), spec, 4, init_b="normal",
                                   dtype=jnp.float32)
    jpool = jax.tree_util.tree_map(lambda p, a: p.at[1].set(a), jpool, ad)
    ids_in = np.random.default_rng(5).integers(1, 255, (3, 4)).astype(np.int32)
    want = jmodel.apply({**qparams, "lora": jpool}, jnp.asarray(ids_in),
                        adapter_ids=jnp.asarray([1, 0, 1], jnp.int32))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids_in), adapter_ids=torch.tensor([1, 0, 1]),
                     lora=lora_tree_from_flax(jax.tree.map(np.asarray, jpool)))
        base = tmodel(torch.from_numpy(ids_in))
    want_base = np.asarray(jmodel.apply(qparams, jnp.asarray(ids_in)))
    np.testing.assert_allclose(base.numpy(), want_base, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=BF16_STEP * np.abs(np.asarray(want)).max())
    assert torch.equal(got[1], base[1]) and not torch.equal(got[0], base[0])


def test_quantized_lora_engine_matches_jax_engine(qmodels):
    """int8 weights and int8 pages with adapters on a pool of 2: JAX's
    tokens, events and pool counters."""
    jmodel, params, qparams, tmodel = qmodels
    spec = jlora.lora_spec(params)
    jstore = JaxAdapterStore(params, JaxLoraPlugin(rank=4, pool_slots=2, kernel="native"))
    tstore = AdapterStore(tmodel, LoraPlugin(rank=4, pool_slots=2, kernel="native"))
    for t in (1, 2, 3):
        tree = jlora.init_adapter_params(jax.random.PRNGKey(100 + t), spec, 4, init_b="normal")
        jstore.publish(t, tree)
        tstore.publish(t, lora_tree_from_flax(jax.tree.map(np.asarray, tree)))
    geometry = dict(num_slots=4, page_size=4, pages_per_slot=10, num_pages=24, prefill_chunk=16,
                    kv_dtype="int8", decode_kernel="native")
    kw = dict(seed=3, n_requests=5, vocab_size=255, prompt_len_range=(3, 9),
              new_tokens_range=(3, 6), adapters=3)
    jeng = JaxServingEngine(jmodel, qparams, JaxServingPlugin(**geometry),
                            JaxGenerationConfig(max_new_tokens=6), adapters=jstore)
    jres = jeng.run(jax_synthesize_trace(**kw))
    teng = ServingEngine(tmodel, ServingPlugin(**geometry), GenerationConfig(max_new_tokens=6),
                         device="cpu", adapters=tstore)
    assert teng.run(synthesize_trace(**kw)) == jres
    assert teng.sched.events == jeng.sched.events
    assert (tstore.hits, tstore.swaps, tstore.swap_bytes) == \
        (jstore.hits, jstore.swaps, jstore.swap_bytes)
    assert any(e[0] == "swap" for e in teng.sched.events)
