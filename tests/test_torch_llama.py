"""The port's Llama (``accelerate_tpu_torch/models/llama.py``) held against
the JAX package's on the same weights.

The JAX model's f32 param tree goes through ``torch_state_from_flax`` into
the port's ``LlamaForCausalLM``; both then see the same token ids.  f32
throughout, so the tolerance (1e-4) covers only summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.generation import GenerationConfig as JaxGenerationConfig
from accelerate_tpu.generation import generate as jax_generate
from accelerate_tpu.models import llama as jl
from accelerate_tpu_torch.generation import GenerationConfig, generate
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import flax_to_hf_name, torch_state_from_flax
from accelerate_tpu_torch.models.hf_interop import hf_llama_key_map

TOL = dict(atol=1e-4, rtol=1e-4)
IDS = np.asarray([[3, 17, 99, 4, 250, 7, 12, 63]], np.int32)


def _pair(attn="native"):
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, attn_implementation=attn)
    jmodel = jl.LlamaForCausalLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32, attn_implementation=attn)
    tmodel = tl.LlamaForCausalLM(tcfg, device="cpu")
    tmodel.load_state_dict(torch_state_from_flax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def pair():
    return _pair()


def test_state_from_flax_covers_every_parameter(pair):
    jmodel, params, tmodel = pair
    state = torch_state_from_flax(jax.tree.map(np.asarray, params))
    assert set(state) == set(tmodel.state_dict())
    q = state["model.layers.0.self_attn.q_proj.weight"]
    kernel = np.asarray(params["params"]["layers_0"]["self_attn"]["q_proj"]["kernel"])
    np.testing.assert_array_equal(q.numpy(), kernel.T)
    np.testing.assert_array_equal(state["lm_head.weight"].numpy(),
                                  np.asarray(params["params"]["lm_head"]["kernel"]).T)
    for name in state:
        assert flax_to_hf_name(hf_llama_key_map(name)) == name
    with pytest.raises(KeyError):
        flax_to_hf_name("params.layers_0.self_attn.q_proj.lora_a")


def test_uncached_logits_match_jax(pair):
    jmodel, params, tmodel = pair
    want = np.asarray(jmodel.apply(params, jnp.asarray(IDS)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(IDS).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_rmsnorm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    cos, sin = tl.rope_frequencies(16, 32, 10000.0)
    pos = rng.integers(0, 32, (2, 5)).astype(np.int32)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(pos))
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(cos), torch.from_numpy(sin),
                        torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    h = rng.normal(size=(3, 16)).astype(np.float32)
    norm = jl.RMSNorm(1e-5, jnp.float32)
    variables = {"params": {"scale": jnp.asarray(rng.normal(size=16), jnp.float32)}}
    want = norm.apply(variables, jnp.asarray(h))
    tnorm = tl.RMSNorm(16, 1e-5, torch.float32)
    tnorm.weight.data = torch.from_numpy(np.array(variables["params"]["scale"]))
    np.testing.assert_allclose(tnorm(torch.from_numpy(h)).detach().numpy(), np.asarray(want),
                               **TOL)


@pytest.mark.parametrize("attn", ["native", "flash"])
def test_paged_prefill_then_decode_matches_jax(attn):
    """Five tokens prefilled through the paged cache, then three decode
    steps, on both routes: ``native`` (gather + dense attention) and
    ``flash`` (the paged kernels: Pallas in interpret mode on the JAX side,
    the plain versions on the port's CPU side)."""
    jmodel, params, tmodel = _pair(attn)
    page_size, slots, pps, num_pages = 4, 1, 4, 8
    bt_np = np.asarray([[6, 1, 4, 3]], np.int32)

    jpc = jl.init_paged_cache(jmodel.config, num_pages, page_size, slots, pps)
    jlayers = [{"k_pages": l["k_pages"], "v_pages": l["v_pages"],
                "block_tables": jnp.asarray(bt_np)} for l in jpc["layers"]]
    tpc = tl.init_paged_cache(tmodel.config, num_pages, page_size, slots, pps, device="cpu")
    tlayers = [{"k_pages": l["k_pages"], "v_pages": l["v_pages"],
                "block_tables": torch.from_numpy(bt_np)} for l in tpc["layers"]]

    jlg, jlayers = jmodel.apply(params, jnp.asarray(IDS[:, :5]), positions=jnp.arange(5)[None],
                                cache=jlayers, cache_write_mask=jnp.ones((1, 5), bool))
    with torch.no_grad():
        tlg, tlayers = tmodel(torch.from_numpy(IDS[:, :5]).long(),
                              positions=torch.arange(5)[None], cache=tlayers,
                              cache_write_mask=torch.ones(1, 5, dtype=torch.bool))
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)
    for t in range(5, 8):
        jlayers = [{**l, "block_tables": jnp.asarray(bt_np)} for l in jlayers]
        jlg, jlayers = jmodel.apply(params, jnp.asarray(IDS[:, t:t + 1]),
                                    positions=jnp.asarray([[t]]), cache=jlayers,
                                    cache_write_mask=jnp.ones((1, 1), bool))
        with torch.no_grad():
            tlg, tlayers = tmodel(torch.from_numpy(IDS[:, t:t + 1]).long(),
                                  positions=torch.tensor([[t]]), cache=tlayers,
                                  cache_write_mask=torch.ones(1, 1, dtype=torch.bool))
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL, err_msg=f"step {t}")
    # the pages themselves were written to the same places
    for jl_, tl_ in zip(jlayers, tlayers):
        np.testing.assert_allclose(tl_["k_pages"].numpy(), np.asarray(jl_["k_pages"]), **TOL)


def test_paged_write_drops_masked_lanes_like_jax():
    """Masked lanes whose positions run past the block table clamp their
    lookup and write nowhere, on both sides."""
    jmodel, params, tmodel = _pair("native")
    page_size, pps, num_pages = 4, 2, 6
    bt_np = np.asarray([[5, 2]], np.int32)
    ids = IDS[:, :8]
    mask = np.asarray([[True] * 2 + [False] * 6])
    jpc = jl.init_paged_cache(jmodel.config, num_pages, page_size, 1, pps)
    jlayers = [{"k_pages": l["k_pages"], "v_pages": l["v_pages"],
                "block_tables": jnp.asarray(bt_np)} for l in jpc["layers"]]
    tpc = tl.init_paged_cache(tmodel.config, num_pages, page_size, 1, pps, device="cpu")
    tlayers = [{"k_pages": l["k_pages"], "v_pages": l["v_pages"],
                "block_tables": torch.from_numpy(bt_np)} for l in tpc["layers"]]
    pos = np.arange(6, 14, dtype=np.int32)[None]      # masked lanes 2.. run past 2 pages
    _, jlayers = jmodel.apply(params, jnp.asarray(ids), positions=jnp.asarray(pos),
                              cache=jlayers, cache_write_mask=jnp.asarray(mask))
    with torch.no_grad():
        _, tlayers = tmodel(torch.from_numpy(ids).long(), positions=torch.from_numpy(pos),
                            cache=tlayers, cache_write_mask=torch.from_numpy(mask))
    for jl_, tl_ in zip(jlayers, tlayers):
        np.testing.assert_allclose(tl_["v_pages"].numpy(), np.asarray(jl_["v_pages"]), **TOL)


def test_dense_cache_generate_matches_jax(pair):
    """``generate`` on the dense cache: variable-length prompts and EOS
    padding, greedy, token-identical to the JAX package's."""
    jmodel, params, tmodel = pair
    batch = np.asarray([[5, 42, 7, 9], [11, 3, 0, 0]], np.int32)
    lens = np.asarray([4, 2], np.int32)
    want = jax_generate(jmodel, params, jnp.asarray(batch),
                        JaxGenerationConfig(max_new_tokens=6, eos_token_id=2),
                        prompt_lengths=jnp.asarray(lens))
    got = generate(tmodel, batch, GenerationConfig(max_new_tokens=6, eos_token_id=2),
                   prompt_lengths=lens)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampling_is_seeded_and_filters():
    logits = torch.tensor([[0.0, 5.0, 1.0, 4.9], [3.0, 3.0, -1.0, 0.0]])
    greedy = GenerationConfig()
    from accelerate_tpu_torch.generation import sample_logits
    assert sample_logits(logits, None, greedy).tolist() == [1, 0]   # first index on ties
    cfg = GenerationConfig(do_sample=True, top_k=2, temperature=0.7)
    draws = [sample_logits(logits, torch.Generator().manual_seed(s), cfg) for s in range(20)]
    assert all(int(d[0]) in (1, 3) and int(d[1]) in (0, 1) for d in draws)
    again = sample_logits(logits, torch.Generator().manual_seed(3), cfg)
    assert torch.equal(again, draws[3])
    top_p = GenerationConfig(do_sample=True, top_p=0.0)
    assert sample_logits(logits, torch.Generator().manual_seed(0), top_p).tolist()[0] == 1


def test_bf16_model_gives_f32_logits():
    model = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(), device="cpu", seed=1)
    assert model.model.layers[0].self_attn.q_proj.weight.dtype == torch.bfloat16
    with torch.no_grad():
        logits = model(torch.from_numpy(IDS).long())
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()


def test_later_slice_options_raise():
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tl.init_paged_cache(cfg, 4, 4, 1, 4, kv_dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="ROADMAP"):
        tl.LlamaConfig.tiny(attn_implementation="ring")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tl.LlamaConfig.tiny(scan_layers=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tl.get_attention_impl("ulysses")
