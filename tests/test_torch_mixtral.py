"""The port's Mixtral (``accelerate_tpu_torch/models/mixtral.py``) held
against the JAX package's ``MixtralForCausalLM``: the forward's logits,
the loss with the router's aux and z losses (and its gradients, to the
router and the experts), the scanned stack (JAX ``tests/test_models.py:
531``), ``generate`` through the dense cache (JAX ``tests/
test_generation.py:138``), the bf16 experts, the active-parameter count,
and ``load_hf_mixtral`` against transformers' Mixtral and JAX's loader on
a tiny random checkpoint (JAX ``tests/test_hf_interop.py:199-262``).

Both frameworks run ``MixtralConfig.tiny()`` on the same weights (a JAX
param tree through ``models/convert.py``) and the same numpy tokens.
Tolerances: f32 logits and loss at 1e-5, gradients at 1e-5 relative per
leaf (f32, other summation orders), the scanned stack at JAX's own 2e-5,
tokens equal, the HF logits at JAX's 5e-4 (transformers' drop-free
routing, capacity raised until none drop), bf16 at 2e-2 of the largest
logit (JAX casts its f32 experts to bf16 at use; the port stores them
bf16: the same values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models import MixtralConfig as JMixtralConfig
from accelerate_tpu.models import MixtralForCausalLM as JMixtral
from accelerate_tpu.models.llama import stack_layer_params as j_stack_layer_params
from accelerate_tpu.models.mixtral import count_active_params as j_count_active_params
from accelerate_tpu.models.mixtral import make_mixtral_loss_fn as j_mixtral_loss
from accelerate_tpu_torch import generation as tgen
from accelerate_tpu_torch.big_modeling import abstract_init
from accelerate_tpu_torch.models import (
    MixtralConfig,
    MixtralForCausalLM,
    load_hf_mixtral,
    make_mixtral_loss_fn,
    stack_layer_params,
)
from accelerate_tpu_torch.models.convert import torch_state_from_flax
from accelerate_tpu_torch.models.hf_interop import _stack_expert_stream, hf_mixtral_key_map
from accelerate_tpu_torch.models.mixtral import collect_router_losses, count_active_params

IDS = np.random.default_rng(0).integers(0, 256, (2, 32)).astype(np.int32)


@pytest.fixture(scope="module")
def pair():
    model_j = JMixtral(JMixtralConfig.tiny(dtype=jnp.float32))
    params = model_j.init(jax.random.key(0), jnp.asarray(IDS))
    params = jax.tree.map(lambda x: np.array(x, copy=True), params)
    model_t = MixtralForCausalLM(MixtralConfig.tiny(dtype=torch.float32), device="cpu")
    model_t.load_state_dict(torch_state_from_flax(params))
    return model_j, params, model_t


def test_forward_shape_and_logits_match_jax(pair):
    model_j, params, model_t = pair
    with torch.no_grad():
        got = model_t(torch.from_numpy(IDS).long())
    assert got.shape == (2, 32, 256) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    want = np.asarray(model_j.apply(params, jnp.asarray(IDS)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_expert_params_stacked(pair):
    _, _, model_t = pair
    moe = model_t.model.layers[0].block_sparse_moe
    assert tuple(moe.experts.gate_proj.shape) == (4, 64, 128)
    assert tuple(moe.experts.up_proj.shape) == (4, 64, 128)
    assert tuple(moe.experts.down_proj.shape) == (4, 128, 64)
    assert tuple(moe.gate.weight.shape) == (4, 64) and moe.gate.weight.dtype == torch.float32


def test_loss_with_router_losses_matches_jax(pair):
    """The causal-LM loss plus 0.02 x mean aux + 1e-3 x mean z over the
    layers equals JAX's sown-loss sum; the gradients flow to the router and
    the experts and equal JAX's."""
    model_j, params, model_t = pair
    batch_j = {"input_ids": jnp.asarray(IDS), "labels": jnp.asarray(IDS)}
    j_loss, j_grads = jax.value_and_grad(j_mixtral_loss(model_j))(params, batch_j)
    ids = torch.from_numpy(IDS).long()
    leaves = {n: p.detach().clone().requires_grad_() for n, p in model_t.named_parameters()}
    loss = make_mixtral_loss_fn(model_t)(leaves, {"input_ids": ids, "labels": ids})
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    loss.backward()
    want = torch_state_from_flax(jax.tree.map(np.asarray, j_grads))
    for n, p in leaves.items():
        err = (p.grad - want[n]).norm() / want[n].norm().clamp(min=1e-30)
        assert err.item() <= 1e-5, n
    g_router = leaves["model.layers.0.block_sparse_moe.gate.weight"].grad
    g_expert = leaves["model.layers.0.block_sparse_moe.experts.gate_proj"].grad
    assert g_router.abs().max() > 0 and g_expert.abs().max() > 0
    with collect_router_losses() as sown, torch.no_grad():
        model_t(ids)
    assert len(sown["router_aux_loss"]) == len(sown["router_z_loss"]) == 2
    assert all(torch.isfinite(x) for x in sown["router_aux_loss"] + sown["router_z_loss"])


def test_scan_layers_parity(pair):
    """The scanned stack runs Mixtral blocks (the block-class hook): its
    logits equal the unrolled model's and JAX's scanned model's."""
    model_j, params, model_t = pair
    scanned = MixtralForCausalLM(MixtralConfig.tiny(dtype=torch.float32, scan_layers=True),
                                 device="cpu")
    scanned.load_state_dict(stack_layer_params(dict(model_t.state_dict())))
    ids = IDS[:, :16]
    with torch.no_grad():
        got = scanned(torch.from_numpy(ids).long()).numpy()
        flat = model_t(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, flat, rtol=2e-5, atol=2e-5)
    sm = JMixtral(JMixtralConfig.tiny(dtype=jnp.float32, scan_layers=True))
    want = np.asarray(sm.apply(j_stack_layer_params(params), jnp.asarray(ids)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_generate_through_the_dense_cache(pair):
    """The cache threads through the Mixtral block: greedy tokens equal a
    greedy loop over JAX's uncached forward (at most 8 tokens of one row:
    no expert reaches its capacity of 8, so routing drops nothing either
    way).  JAX's cached Mixtral decode hands the Llama block's adapter
    argument to a Mixtral block, which takes none (its test is marked
    slow), so the uncached forward is the reference."""
    model_j, params, model_t = pair
    prompt = np.asarray([[1, 2, 3]], np.int32)
    got = tgen.generate(model_t, torch.from_numpy(prompt), tgen.GenerationConfig(
        max_new_tokens=4))
    assert tuple(got.shape) == (1, 4) and got.dtype == torch.int32
    seq = prompt
    for _ in range(4):
        logits = np.asarray(model_j.apply(params, jnp.asarray(seq)))
        seq = np.concatenate([seq, logits[:, -1].argmax(-1)[:, None].astype(np.int32)], axis=1)
    np.testing.assert_array_equal(got.numpy(), seq[:, 3:])


def test_bf16_experts_hold_jax_values(pair):
    """The port stores the experts in bf16 (JAX: f32, cast at use): the
    stored values are JAX's rounded once, and the bf16 forward agrees with
    JAX's bf16 forward."""
    model_j, params, _ = pair
    model_b = MixtralForCausalLM(MixtralConfig.tiny(), device="cpu")
    model_b.load_state_dict(torch_state_from_flax(params))
    w = model_b.model.layers[0].block_sparse_moe.experts.gate_proj
    assert w.dtype == torch.bfloat16
    src = params["params"]["layers_0"]["block_sparse_moe"]["experts"]["gate_proj"]
    np.testing.assert_array_equal(w.detach().float().numpy(),
                                  np.asarray(jnp.asarray(src).astype(jnp.bfloat16), np.float32))
    assert model_b.model.layers[0].block_sparse_moe.gate.weight.dtype == torch.float32
    with torch.no_grad():
        got = model_b(torch.from_numpy(IDS).long()).numpy()
    want = np.asarray(JMixtral(JMixtralConfig.tiny()).apply(params, jnp.asarray(IDS)))
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_count_active_params():
    for kw in ({}, {"tie_word_embeddings": True}):
        assert count_active_params(MixtralConfig.tiny(**kw)) == j_count_active_params(
            JMixtralConfig.tiny(**kw))
    assert count_active_params(MixtralConfig.mixtral_8x7b()) == j_count_active_params(
        JMixtralConfig.mixtral_8x7b())


def test_stack_expert_stream_raises_on_incomplete_groups():
    """Per-expert tensors stack as they arrive ([E, in, out], the synthetic
    name the key map knows); a group still missing an expert at the end
    raises, naming it."""
    w = {e: torch.full((6, 4), float(e)) for e in range(3)}
    stream = [(f"model.layers.0.block_sparse_moe.experts.{e}.w1.weight", w[e]) for e in range(3)]
    stream.append(("model.norm.weight", torch.ones(4)))
    out = list(_stack_expert_stream(stream, 3))
    assert out[0][0] == "model.layers.0.block_sparse_moe.experts_stacked.gate_proj"
    assert tuple(out[0][1].shape) == (3, 4, 6) and out[0][1][2].eq(2.0).all()
    assert hf_mixtral_key_map(out[0][0]) == "params.layers_0.block_sparse_moe.experts.gate_proj"
    with pytest.raises(ValueError, match="incomplete expert groups"):
        list(_stack_expert_stream(stream[:2], 3))


HF_SHAPE = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
                num_experts_per_tok=2, max_position_embeddings=128)


def test_load_hf_mixtral_matches_transformers_and_jax(tmp_path):
    """A tiny random HF Mixtral checkpoint: the port's streamed, stacked
    load gives transformers' logits (capacity high enough that nothing
    drops, HF's routing) and JAX's loader's."""
    transformers = pytest.importorskip("transformers")
    from accelerate_tpu.models.hf_interop import load_hf_mixtral as j_load_hf_mixtral
    from accelerate_tpu_torch.utils.serialization import save_safetensors

    hf_cfg = transformers.MixtralConfig(**HF_SHAPE, rms_norm_eps=1e-5, rope_theta=10000.0,
                                        tie_word_embeddings=False)
    torch.manual_seed(1)
    hf_model = transformers.MixtralForCausalLM(hf_cfg).eval()
    path = tmp_path / "model.safetensors"
    save_safetensors(path, {k: v.contiguous() for k, v in hf_model.state_dict().items()})
    model, store = load_hf_mixtral(
        abstract_init(MixtralForCausalLM, MixtralConfig(**HF_SHAPE, capacity_factor=8.0,
                                                        dtype=torch.float32), device="cpu"),
        path, dtype=torch.float32, device="cpu")
    assert store is None
    ids = np.random.default_rng(1).integers(0, 256, (2, 12))
    with torch.no_grad():
        ours = model(torch.from_numpy(ids)).numpy()
        theirs = hf_model(torch.from_numpy(ids)).logits.numpy()
    np.testing.assert_allclose(ours, theirs, rtol=5e-4, atol=5e-4)
    j_model = JMixtral(JMixtralConfig(**HF_SHAPE, capacity_factor=8.0, dtype=jnp.float32))
    j_params, _ = j_load_hf_mixtral(j_model, path, dtype=jnp.float32)
    want = np.asarray(j_model.apply(j_params, jnp.asarray(ids, jnp.int32)))
    np.testing.assert_allclose(ours, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="stack_layer_params"):
        load_hf_mixtral(MixtralForCausalLM(MixtralConfig.tiny(scan_layers=True), device="meta"),
                        path)
