"""The port's HF-format Llama loader (``models/hf_interop.py:load_hf_llama``)
held against the JAX package's and, where ``transformers`` imports, against
``transformers.LlamaForCausalLM``.

A tiny random HF Llama writes its ``state_dict`` as one safetensors file;
the port loads it into a ``meta`` model, JAX into its param tree.  Logits
on the same ids: the port's equal JAX's at 1e-5 and transformers' at 1e-4
(absolute and relative; JAX's own test holds transformers' at 2e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models import LlamaConfig as JLlamaConfig
from accelerate_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from accelerate_tpu.models.hf_interop import load_hf_llama as j_load_hf_llama
from accelerate_tpu_torch.big_modeling import abstract_init
from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM, load_hf_llama
from accelerate_tpu_torch.utils.serialization import save_safetensors

transformers = pytest.importorskip("transformers")

SHAPE = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)


def _hf_checkpoint(tmp_path, tied=False, keep_head=True):
    hf_cfg = transformers.LlamaConfig(**SHAPE, rms_norm_eps=1e-5, rope_theta=10000.0,
                                      tie_word_embeddings=tied, attention_bias=False)
    torch.manual_seed(0)
    hf_model = transformers.LlamaForCausalLM(hf_cfg).eval()
    state = {k: v.contiguous() for k, v in hf_model.state_dict().items()}
    if not keep_head:
        state.pop("lm_head.weight")
    path = tmp_path / "model.safetensors"
    save_safetensors(path, state)
    return hf_model, path


def _meta(**kw):
    return abstract_init(LlamaForCausalLM, LlamaConfig(**SHAPE, dtype=torch.float32, **kw),
                         device="cpu")


def test_load_hf_llama_logits_equal_jax_and_transformers(tmp_path):
    hf_model, path = _hf_checkpoint(tmp_path)
    model, store = load_hf_llama(_meta(), path, dtype=torch.float32, device="cpu")
    assert store is None
    ids = np.random.default_rng(0).integers(0, 256, (2, 12))
    with torch.no_grad():
        ours = model(torch.from_numpy(ids)).numpy()
        theirs = hf_model(torch.from_numpy(ids)).logits.numpy()
    j_model = JLlamaForCausalLM(JLlamaConfig(**SHAPE, dtype=jnp.float32))
    j_params, _ = j_load_hf_llama(j_model, path, dtype=jnp.float32)
    jax_logits = np.asarray(j_model.apply(j_params, jnp.asarray(ids, jnp.int32)))
    np.testing.assert_allclose(ours, jax_logits, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=1e-4)


def test_load_hf_llama_tied_skips_a_stored_head(tmp_path):
    """A tied model reuses the embedding: a stored ``lm_head.weight`` is
    skipped under strict, as in JAX."""
    hf_model, path = _hf_checkpoint(tmp_path, tied=True)
    model, _ = load_hf_llama(_meta(tie_word_embeddings=True), path, device="cpu")
    assert model.lm_head.weight is model.model.embed_tokens.weight
    ids = torch.randint(0, 256, (1, 9))
    with torch.no_grad():
        np.testing.assert_allclose(model(ids).numpy(), hf_model(ids).logits.numpy(),
                                   atol=1e-4, rtol=1e-4)


def test_load_hf_llama_targeted_error_without_a_head(tmp_path):
    _, path = _hf_checkpoint(tmp_path, keep_head=False)
    with pytest.raises(ValueError, match="tie_word_embeddings=True"):
        load_hf_llama(_meta(), path, device="cpu")
    with pytest.raises(ValueError, match="tie_word_embeddings=True"):
        j_load_hf_llama(JLlamaForCausalLM(JLlamaConfig(**SHAPE, dtype=jnp.float32)), path)
    model, _ = load_hf_llama(_meta(), path, device="cpu", strict=False)
    assert model.lm_head.weight.device.type == "meta"


def test_load_hf_llama_rejects_unexpected_names_under_strict(tmp_path):
    hf_model, _ = _hf_checkpoint(tmp_path)
    path = tmp_path / "extra.safetensors"
    save_safetensors(path, {**hf_model.state_dict(),
                            "model.layers.0.self_attn.rotary_emb.inv_freq": torch.ones(8),
                            "model.extra.weight": torch.ones(2)})
    with pytest.raises(ValueError, match="unexpected keys: \\['model.extra.weight'\\]"):
        load_hf_llama(_meta(), path, device="cpu")


def test_load_hf_llama_scan_layers_guard(tmp_path):
    class Scanned:
        class config:
            scan_layers = True

    with pytest.raises(ValueError, match="stack_layer_params"):
        load_hf_llama(Scanned(), tmp_path / "unused.safetensors")
