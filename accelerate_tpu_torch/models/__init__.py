"""The port's models: the Llama family, for serving and training."""

from .convert import torch_state_from_flax
from .hf_interop import hf_llama_key_map, hf_llama_tensor_map
from .llama import (
    LlamaConfig,
    LlamaForCausalLM,
    causal_lm_loss,
    count_params,
    flops_per_token,
    init_cache,
    init_paged_cache,
    make_llama_loss_fn,
)

__all__ = [
    "LlamaConfig",
    "LlamaForCausalLM",
    "causal_lm_loss",
    "count_params",
    "flops_per_token",
    "hf_llama_key_map",
    "hf_llama_tensor_map",
    "init_cache",
    "init_paged_cache",
    "make_llama_loss_fn",
    "torch_state_from_flax",
]
