"""The port's models: the Llama family on the serving path."""

from .convert import torch_state_from_flax
from .hf_interop import hf_llama_key_map, hf_llama_tensor_map
from .llama import (
    LlamaConfig,
    LlamaForCausalLM,
    init_cache,
    init_paged_cache,
)

__all__ = [
    "LlamaConfig",
    "LlamaForCausalLM",
    "hf_llama_key_map",
    "hf_llama_tensor_map",
    "init_cache",
    "init_paged_cache",
    "torch_state_from_flax",
]
