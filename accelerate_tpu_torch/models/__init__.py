"""The port's models: the Llama family, for serving and training; the
Mixtral MoE family; BERT and ResNet, the models of the examples."""

from .bert import BertConfig, BertForSequenceClassification, make_bert_loss_fn
from .convert import (
    load_converted_state,
    lora_tree_from_flax,
    torch_state_from_flax,
    torch_state_from_flax_bert,
    torch_state_from_flax_resnet,
)
from .hf_interop import (
    hf_bert_key_map,
    hf_llama_key_map,
    hf_llama_tensor_map,
    hf_mixtral_key_map,
    load_hf_bert,
    load_hf_llama,
    load_hf_mixtral,
)
from .llama import (
    LlamaConfig,
    LlamaForCausalLM,
    causal_lm_loss,
    count_params,
    flops_per_token,
    dequantize_kv_pages,
    init_cache,
    init_paged_cache,
    make_llama_loss_fn,
    paged_write_kv_quantized,
    resolve_kv_dtype,
    stack_layer_params,
    unstack_layer_params,
)
from .mixtral import (
    MixtralConfig,
    MixtralForCausalLM,
    count_active_params,
    make_mixtral_loss_fn,
)
from .resnet import ResNet, ResNetConfig, make_resnet_loss_fn

__all__ = [
    "BertConfig",
    "BertForSequenceClassification",
    "ResNet",
    "ResNetConfig",
    "hf_bert_key_map",
    "load_hf_bert",
    "make_bert_loss_fn",
    "make_resnet_loss_fn",
    "torch_state_from_flax_bert",
    "torch_state_from_flax_resnet",
    "LlamaConfig",
    "LlamaForCausalLM",
    "MixtralConfig",
    "MixtralForCausalLM",
    "count_active_params",
    "hf_mixtral_key_map",
    "load_hf_mixtral",
    "make_mixtral_loss_fn",
    "causal_lm_loss",
    "count_params",
    "dequantize_kv_pages",
    "flops_per_token",
    "hf_llama_key_map",
    "hf_llama_tensor_map",
    "init_cache",
    "init_paged_cache",
    "load_converted_state",
    "load_hf_llama",
    "lora_tree_from_flax",
    "make_llama_loss_fn",
    "paged_write_kv_quantized",
    "resolve_kv_dtype",
    "stack_layer_params",
    "torch_state_from_flax",
    "unstack_layer_params",
]
