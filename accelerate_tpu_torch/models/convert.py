"""Carry a JAX Llama param tree into the port's parameters.

This is how the parity tests run both frameworks on the same weights: the
JAX package's tree (nested dicts of numpy arrays, ``params/layers_{i}/
self_attn/q_proj/kernel`` ``[in, out]`` ...) becomes a ``state_dict`` for
:class:`~accelerate_tpu_torch.models.llama.LlamaForCausalLM` — names through
:func:`~.hf_interop.hf_llama_key_map`, kernels transposed to ``[out, in]``
through :func:`~.hf_interop.hf_llama_tensor_map`.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .hf_interop import hf_llama_key_map, hf_llama_tensor_map

# JAX dot-path -> HF name: the inverse of hf_interop's rules.
_FLAX_TO_HF: list[tuple[str, str]] = [
    (r"^params\.embed_tokens\.embedding$", r"model.embed_tokens.weight"),
    (r"^params\.layers_(\d+)\.self_attn\.(q|k|v|o)_proj\.kernel$",
     r"model.layers.\1.self_attn.\2_proj.weight"),
    (r"^params\.layers_(\d+)\.mlp\.(gate|up|down)_proj\.kernel$",
     r"model.layers.\1.mlp.\2_proj.weight"),
    (r"^params\.layers_(\d+)\.(input_layernorm|post_attention_layernorm)\.scale$",
     r"model.layers.\1.\2.weight"),
    (r"^params\.norm\.scale$", r"model.norm.weight"),
    (r"^params\.lm_head\.kernel$", r"lm_head.weight"),
]


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def flax_to_hf_name(path: str) -> str:
    """JAX dot-path -> HF name; raises on a path the port has no place
    for."""
    for pattern, template in _FLAX_TO_HF:
        if re.match(pattern, path):
            name = re.sub(pattern, template, path)
            if hf_llama_key_map(name) != path:
                raise AssertionError(f"name maps disagree on {path!r}")
            return name
    raise KeyError(f"no port parameter for JAX param {path!r}")


def torch_state_from_flax(params) -> dict[str, torch.Tensor]:
    """A ``state_dict`` for the port's ``LlamaForCausalLM`` from a JAX
    Llama param tree (``{"params": {...}}`` of numpy-convertible arrays).
    Tensors come back f32 on the CPU; ``load_state_dict`` casts them to
    each parameter's dtype and device."""
    if "params" not in params:
        params = {"params": params}
    state = {}
    for path, leaf in _flatten(params):
        dotted = ".".join(path)
        arr = hf_llama_tensor_map("/".join(path), np.asarray(leaf, dtype=np.float32))
        state[flax_to_hf_name(dotted)] = torch.tensor(arr)
    return state
