"""HF Llama ``state_dict`` names and tensor layout (mirrors the key and
tensor maps of ``accelerate_tpu/models/hf_interop.py``: ``hf_llama_key_map``
:57, ``hf_llama_tensor_map`` :71).

The port's :class:`~accelerate_tpu_torch.models.llama.LlamaForCausalLM`
uses the HF names themselves, so a HF checkpoint's tensors load as they
are; these maps relate those names to the JAX package's param paths, which
is what :mod:`.convert` needs to carry a JAX param tree across.
:func:`load_hf_llama` (JAX :79) streams a HF-format checkpoint file, index
or directory into the port's model.  The Mixtral, BERT and T5 loaders wait
for their models (ROADMAP A13 / A14).
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np

# (hf-name regex) -> JAX dot-path template.  Group refs use \1-style.
_LLAMA_RULES: list[tuple[str, str]] = [
    (r"^model\.embed_tokens\.weight$", r"params.embed_tokens.embedding"),
    (r"^model\.layers\.(\d+)\.self_attn\.(q|k|v|o)_proj\.weight$",
     r"params.layers_\1.self_attn.\2_proj.kernel"),
    (r"^model\.layers\.(\d+)\.mlp\.(gate|up|down)_proj\.weight$",
     r"params.layers_\1.mlp.\2_proj.kernel"),
    (r"^model\.layers\.(\d+)\.input_layernorm\.weight$",
     r"params.layers_\1.input_layernorm.scale"),
    (r"^model\.layers\.(\d+)\.post_attention_layernorm\.weight$",
     r"params.layers_\1.post_attention_layernorm.scale"),
    (r"^model\.norm\.weight$", r"params.norm.scale"),
    (r"^lm_head\.weight$", r"params.lm_head.kernel"),
    # the scanned stack (LlamaConfig.scan_layers): weights stacked on a
    # leading layer axis
    (r"^model\.layers_scan\.(block(?:_\d+)?)\.self_attn\.(q|k|v|o)_proj\.weight$",
     r"params.layers_scan.\1.self_attn.\2_proj.kernel"),
    (r"^model\.layers_scan\.(block(?:_\d+)?)\.mlp\.(gate|up|down)_proj\.weight$",
     r"params.layers_scan.\1.mlp.\2_proj.kernel"),
    (r"^model\.layers_scan\.(block(?:_\d+)?)\.(input_layernorm|post_attention_layernorm)"
     r"\.weight$", r"params.layers_scan.\1.\2.scale"),
]

# HF buffers with no parameter (recomputed from the config)
_SKIP = re.compile(r"rotary_emb\.inv_freq$")


def hf_llama_key_map(name: str) -> Optional[str]:
    """HF Llama ``state_dict`` name -> the JAX param path (dot-separated),
    or None for buffers that are skipped.  Unknown names pass through."""
    if _SKIP.search(name):
        return None
    for pattern, template in _LLAMA_RULES:
        if re.match(pattern, name):
            return re.sub(pattern, template, name)
    return name


def hf_llama_tensor_map(our_key: str, arr: np.ndarray) -> np.ndarray:
    """torch ``Linear.weight`` is ``[out, in]``; flax kernels are ``[in,
    out]`` (a scanned stack's ``[L, in, out]``: the last two axes swap).
    Embeddings and norm scales pass through.  The map is its own
    inverse."""
    if our_key.endswith("/kernel") and arr.ndim in (2, 3):
        return np.swapaxes(arr, -1, -2)
    return arr


def load_hf_llama(model, checkpoint, *, dtype=None, strict: bool = True, **kwargs):
    """Stream a HF-format Llama checkpoint (a safetensors file, an index of
    shards, or a directory) into ``model`` (built under
    ``big_modeling.init_empty_weights``), cast to ``dtype`` and tiered to
    pinned host memory or disk when over the card's budget: a thin wrapper
    over ``big_modeling.load_checkpoint_and_dispatch`` (its keyword
    arguments: ``device_map``, ``max_memory``, ``offload_folder``,
    ``device``, ``stats``).  The port's parameters carry HF's names and
    ``[out, in]`` layout, so tensors load as they are; rotary ``inv_freq``
    buffers are skipped, and so is a stored ``lm_head.weight`` when the
    model ties its head to the embedding.  Returns ``(model, store or
    None)``."""
    from ..big_modeling import load_checkpoint_and_dispatch

    if getattr(model.config, "scan_layers", False):
        raise ValueError(
            "load_hf_llama needs the unrolled layer stack (HF names map to "
            "model.layers.{i}); load with scan_layers=False, then convert via "
            "stack_layer_params(params, scan_block_size)")
    tied = getattr(model.config, "tie_word_embeddings", False)

    def key_map(name):
        if _SKIP.search(name) or (tied and name == "lm_head.weight"):
            return None
        return name

    try:
        return load_checkpoint_and_dispatch(model, checkpoint, dtype=dtype, strict=strict,
                                            key_map=key_map, **kwargs)
    except ValueError as e:
        if "missing" in str(e) and "lm_head" in str(e):
            raise ValueError(
                "This checkpoint stores no lm_head.weight — it was saved with "
                "tied word embeddings (tie_word_embeddings=True, e.g. "
                "TinyLlama/Gemma-style exports). Build the model with "
                "tie_word_embeddings=True so the head reuses embed_tokens, or "
                "pass strict=False to leave lm_head as it is."
            ) from e
        raise
