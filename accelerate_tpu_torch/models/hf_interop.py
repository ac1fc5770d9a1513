"""HF Llama ``state_dict`` names and tensor layout (mirrors the key and
tensor maps of ``accelerate_tpu/models/hf_interop.py``: ``hf_llama_key_map``
:57, ``hf_llama_tensor_map`` :71).

The port's :class:`~accelerate_tpu_torch.models.llama.LlamaForCausalLM`
uses the HF names themselves, so a HF checkpoint's tensors load as they
are; these maps relate those names to the JAX package's param paths, which
is what :mod:`.convert` needs to carry a JAX param tree across.  Loading
checkpoint files (``load_hf_llama``) is not ported.
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
    out]``.  Embeddings and norm scales pass through.  The map is its own
    inverse."""
    if our_key.endswith("/kernel") and arr.ndim == 2:
        return arr.T
    return arr
