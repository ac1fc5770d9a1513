"""HF Llama ``state_dict`` names and tensor layout (mirrors the key and
tensor maps of ``accelerate_tpu/models/hf_interop.py``: ``hf_llama_key_map``
:57, ``hf_llama_tensor_map`` :71).

The port's :class:`~accelerate_tpu_torch.models.llama.LlamaForCausalLM`
uses the HF names themselves, so a HF checkpoint's tensors load as they
are; these maps relate those names to the JAX package's param paths, which
is what :mod:`.convert` needs to carry a JAX param tree across.
:func:`load_hf_llama` (JAX :79) streams a HF-format checkpoint file, index
or directory into the port's model; :func:`load_hf_mixtral` (JAX :173) a
HF Mixtral checkpoint, its per-expert tensors stacked as they stream
(:func:`_stack_expert_stream`); :func:`load_hf_bert` (JAX :272) a HF BERT
sequence classifier into ``models/bert.py``'s.  The T5 loader waits for
its model (ROADMAP A14).

The port's Mixtral keeps HF's router name (``block_sparse_moe.gate.weight``
``[E, D]``, the JAX ``router/kernel`` transposed) and the JAX package's
stacked experts (``block_sparse_moe.experts.{gate,up,down}_proj``, JAX
layout); :func:`hf_llama_key_map` knows both.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np
import torch

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

# the port's Mixtral parameters (models/mixtral.py), unrolled and scanned
_MIXTRAL_RULES: list[tuple[str, str]] = [
    (r"^model\.layers\.(\d+)\.block_sparse_moe\.gate\.weight$",
     r"params.layers_\1.block_sparse_moe.router.kernel"),
    (r"^model\.layers\.(\d+)\.block_sparse_moe\.experts\.(gate_proj|up_proj|down_proj)$",
     r"params.layers_\1.block_sparse_moe.experts.\2"),
    (r"^model\.layers_scan\.(block(?:_\d+)?)\.block_sparse_moe\.gate\.weight$",
     r"params.layers_scan.\1.block_sparse_moe.router.kernel"),
    (r"^model\.layers_scan\.(block(?:_\d+)?)\.block_sparse_moe\.experts\."
     r"(gate_proj|up_proj|down_proj)$", r"params.layers_scan.\1.block_sparse_moe.experts.\2"),
]

# HF Mixtral's per-expert tensors, stacked by the loader (JAX :34-41)
_MIXTRAL_EXPERT_RE = re.compile(
    r"^model\.layers\.(\d+)\.block_sparse_moe\.experts\.(\d+)\.w([123])\.weight$")
_MIXTRAL_STACKED_RE = re.compile(
    r"^model\.layers\.(\d+)\.block_sparse_moe\.experts_stacked\.(\w+)$")
_EXPERT_PROJ = {"1": "gate_proj", "2": "down_proj", "3": "up_proj"}

# HF buffers with no parameter (recomputed from the config)
_SKIP = re.compile(r"rotary_emb\.inv_freq$")


def hf_llama_key_map(name: str) -> Optional[str]:
    """HF Llama ``state_dict`` name -> the JAX param path (dot-separated),
    or None for buffers that are skipped.  Unknown names pass through."""
    if _SKIP.search(name):
        return None
    for pattern, template in _LLAMA_RULES + _MIXTRAL_RULES:
        if re.match(pattern, name):
            return re.sub(pattern, template, name)
    return name


def hf_mixtral_key_map(name: str) -> Optional[str]:
    """:func:`hf_llama_key_map` plus the synthetic ``experts_stacked``
    names :func:`_stack_expert_stream` emits (JAX :124)."""
    m = _MIXTRAL_STACKED_RE.match(name)
    if m:
        return f"params.layers_{m.group(1)}.block_sparse_moe.experts.{m.group(2)}"
    return hf_llama_key_map(name)


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


def _stack_expert_stream(checkpoint, num_experts: int):
    """A HF Mixtral tensor stream with its per-expert ``w1`` / ``w2`` /
    ``w3`` ``[out, in]`` tensors transposed and buffered per (layer,
    projection); once all ``num_experts`` have arrived, one stacked ``[E,
    in, out]`` tensor goes on under a synthetic ``experts_stacked`` name and
    the buffer entry is freed (HF files are layer-ordered: at most about
    one layer's projections are held).  Other tensors pass through.
    Raises on groups still incomplete at the end (JAX :137)."""
    from ..big_modeling import _iter_checkpoint_tensors

    buf: dict = {}
    for name, tensor in _iter_checkpoint_tensors(checkpoint):
        m = _MIXTRAL_EXPERT_RE.match(name)
        if not m:
            yield name, tensor
            continue
        layer, eidx, w = m.group(1), int(m.group(2)), m.group(3)
        key = (layer, _EXPERT_PROJ[w])
        buf.setdefault(key, {})[eidx] = torch.as_tensor(tensor).t()
        if len(buf[key]) == num_experts:
            group = buf.pop(key)
            yield (f"model.layers.{layer}.block_sparse_moe.experts_stacked.{key[1]}",
                   torch.stack([group[i] for i in range(num_experts)]))
    if buf:
        raise ValueError(
            "incomplete expert groups in checkpoint: "
            + ", ".join(f"layer {layer} {proj}: have {sorted(g)} of {num_experts}"
                        for (layer, proj), g in buf.items()))


def _mixtral_port_key(name: str) -> Optional[str]:
    """A HF Mixtral name (or a stacked one) -> the port's parameter name."""
    if _SKIP.search(name):
        return None
    m = _MIXTRAL_STACKED_RE.match(name)
    if m:
        return f"model.layers.{m.group(1)}.block_sparse_moe.experts.{m.group(2)}"
    return name


def load_hf_mixtral(model, checkpoint, *, dtype=None, strict: bool = True, **kwargs):
    """Stream a HF-format Mixtral checkpoint into the port's
    ``MixtralForCausalLM`` in one pass (JAX :173): shared weights load as
    the Llama's, the per-expert tensors stacked into ``[E, D, F]`` / ``[E,
    F, D]`` by :func:`_stack_expert_stream`, so placement, the dtype cast
    and ``strict`` apply to the experts as to every other weight.  Keyword
    arguments as :func:`load_hf_llama`'s.  Returns ``(model, store or
    None)``."""
    from ..big_modeling import load_checkpoint_and_dispatch

    if getattr(model.config, "scan_layers", False):
        raise ValueError(
            "load_hf_mixtral needs the unrolled layer stack; load with scan_layers=False, "
            "then convert via stack_layer_params")
    stream = _stack_expert_stream(checkpoint, model.config.num_local_experts)
    return load_checkpoint_and_dispatch(model, stream, dtype=dtype, strict=strict,
                                        key_map=_mixtral_port_key, **kwargs)


# -- BERT (encoder classifier; JAX :199-290) ------------------------------------
_BERT_RULES: list[tuple[str, str]] = [
    (r"^bert\.embeddings\.word_embeddings\.weight$", r"params.word_embeddings.embedding"),
    (r"^bert\.embeddings\.position_embeddings\.weight$", r"params.position_embeddings.embedding"),
    (r"^bert\.embeddings\.LayerNorm\.weight$", r"params.embeddings_norm.scale"),
    (r"^bert\.embeddings\.LayerNorm\.bias$", r"params.embeddings_norm.bias"),
    (r"^bert\.encoder\.layer\.(\d+)\.attention\.self\.(query|key|value)\.(weight|bias)$",
     r"params.layer_\1.attention.\2.\3"),
    (r"^bert\.encoder\.layer\.(\d+)\.attention\.output\.dense\.(weight|bias)$",
     r"params.layer_\1.attention.dense.\2"),
    (r"^bert\.encoder\.layer\.(\d+)\.attention\.output\.LayerNorm\.weight$",
     r"params.layer_\1.attention_norm.scale"),
    (r"^bert\.encoder\.layer\.(\d+)\.attention\.output\.LayerNorm\.bias$",
     r"params.layer_\1.attention_norm.bias"),
    (r"^bert\.encoder\.layer\.(\d+)\.intermediate\.dense\.(weight|bias)$",
     r"params.layer_\1.intermediate.\2"),
    (r"^bert\.encoder\.layer\.(\d+)\.output\.dense\.(weight|bias)$",
     r"params.layer_\1.output.\2"),
    (r"^bert\.encoder\.layer\.(\d+)\.output\.LayerNorm\.weight$",
     r"params.layer_\1.output_norm.scale"),
    (r"^bert\.encoder\.layer\.(\d+)\.output\.LayerNorm\.bias$",
     r"params.layer_\1.output_norm.bias"),
    (r"^bert\.pooler\.dense\.(weight|bias)$", r"params.pooler.\1"),
    (r"^classifier\.(weight|bias)$", r"params.classifier.\1"),
]

# buffers with no parameter (position_ids in older transformers exports)
_BERT_SKIP = re.compile(r"^bert\.embeddings\.(position_ids|token_type_ids)$")
_HF_TOKEN_TYPES = "bert.embeddings.token_type_embeddings.weight"
_HF_POSITIONS = "bert.embeddings.position_embeddings.weight"


def hf_bert_key_map(name: str) -> Optional[str]:
    """HF BERT ``state_dict`` name -> the JAX package's param path (JAX
    :234; a dense ``.weight`` becomes ``.kernel``), None for skipped
    buffers and the token-type table (folded, see :func:`load_hf_bert`);
    unknown names pass through."""
    if _BERT_SKIP.match(name) or name == _HF_TOKEN_TYPES:
        return None
    for pattern, template in _BERT_RULES:
        if re.match(pattern, name):
            out = re.sub(pattern, template, name)
            if out.endswith(".weight"):
                out = out[: -len(".weight")] + ".kernel"
            return out
    return name


def _fold_bert_token_types(checkpoint):
    """HF adds ``token_type_embeddings[type]`` at every position: type 0
    folds exactly into the position table (JAX :251), and the table
    becomes ``type - type[0]``, so a forward without ``token_type_ids`` is
    HF's with type 0, and one with them is HF's too."""
    from ..big_modeling import _iter_checkpoint_tensors

    pos = typ = None
    for name, tensor in _iter_checkpoint_tensors(checkpoint):
        if name == _HF_POSITIONS:
            pos = torch.as_tensor(tensor).float()
        elif name == _HF_TOKEN_TYPES:
            typ = torch.as_tensor(tensor).float()
        else:
            yield name, tensor
        if pos is not None and typ is not None:
            yield _HF_POSITIONS, pos + typ[0][None, :]
            yield _HF_TOKEN_TYPES, typ - typ[0][None, :]
            pos = typ = None
    if pos is not None:
        yield _HF_POSITIONS, pos


def _bert_port_key(name: str) -> Optional[str]:
    """HF BERT name -> the port's parameter name."""
    from .convert import bert_port_name

    if _BERT_SKIP.match(name):
        return None
    if name == _HF_TOKEN_TYPES:
        return "token_type_embeddings.weight"
    path = hf_bert_key_map(name)
    if path is None or not path.startswith("params."):
        return name
    return bert_port_name(path[len("params."):])


def load_hf_bert(model, checkpoint, *, dtype=None, strict: bool = True, **kwargs):
    """Stream a HF-format BERT sequence-classification checkpoint into the
    port's ``BertForSequenceClassification`` (JAX :272): the token types
    folded as :func:`_fold_bert_token_types` says, HF's ``[out, in]``
    dense weights as they are, through
    ``big_modeling.load_checkpoint_and_dispatch`` (its keyword arguments).
    Returns ``(model, store or None)``."""
    from ..big_modeling import load_checkpoint_and_dispatch

    return load_checkpoint_and_dispatch(model, _fold_bert_token_types(checkpoint), dtype=dtype,
                                        strict=strict, key_map=_bert_port_key, **kwargs)
