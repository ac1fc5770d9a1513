"""Carry a JAX Llama or Mixtral param tree into the port's parameters (an
unrolled tree, or a ``scan_layers`` one: ``layers_scan/block`` stacked on
a leading layer axis; a Mixtral's router ``[D, E]`` kernel transposed to
``[E, D]``, its stacked experts as they are).

This is how the parity tests run both frameworks on the same weights: the
JAX package's tree (nested dicts of numpy arrays, ``params/layers_{i}/
self_attn/q_proj/kernel`` ``[in, out]`` ...) becomes a ``state_dict`` for
:class:`~accelerate_tpu_torch.models.llama.LlamaForCausalLM` — names through
:func:`~.hf_interop.hf_llama_key_map`, kernels transposed to ``[out, in]``
through :func:`~.hf_interop.hf_llama_tensor_map`.

A quantized tree (JAX ``quantize_params``) carries its ``QuantizedTensor``
leaves across as the port's
:class:`~accelerate_tpu_torch.utils.quantization.QuantizedTensor`, codes and
scales bitwise, **in the JAX layout**: ``[in, out]`` = ``[H, F]``, k2d codes
``[H, F]`` int8 with scales ``[F / block, H]`` (or the flat layout), which
is the operand layout of the port's W8A16 kernels, so nothing is
transposed.  :func:`load_converted_state` loads such a state into a model.

LoRA: a JAX adapter tree (``init_adapter_params``: ``{layers_0: {self_attn:
{q_proj: {"a", "b"}}}}``) or a JAX ``lora`` pool (``init_lora_pool``, the
``AdapterStore.pool``) becomes the port's flat ``{module name: {"a",
"b"}}`` through :func:`lora_tree_from_flax`: flax module paths map to the
port's module names through :func:`flax_to_hf_name`, and the factors keep
JAX's ``[in, out]`` orientation and their dtype (bf16 exactly).

BERT and ResNet: :func:`torch_state_from_flax_bert` and
:func:`torch_state_from_flax_resnet` (the running averages of
``batch_stats`` included) carry the JAX examples' models across.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from ..utils.quantization import QuantizedTensor, is_quantized
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
    # a scan_layers tree: layers_scan/block (block_{j}) stacked on a leading axis
    (r"^params\.layers_scan\.(block(?:_\d+)?)\.self_attn\.(q|k|v|o)_proj\.kernel$",
     r"model.layers_scan.\1.self_attn.\2_proj.weight"),
    (r"^params\.layers_scan\.(block(?:_\d+)?)\.mlp\.(gate|up|down)_proj\.kernel$",
     r"model.layers_scan.\1.mlp.\2_proj.weight"),
    (r"^params\.layers_scan\.(block(?:_\d+)?)\.(input_layernorm|post_attention_layernorm)"
     r"\.scale$", r"model.layers_scan.\1.\2.weight"),
    # a Mixtral tree: the router's [D, E] kernel, the stacked experts as
    # they are
    (r"^params\.layers_(\d+)\.block_sparse_moe\.router\.kernel$",
     r"model.layers.\1.block_sparse_moe.gate.weight"),
    (r"^params\.layers_(\d+)\.block_sparse_moe\.experts\.(gate_proj|up_proj|down_proj)$",
     r"model.layers.\1.block_sparse_moe.experts.\2"),
    (r"^params\.layers_scan\.(block(?:_\d+)?)\.block_sparse_moe\.router\.kernel$",
     r"model.layers_scan.\1.block_sparse_moe.gate.weight"),
    (r"^params\.layers_scan\.(block(?:_\d+)?)\.block_sparse_moe\.experts\."
     r"(gate_proj|up_proj|down_proj)$", r"model.layers_scan.\1.block_sparse_moe.experts.\2"),
]


def _is_jax_quantized(leaf) -> bool:
    """A JAX ``QuantizedTensor`` leaf, recognised by its fields (the port
    imports nothing of the JAX package)."""
    return all(hasattr(leaf, a) for a in ("data", "scale", "scheme", "block_size", "shape"))


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


def _quantized_from_jax(leaf) -> QuantizedTensor:
    dtype = getattr(torch, np.dtype(leaf.dtype).name, torch.float32)
    return QuantizedTensor(torch.from_numpy(np.array(leaf.data, copy=True)),
                           torch.from_numpy(np.array(leaf.scale, dtype=np.float32, copy=True)),
                           leaf.shape, dtype, leaf.scheme, leaf.block_size,
                           getattr(leaf, "layout", "flat"))


def _tensor_from_numpy(leaf) -> torch.Tensor:
    """A CPU tensor of a numpy-convertible leaf in its own dtype; numpy's
    ``ml_dtypes`` bfloat16 (what ``np.asarray`` of a JAX bf16 array gives)
    crosses through f32, which holds every bf16 value exactly."""
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(np.array(arr, copy=True))


def flax_module_to_port_name(path: str) -> str:
    """A flax module path (``layers_0/self_attn/q_proj``, ``lm_head``) ->
    the port's module name (``model.layers.0.self_attn.q_proj``)."""
    name = flax_to_hf_name("params." + path.replace("/", ".") + ".kernel")
    return name[: -len(".weight")]


def lora_tree_from_flax(tree) -> dict:
    """A JAX adapter tree or ``lora`` pool (nested dicts ending in ``{"a",
    "b"}`` leaves, numpy-convertible) -> the port's ``{module name: {"a",
    "b"}}`` of CPU tensors, each factor in its own dtype, values
    unchanged."""
    out = {}
    for path, leaf in _flatten(tree):
        *module, factor = path
        if factor not in ("a", "b"):
            raise KeyError(f"not a LoRA factor: {'/'.join(path)!r}")
        out.setdefault(flax_module_to_port_name("/".join(module)), {})[factor] = \
            _tensor_from_numpy(leaf)
    return out


def torch_state_from_flax(params) -> dict:
    """A ``state_dict`` for the port's ``LlamaForCausalLM`` from a JAX
    Llama param tree (``{"params": {...}}`` of numpy-convertible arrays).
    Tensors come back f32 on the CPU; ``load_state_dict`` casts them to
    each parameter's dtype and device.  ``QuantizedTensor`` leaves come
    back as the port's, bitwise, in the JAX layout (module docstring):
    load those with :func:`load_converted_state`."""
    if "params" not in params:
        params = {"params": params}
    state = {}
    for path, leaf in _flatten(params):
        name = flax_to_hf_name(".".join(path))
        if _is_jax_quantized(leaf):
            state[name] = _quantized_from_jax(leaf)
            continue
        arr = hf_llama_tensor_map("/".join(path), np.asarray(leaf, dtype=np.float32))
        state[name] = torch.tensor(arr)
    return state


def flax_flat_from_torch(state) -> dict:
    """The inverse of :func:`torch_state_from_flax`, flattened: the port's
    parameters (a ``state_dict`` or name -> tensor dict of HF names) as the
    JAX package's dot paths (``params.layers_0.self_attn.q_proj.kernel``)
    in flax's flatten order, kernels transposed to ``[in, out]``, each
    tensor on the CPU in its own dtype, contiguous.  ``save_model`` writes
    these names and bytes, which are the JAX package's for the same
    weights."""
    flat = {}
    for name, t in state.items():
        path = hf_llama_key_map(name)
        if path is None:
            continue
        t = t.detach().to("cpu")
        if path.endswith(".kernel") and t.dim() in (2, 3):
            t = t.transpose(-1, -2)
        flat[path] = t.contiguous()
    return {k: flat[k] for k in sorted(flat, key=lambda p: tuple(p.split(".")))}


def torch_state_from_flax_flat(flat) -> dict:
    """:func:`flax_flat_from_torch`'s inverse: dot paths -> the port's names
    and ``[out, in]`` layout, each tensor in its own dtype (a JAX
    ``save_model`` file, read back as the port's ``state_dict``)."""
    state = {}
    for path, t in flat.items():
        name = flax_to_hf_name(path if path.startswith("params.") else "params." + path)
        if path.endswith(".kernel") and t.dim() in (2, 3):
            t = t.transpose(-1, -2).contiguous()
        state[name] = t
    return state


@torch.no_grad()
def load_converted_state(model: torch.nn.Module, state: dict) -> torch.nn.Module:
    """Load a state from :func:`torch_state_from_flax` (quantized or not)
    into ``model``: each :class:`QuantizedTensor` entry ``<layer>.weight``
    is moved to the model's device and set on its ``QuantizableDense``
    (``set_quantized``), the rest goes through ``load_state_dict``.  Every
    parameter of the model must be covered.  Returns ``model``."""
    dense = {k: v for k, v in state.items() if not is_quantized(v)}
    quantized = {k: v for k, v in state.items() if is_quantized(v)}
    dev = model.lm_head.weight.device
    for name, qt in quantized.items():
        layer = model.get_submodule(name.rsplit(".", 1)[0])
        layer.set_quantized(QuantizedTensor(qt.data.to(dev), qt.scale.to(dev), qt.shape,
                                            qt.dtype, qt.scheme, qt.block_size, qt.layout))
    missing, unexpected = model.load_state_dict(dense, strict=False)
    missing = [k for k in missing if not k.endswith((".qcodes", ".qscales"))]
    if missing or unexpected:
        raise KeyError(f"state does not match the model: missing {missing}, "
                       f"unexpected {unexpected}")
    return model


# -- BERT and ResNet (``models/bert.py``, ``models/resnet.py``) ---------------

_FLAX_TO_PORT_BERT: list[tuple[str, str]] = [
    (r"^(word_embeddings|position_embeddings|token_type_embeddings)\.embedding$", r"\1.weight"),
    (r"^(embeddings_norm)\.scale$", r"\1.weight"),
    (r"^(embeddings_norm)\.bias$", r"\1.bias"),
    (r"^layer_(\d+)\.attention\.(query|key|value|dense)\.kernel$",
     r"layers.\1.attention.\2.weight"),
    (r"^layer_(\d+)\.attention\.(query|key|value|dense)\.bias$", r"layers.\1.attention.\2.bias"),
    (r"^layer_(\d+)\.(attention_norm|output_norm)\.scale$", r"layers.\1.\2.weight"),
    (r"^layer_(\d+)\.(attention_norm|output_norm)\.bias$", r"layers.\1.\2.bias"),
    (r"^layer_(\d+)\.(intermediate|output)\.kernel$", r"layers.\1.\2.weight"),
    (r"^layer_(\d+)\.(intermediate|output)\.bias$", r"layers.\1.\2.bias"),
    (r"^(pooler|classifier)\.kernel$", r"\1.weight"),
    (r"^(pooler|classifier)\.bias$", r"\1.bias"),
]


def bert_port_name(path: str) -> str:
    """A flax BERT param path (``layer_0.attention.query.kernel``, no
    ``params.``) -> the port's parameter name."""
    for pattern, template in _FLAX_TO_PORT_BERT:
        if re.match(pattern, path):
            return re.sub(pattern, template, path)
    raise KeyError(f"no port parameter for JAX BERT param {path!r}")


def torch_state_from_flax_bert(params) -> dict:
    """A ``state_dict`` (f32 CPU tensors) for the port's
    ``BertForSequenceClassification`` from a JAX BERT param tree: dense
    kernels ``[in, out]`` transposed to ``[out, in]``, embeddings and norms
    as they are.  A tree without a token-type table (a JAX model applied
    without ``token_type_ids`` has none) leaves the port's out."""
    params = params.get("params", params)
    state = {}
    for path, leaf in _flatten(params):
        dotted = ".".join(path)
        arr = np.asarray(leaf, dtype=np.float32)
        if dotted.endswith(".kernel"):
            arr = arr.T
        state[bert_port_name(dotted)] = torch.tensor(np.ascontiguousarray(arr))
    return state


def resnet_port_name(path: str) -> str:
    """A flax ResNet param or batch-stat path (``stage1_block0.bn1.scale``,
    ``stem_bn.mean``) -> the port's name (``blocks.stage1_block0.bn1.weight``,
    ``stem_bn.mean``)."""
    *module, leaf = path.split(".")
    leaf = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
    if module and module[0].startswith("stage"):
        module = ["blocks"] + module
    return ".".join(module + [leaf])


def torch_state_from_flax_resnet(variables) -> dict:
    """A ``state_dict`` (f32 CPU tensors) for the port's ``ResNet`` from
    JAX ResNet variables (``{"params", "batch_stats"}``): conv kernels
    ``[kh, kw, in, out]`` to ``[out, in, kh, kw]``, the classifier's to
    ``[out, in]``, batch-norm scales and biases, and the running averages
    into the ``mean`` / ``var`` buffers."""
    state = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            arr = np.asarray(leaf, dtype=np.float32)
            if path[-1] == "kernel":
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            state[resnet_port_name(".".join(path))] = torch.tensor(np.ascontiguousarray(arr))
    return state


def resnet_batch_stats_from_flax(batch_stats) -> dict:
    """JAX ``batch_stats`` -> the port's ``{module name: {"mean", "var"}}``
    (what ``make_resnet_loss_fn``'s aux holds)."""
    out: dict = {}
    for path, leaf in _flatten(batch_stats):
        name = resnet_port_name(".".join(path))
        module, stat = name.rsplit(".", 1)
        out.setdefault(module, {})[stat] = torch.tensor(np.asarray(leaf, dtype=np.float32))
    return out
