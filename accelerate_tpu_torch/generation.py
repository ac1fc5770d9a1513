"""Autoregressive generation (mirrors ``accelerate_tpu/generation.py``:
``GenerationConfig`` :35, ``sample_logits`` :47, ``generate`` :114 through
``_generate_impl`` :81 on the dense KV cache, and ``generate_paged`` :203
through the serving engine's paged cache).

The port's in-framework token reference for the serving engine: greedy
serving emits exactly :func:`generate`'s tokens.  PyTorch runs eagerly, so
the decode loop is a Python loop where JAX traced one ``lax.scan``.
Sampling draws from a ``torch.Generator`` and is not held to JAX's random
bits; greedy decoding is an f32 argmax (first index on ties) on both sides.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .models.llama import init_cache


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Decode-loop knobs (transformers-compatible names)."""

    max_new_tokens: int = 32
    do_sample: bool = False
    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0


def sample_logits(logits, generator: Optional[torch.Generator], config: GenerationConfig):
    """Next-token selection from ``[B, V]`` logits, as int32.

    Greedy when ``do_sample=False``; else temperature -> top-k -> top-p
    filtering (filtered logits drop to the f32 minimum), then one
    categorical draw from ``generator``."""
    logits = logits.float()
    if not config.do_sample:
        return logits.argmax(dim=-1).to(torch.int32)
    if config.temperature != 1.0:
        logits = logits / max(config.temperature, 1e-6)
    neg = torch.finfo(torch.float32).min
    if config.top_k:  # top_k=0 disables the filter
        k = min(config.top_k, logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, neg)
    if config.top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep the tokens whose cumulative mass first crosses top_p; the
        # top token is always kept (top_p=0.0 means greedy)
        keep = cum - probs < config.top_p
        keep[..., 0] = True
        cutoff = torch.where(keep, sorted_logits, torch.inf).amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff, neg)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


@torch.inference_mode()
def generate(model, input_ids, generation_config: Optional[GenerationConfig] = None,
             *, prompt_lengths=None, generator: Optional[torch.Generator] = None):
    """Generate ``max_new_tokens`` continuations for a batch of prompts on
    ``model``'s device.

    ``input_ids``: ``[B, T]`` right-padded prompts; ``prompt_lengths``:
    ``[B]`` real lengths (default: full width).  Returns ``[B,
    max_new_tokens]`` int32, padded with ``pad_token_id`` after EOS."""
    gc = generation_config or GenerationConfig()
    dev = model.device
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    b, t_prompt = input_ids.shape
    if prompt_lengths is None:
        prompt_lengths = torch.full((b,), t_prompt, dtype=torch.long, device=dev)
    else:
        prompt_lengths = torch.as_tensor(prompt_lengths, device=dev).long()
    cache = init_cache(model.config, b, t_prompt + gc.max_new_tokens, device=dev)

    positions = torch.arange(t_prompt, device=dev).expand(b, t_prompt)
    write_mask = positions < prompt_lengths[:, None]
    logits, cache = model(input_ids, positions=positions, cache=cache,
                          cache_write_mask=write_mask)
    # the last *real* prompt token's logits seed the loop
    last = logits[torch.arange(b, device=dev), prompt_lengths - 1]

    eos = gc.eos_token_id
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    cur_pos = prompt_lengths
    tokens = []
    for step in range(gc.max_new_tokens):
        token = sample_logits(last, generator, gc)
        token = torch.where(done, torch.full_like(token, gc.pad_token_id), token)
        if eos is not None:
            done = done | (token == eos)
        tokens.append(token)
        if step + 1 == gc.max_new_tokens:
            break  # the last token's logits would seed nothing
        logits, cache = model(token[:, None].long(), positions=cur_pos[:, None],
                              cache=cache, cache_write_mask=~done[:, None])
        last = logits[:, 0]
        cur_pos = cur_pos + 1
    if not tokens:
        return torch.zeros(b, 0, dtype=torch.int32, device=dev)
    return torch.stack(tokens, dim=1)


def generate_paged(model, input_ids, generation_config: Optional[GenerationConfig] = None, *,
                   prompt_lengths=None, serving_plugin=None, seed: int = 0,
                   adapters=None, adapter_ids=None, speculate=None, speculate_k=None,
                   draft_model=None, prefix_cache=None):
    """:func:`generate`-shaped decoding through the paged serving path (JAX
    ``generate_paged``): the batch rows become requests of a
    :class:`~accelerate_tpu_torch.serving.ServingEngine` on ``model``'s
    device, and the result comes back as the same right-padded ``[B,
    max_new_tokens]`` int32 tensor (``pad_token_id`` after EOS).  Greedy
    paged serving emits :func:`generate`'s tokens.

    ``serving_plugin`` defaults to JAX's offline provisioning: every row
    resident at once, pages of 16 tokens, a prefill chunk of ``max(16, T)``.
    Pass one with ``kv_dtype="int8"`` / ``"fp8"`` for quantized pages; a
    model quantized with ``quantize_model_`` decodes through the W8A16
    kernels.  ``seed`` seeds the engine's sampling generator.

    Multi-tenant: pass an :class:`~accelerate_tpu_torch.serving.AdapterStore`
    as ``adapters`` plus per-row tenant ``adapter_ids`` (0 = the base model)
    to decode each row through its LoRA adapter.

    Speculative decode: ``speculate="ngram"`` (prompt-lookup self-drafting)
    or ``"draft"`` (pass ``draft_model``, a small model with its own
    weights) emits up to ``speculate_k + 1`` tokens per verify pass; greedy
    tokens are the plain path's.  ``speculate=True`` means ``"ngram"``.
    Prefix caching: ``prefix_cache=True`` (or ``"on"``) arms the
    content-addressed copy-on-write page cache; greedy tokens are the same
    with it on or off.  ``False`` is an explicit opt-out over a plugin or
    environment that armed either."""
    import dataclasses as _dc

    from .serving import Request, ServingEngine
    from .utils.dataclasses import ServingPlugin

    if speculate is True:
        speculate = "ngram"
    elif speculate is False:
        speculate = "off"
    if prefix_cache is True:
        prefix_cache = "on"
    elif prefix_cache is False:
        prefix_cache = "off"
    gc = generation_config or GenerationConfig()
    ids = np.asarray(input_ids.cpu() if isinstance(input_ids, torch.Tensor) else input_ids)
    b, t_prompt = ids.shape
    if prompt_lengths is None:
        lens = [t_prompt] * b
    else:
        lens = [int(x) for x in np.asarray(
            prompt_lengths.cpu() if isinstance(prompt_lengths, torch.Tensor) else prompt_lengths)]
    if adapter_ids is None:
        tenants = [0] * b
    else:
        tenants = [int(x) for x in np.asarray(
            adapter_ids.cpu() if isinstance(adapter_ids, torch.Tensor) else adapter_ids)]
    n_new = gc.max_new_tokens
    knobs = {**({"speculate": speculate} if speculate is not None else {}),
             **({"prefix_cache": prefix_cache} if prefix_cache is not None else {})}
    if serving_plugin is None:
        page_size = 16
        pages = max(1, -(-(t_prompt + n_new) // page_size))
        serving_plugin = ServingPlugin(num_slots=b, page_size=page_size, pages_per_slot=pages,
                                       num_pages=b * pages, prefill_chunk=max(16, t_prompt),
                                       **knobs,
                                       **({"speculate_k": speculate_k} if speculate_k else {}))
    elif knobs or speculate_k:
        serving_plugin = _dc.replace(
            serving_plugin, **knobs,
            **({"speculate_k": speculate_k, "speculate_buckets": None} if speculate_k else {}))
    engine = ServingEngine(model, serving_plugin, gc, seed=seed, device=model.device,
                           adapters=adapters, draft_model=draft_model)
    for i in range(b):
        engine.add_request(Request(uid=i, prompt=tuple(int(x) for x in ids[i, :lens[i]]),
                                   max_new_tokens=n_new, adapter_id=tenants[i]))
    results = engine.run([])
    out = torch.full((b, n_new), gc.pad_token_id, dtype=torch.int32)
    for i in range(b):
        out[i, :len(results[i])] = torch.tensor(results[i], dtype=torch.int32)
    return out.to(model.device)
