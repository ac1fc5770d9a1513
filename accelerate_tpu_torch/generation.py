"""Autoregressive generation on the dense KV cache (mirrors
``accelerate_tpu/generation.py``: ``GenerationConfig`` :35,
``sample_logits`` :47, ``generate`` :114 through ``_generate_impl`` :81).

The port's in-framework token reference for the serving engine: greedy
serving emits exactly :func:`generate`'s tokens.  PyTorch runs eagerly, so
the decode loop is a Python loop where JAX traced one ``lax.scan``.
Sampling draws from a ``torch.Generator`` and is not held to JAX's random
bits; greedy decoding is an f32 argmax (first index on ties) on both sides.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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


@torch.no_grad()
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
