"""Autoregressive generation (mirrors ``accelerate_tpu/generation.py``:
``GenerationConfig`` :35, ``sample_logits`` :47, ``generate`` :114 through
``_generate_impl`` :81 on the dense KV cache, ``generate_paged`` :203
through the serving engine's paged cache, ``beam_search`` :407 through
``_beam_search_impl`` :324 on the dense cache, and ``place_params_host``
:521 / ``generate_streamed`` :581 for a model whose layers live in host
memory or on disk).

The port's in-framework token reference for the serving engine: greedy
serving emits exactly :func:`generate`'s tokens.  PyTorch runs eagerly, so
the decode loop is a Python loop where JAX traced one ``lax.scan``.
Sampling draws from a ``torch.Generator`` and is not held to JAX's random
bits; greedy decoding is an f32 argmax (first index on ties) on both sides.
Beam search ranks candidates by a stable descending sort: among equal
scores the lower index first, ``jax.lax.top_k``'s order (``torch.topk``
promises none).

In a tp world (each rank's module from ``parallel.sharding.
bind_tp_slices``, every rank calling alike) :func:`generate`,
:func:`beam_search` and :func:`generate_paged` run on the rank's module:
its cache holds the kv heads of its query heads
(``LlamaForCausalLM.cache_kv_heads``), and the logits every rank samples
from are gathered whole, so ranks whose generators are seeded alike pick
the same tokens.
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Optional

import numpy as np
import torch

from .models.llama import init_cache
from .utils.device import resolve_device


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
    cache = init_cache(model.config, b, t_prompt + gc.max_new_tokens, device=dev,
                       num_kv_heads=model.cache_kv_heads())

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


# ---------------------------------------------------------------------------
# Beam search (decoder-only; JAX :324-420)
# ---------------------------------------------------------------------------


def _top_k(x: torch.Tensor, k: int):
    """The ``k`` largest entries of each row, largest first, the lower
    index first among equal ones (``jax.lax.top_k``'s order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


@torch.inference_mode()
def beam_search(model, input_ids, generation_config: Optional[GenerationConfig] = None, *,
                num_beams: int = 4, length_penalty: float = 1.0, prompt_lengths=None,
                apply_fn=None):
    """Beam-search decoding on the dense KV cache, on ``model``'s device.

    Beams live on the batch axis (``[B * num_beams, ...]``, beam-major in
    each batch row); every step re-gathers each layer's cache by the
    surviving beams' source rows (``index_select`` on dim 0).  A finished
    beam expands only with ``pad_token_id`` at score 0.  The best beam of
    each row is picked by its GNMT length-normalised score, the EOS step
    counting toward its length.  ``apply_fn(ids, positions=, cache=,
    cache_write_mask=) -> (logits, cache)`` replaces the model's forward.
    Returns ``[B, max_new_tokens]`` int32."""
    gc = generation_config or GenerationConfig()
    apply = apply_fn or model
    dev = model.device
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    b, t_prompt = input_ids.shape
    k = num_beams
    if prompt_lengths is None:
        lens = torch.full((b,), t_prompt, dtype=torch.long, device=dev)
    else:
        lens = torch.as_tensor(prompt_lengths, device=dev).long()
    n = gc.max_new_tokens
    neg = -1e9
    eos, pad = gc.eos_token_id, gc.pad_token_id
    cache = init_cache(model.config, b, t_prompt + n, device=dev,
                       num_kv_heads=model.cache_kv_heads())
    positions = torch.arange(t_prompt, device=dev).expand(b, t_prompt)
    logits, cache = apply(input_ids, positions=positions, cache=cache,
                          cache_write_mask=positions < lens[:, None])
    last = logits[torch.arange(b, device=dev), lens - 1].repeat_interleave(k, dim=0)
    cache = [{"k": c["k"].repeat_interleave(k, dim=0), "v": c["v"].repeat_interleave(k, dim=0),
              "pos": c["pos"].repeat_interleave(k, dim=0), "index": c["index"]} for c in cache]
    # only beam 0 is live at the start, else the k identical beams collapse
    beam_scores = torch.where(torch.arange(k, device=dev) == 0, 0.0, neg).repeat(b)
    done = torch.zeros(b * k, dtype=torch.bool, device=dev)
    cur_pos = lens.repeat_interleave(k)
    tokens = torch.full((b * k, n), pad, dtype=torch.int32, device=dev)
    v = last.shape[-1]
    pad_row = torch.full((v,), neg, device=dev)
    pad_row[pad] = 0.0
    rows = torch.arange(b, device=dev)[:, None] * k
    for step in range(n):
        logp = torch.log_softmax(last.float(), dim=-1)
        logp = torch.where(done[:, None], pad_row[None, :], logp)
        cand = (beam_scores[:, None] + logp).reshape(b, k * v)
        top_scores, top_idx = _top_k(cand, k)
        src = (rows + top_idx // v).reshape(-1)
        token = (top_idx % v).to(torch.int32).reshape(-1)
        beam_scores = top_scores.reshape(-1)
        done, cur_pos, tokens = done[src], cur_pos[src], tokens[src]
        tokens[:, step] = token
        was_done = done
        if eos is not None:
            done = done | (token == eos)
        # beams stop advancing the step after their EOS: the EOS token
        # counts toward the length (transformers' GNMT normalisation)
        next_pos = cur_pos + (~was_done)
        if step + 1 < n:   # the last step's logits would seed nothing
            cache = [{"k": c["k"].index_select(0, src), "v": c["v"].index_select(0, src),
                      "pos": c["pos"].index_select(0, src), "index": c["index"]}
                     for c in cache]
            logits, cache = apply(token[:, None].long(), positions=cur_pos[:, None],
                                  cache=cache, cache_write_mask=~done[:, None])
            last = logits[:, 0]
        cur_pos = next_pos
    gen_len = torch.clamp((cur_pos - lens.repeat_interleave(k)).float(), min=1.0)
    norm = beam_scores / gen_len ** length_penalty
    best = norm.reshape(b, k).argmax(dim=-1)
    return tokens[torch.arange(b, device=dev) * k + best]


# ---------------------------------------------------------------------------
# Layer-streamed generation for a model larger than the card (JAX :521-718)
# ---------------------------------------------------------------------------


def place_params_host(params):
    """Move a model (in place) or a name -> tensor mapping into pinned host
    memory: the tier :func:`generate_streamed` streams layers from."""
    from .big_modeling import dispatch_model

    return dispatch_model(params, {"": "cpu"})[0]


@torch.inference_mode()
def generate_streamed(model, input_ids, generation_config: Optional[GenerationConfig] = None, *,
                      params=None, prompt_lengths=None,
                      generator: Optional[torch.Generator] = None, prefetch: bool = True,
                      prefetch_depth: int = 1, stream_stats=None,
                      capture_logits: Optional[list] = None, device=None):
    """Generate from a model whose decoder layers do not fit on the card.

    Each layer's tensors lie where the model (or ``params``, a name ->
    tensor mapping over its names that overrides them, such as
    ``big_modeling.offload_store_params``) holds them: on ``device``
    (resident), in pinned host memory (:func:`place_params_host`,
    ``load_checkpoint_and_dispatch``'s ``"cpu"`` tier) or in other host
    memory (an ``OffloadStore`` memory map: the ``"disk"`` tier), which is
    first copied into a reusable pinned slot
    (:class:`~accelerate_tpu_torch.ops.streaming.PinnedStaging`).  A disk-tier tensor
    streams even where ``device`` is the CPU (into a plain slot); on the
    CPU the other tiers are the device's own memory and stay put.  Every
    forward streams the off-device layers through
    :class:`~accelerate_tpu_torch.ops.streaming.LayerPrefetcher`: with
    ``prefetch=True`` layer *i+1*'s upload runs on a side stream under
    layer *i*'s compute (and layer 0's for the next token under the head:
    the lookahead wraps), the card holding ``prefetch_depth + 1`` streamed
    layers at a time; ``prefetch=False`` is the serial baseline (the host
    waits for each upload).  Both give the same logits, bitwise.  The
    embedding, final norm and head stay resident on ``device`` (JAX
    :647-656).  Each layer runs through ``torch.func.functional_call`` of
    its own module on the staged tensors: nothing is copied into a
    parameter.  int8 layers stream their codes and scales and run the
    W8A16 kernels.

    ``stream_stats`` (a :class:`~accelerate_tpu_torch.ops.streaming.StreamStats`)
    receives the bytes, fetches, prefetch hits and wall time;
    ``capture_logits`` (a list) each forward's f32 logits.  Returns
    ``[B, max_new_tokens]`` int32 on ``device``, :func:`generate`'s tokens."""
    from .big_modeling import _named_tensors
    from .ops.streaming import LayerPrefetcher, PinnedStaging, file_span, stage_tree

    gc = generation_config or GenerationConfig()
    cfg = model.config
    if getattr(cfg, "scan_layers", False):
        raise ValueError("generate_streamed streams per-layer weights: build the model with "
                         "scan_layers=False and unstack_layer_params(params)")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:   # compare with tensors' own devices
        dev = torch.device("cuda", torch.cuda.current_device())
    t_start = time.perf_counter()
    tensors = _named_tensors(model)
    if params is not None:
        tensors.update(params)
    n_layers = cfg.num_hidden_layers
    resident: list = [{} for _ in range(n_layers)]
    streamed: list = [{} for _ in range(n_layers)]
    pattern = re.compile(r"model\.layers\.(\d+)\.(.+)$")
    on_file = {id(t) for t in tensors.values() if file_span(t) is not None}
    for name, t in tensors.items():
        m = pattern.match(name)
        if m:
            i, rel = int(m.group(1)), m.group(2)
            home = t.device == dev and id(t) not in on_file
            (resident if home else streamed)[i][rel] = t

    def on_device(name):
        t = tensors[name]
        return t if t.device == dev else t.to(dev)

    # the embedding, final norm and head tier stays on the card: streaming
    # the [V, H] tables every token would cost more than a layer
    embed = on_device("model.embed_tokens.weight")
    norm_w = on_device("model.norm.weight")
    head_w = embed if cfg.tie_word_embeddings else on_device("lm_head.weight")
    cos, sin = model.rope_cos.to(dev), model.rope_sin.to(dev)

    # pageable sources go through a slot first.  At most prefetch_depth + 1
    # staged layers are live (the one computing and its lookahead), so with
    # one slot more a slot is refilled only after its layer has run (on the
    # CPU the staged tensors are the slot's own) and, on the card, once the
    # copy that read it has ended
    staging = PinnedStaging(prefetch_depth + 2, pin=dev.type == "cuda")
    pageable = {id(t) for tree in streamed for t in tree.values()
                if id(t) in on_file or (dev.type == "cuda" and not t.is_pinned())}

    def fetch(i):
        host = streamed[i]
        if not host:
            return {}
        unpinned = {k: t for k, t in host.items() if id(t) in pageable}
        slot = None
        if unpinned:
            staged_host, slot = staging.stage(unpinned)
            host = {**host, **staged_host}
        staged = stage_tree(host, dev)
        if slot is not None:
            staging.release(slot, staged.event)
        return staged

    fetcher = LayerPrefetcher(fetch, n_layers, depth=prefetch_depth, wrap=True,
                              enabled=prefetch, stats=stream_stats)
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    b, t_prompt = input_ids.shape
    if prompt_lengths is None:
        lens = torch.full((b,), t_prompt, dtype=torch.long, device=dev)
    else:
        lens = torch.as_tensor(prompt_lengths, device=dev).long()
    cache = init_cache(cfg, b, t_prompt + gc.max_new_tokens, device=dev)
    layers = model.model.layers

    def forward(ids, positions, write_mask):
        x = torch.nn.functional.embedding(ids, embed)
        for i in range(n_layers):
            tree = {**resident[i], **fetcher.get(i)}
            x, cache[i] = torch.func.functional_call(
                layers[i], tree, (x, positions, cos, sin, cache[i], write_mask))
            del tree     # the staged layer is freed as soon as its compute has run
        x = torch.func.functional_call(model.model.norm, {"weight": norm_w}, (x,))
        logits = torch.func.functional_call(model.lm_head, {"weight": head_w}, (x,))
        if capture_logits is not None:
            capture_logits.append(logits)
        return logits

    positions = torch.arange(t_prompt, device=dev).expand(b, t_prompt)
    logits = forward(input_ids, positions, positions < lens[:, None])
    last = logits[torch.arange(b, device=dev), lens - 1]
    eos = gc.eos_token_id
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    cur_pos = lens
    out = []
    for step in range(gc.max_new_tokens):
        token = sample_logits(last, generator, gc)
        token = torch.where(done, torch.full_like(token, gc.pad_token_id), token)
        if eos is not None:
            done = done | (token == eos)
        out.append(token)
        if step + 1 == gc.max_new_tokens:
            break
        logits = forward(token[:, None].long(), cur_pos[:, None], ~done[:, None])
        last = logits[:, 0]
        cur_pos = cur_pos + 1
    fetcher.drop()
    tokens = torch.stack(out, dim=1) if out else torch.zeros(b, 0, dtype=torch.int32,
                                                             device=dev)
    if stream_stats is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stream_stats.wall_s += time.perf_counter() - t_start
    return tokens
