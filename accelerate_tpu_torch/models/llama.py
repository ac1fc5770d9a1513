"""Llama-family decoder (mirrors ``accelerate_tpu/models/llama.py``).

The model with its uncached forward (training), its dense KV cache (for
:func:`~accelerate_tpu_torch.generation.generate`) and its paged KV cache
(for :class:`~accelerate_tpu_torch.serving.ServingEngine`), plus the loss
functions of the training step.  Parameter names follow HF's Llama
``state_dict`` (``model.layers.{i}.self_attn.q_proj.weight`` ``[out, in]``,
...); ``models/convert.py`` maps a JAX param tree onto them.

``attn_implementation``:

- ``"native"``: :func:`native_attention` uncached, and for the paged cache
  a gather through the block table into :func:`cached_attention` (the JAX
  ``"native"`` route and the tests' reference);
- ``"flash"``: uncached, :func:`~..ops.flash_attention.flash_attention`
  (kernels #1-#3); paged, :func:`paged_decode_attention` for decode
  (``T == 1``) and :func:`paged_multitoken_attention` for a prefill chunk
  (``T > 1``) — CUDA kernels on the card, their plain versions on the CPU.

Scan, remat, fp8, LoRA and the collective-matmul routes are not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.flash_attention import (
    flash_attention,
    paged_decode_attention,
    paged_multitoken_attention,
)
from ..utils.device import resolve_device
from .layers import QuantizableDense


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    attn_implementation: str = "native"  # native | flash
    remat: bool = False
    scan_layers: bool = False
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.attn_implementation not in ("native", "flash"):
            raise ValueError(
                f"attn_implementation must be 'native' or 'flash', got "
                f"{self.attn_implementation!r} (ring/ulysses are ROADMAP "
                "item A13, slice 6)"
            )
        for knob in ("remat", "scan_layers"):
            if getattr(self, knob):
                raise NotImplementedError(
                    f"LlamaConfig.{knob}=True is not ported yet (ROADMAP item "
                    "A12, slice 5: activation checkpointing and the scanned "
                    "layer stack)"
                )

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, **kw):
        """Test-scale config."""
        defaults = dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=128,
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def llama2_1b(cls, **kw):
        """~1.1B config (TinyLlama-style)."""
        defaults = dict(
            vocab_size=32000, hidden_size=2048, intermediate_size=5632,
            num_hidden_layers=22, num_attention_heads=32, num_key_value_heads=4,
            max_position_embeddings=2048,
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def llama3_8b(cls, **kw):
        defaults = dict(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
            rope_theta=500000.0, max_position_embeddings=8192,
        )
        defaults.update(kw)
        return cls(**defaults)


class RMSNorm(nn.Module):
    """f32 normalisation with an f32 scale, then a cast to ``dtype``."""

    def __init__(self, hidden: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(hidden, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        normed = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + self.eps)
        return (normed * self.weight).to(self.dtype)


def rope_frequencies(head_dim: int, max_len: int, theta: float) -> tuple[np.ndarray, np.ndarray]:
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    t = np.arange(max_len, dtype=np.float32)
    freqs = np.outer(t, inv_freq)
    return np.cos(freqs), np.sin(freqs)


def apply_rope(x, cos, sin, positions):
    """x: [B, T, H, D]; cos/sin: [max_len, D/2] f32; positions: [B, T].
    Split-half rotation computed in f32, cast back to ``x.dtype``.
    Positions past the table clamp, as JAX's gather does (only masked
    padding lanes reach them)."""
    idx = positions.long().clamp(0, cos.shape[0] - 1)
    c = cos[idx][:, :, None, :]
    s = sin[idx][:, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def native_attention(q, k, v, *, causal: bool = True, segment_ids=None):
    """Reference-semantics attention with an f32 softmax.  q: [B, T, H, D];
    k/v: [B, S, Hkv, D] (GQA broadcast here); ``segment_ids`` [B, T] masks
    cross-segment pairs (self-attention)."""
    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", q, k).float() / math.sqrt(d)
    if causal:
        mask = torch.ones(t, s, dtype=torch.bool, device=q.device).tril(diagonal=s - t)
        scores = scores.masked_fill(~mask, -1e30)
    if segment_ids is not None:
        same = segment_ids[:, :, None] == segment_ids[:, None, :]
        scores = scores.masked_fill(~same[:, None], -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def get_attention_impl(name: str):
    """The uncached attention function of ``attn_implementation``."""
    if name == "native":
        return native_attention
    if name == "flash":
        return flash_attention
    if name in ("ring", "ulysses"):
        raise NotImplementedError(
            f"{name!r} attention is context / sequence parallelism, ROADMAP "
            "item A13 (slice 6)"
        )
    raise ValueError(f"unknown attention implementation {name!r}")


# Sentinel position for unwritten / padding dense-cache slots: larger than
# any real token position, so `kv_pos <= q_pos` excludes them.
CACHE_PAD_POSITION = 2**30


def init_cache(config, batch_size: int, max_len: int, dtype=None, device=None):
    """Per-layer dense KV cache: ``k``/``v`` [B, max_len, Hkv, D], per-slot
    positions ``pos`` [B, max_len] int32 (``CACHE_PAD_POSITION`` = dead)
    and the write ``index`` (a Python int)."""
    dev = resolve_device(device)
    dtype = dtype or config.dtype
    hkv, d = config.num_key_value_heads, config.head_dim
    return [
        {
            "k": torch.zeros(batch_size, max_len, hkv, d, dtype=dtype, device=dev),
            "v": torch.zeros(batch_size, max_len, hkv, d, dtype=dtype, device=dev),
            "pos": torch.full((batch_size, max_len), CACHE_PAD_POSITION,
                              dtype=torch.int32, device=dev),
            "index": 0,
        }
        for _ in range(config.num_hidden_layers)
    ]


def init_paged_cache(config, num_pages: int, page_size: int, num_slots: int,
                     pages_per_slot: int, dtype=None, kv_dtype=None, device=None):
    """The serving engine's paged KV pool, in the JAX layout:

    - per layer ``k_pages``/``v_pages`` ``[Hkv, num_pages, page_size, D]``;
    - ``block_tables`` ``[num_slots, pages_per_slot]`` int32;
    - ``seq_lens`` ``[num_slots]`` int32;
    - ``free_stack`` ``[num_pages]`` int32 and ``free_top`` (0-d int32),
      the allocator's free list (``serving/paged_cache.py``).

    Pages hold the model dtype; quantized int8/fp8 pages are ROADMAP B5/B6's
    quantized variants."""
    if kv_dtype not in (None, "", "bf16"):
        raise NotImplementedError(
            f"kv_dtype={kv_dtype!r}: quantized KV pages come with ROADMAP "
            "Queue B kernels #5/#7 (the quantized paged kernels)"
        )
    dev = resolve_device(device)
    dtype = dtype or config.dtype
    hkv, d = config.num_key_value_heads, config.head_dim
    shape = (hkv, num_pages, page_size, d)
    return {
        "layers": [
            {"k_pages": torch.zeros(shape, dtype=dtype, device=dev),
             "v_pages": torch.zeros(shape, dtype=dtype, device=dev)}
            for _ in range(config.num_hidden_layers)
        ],
        "block_tables": torch.zeros(num_slots, pages_per_slot, dtype=torch.int32, device=dev),
        "seq_lens": torch.zeros(num_slots, dtype=torch.int32, device=dev),
        "free_stack": torch.arange(num_pages, dtype=torch.int32, device=dev),
        "free_top": torch.tensor(num_pages, dtype=torch.int32, device=dev),
    }


def paged_gather_kv(k_pages, v_pages, block_tables):
    """Gather a ``[B, S, Hkv, D]`` linear KV view through the block table
    (``S = n * page``), plus each gathered row's within-sequence index
    ``kv_positions`` ``[B, S]`` for :func:`cached_attention`."""
    hkv, _, page, d = k_pages.shape
    b, n = block_tables.shape
    bt = block_tables.long()

    def lin(pages):
        return pages[:, bt].permute(1, 2, 3, 0, 4).reshape(b, n * page, hkv, d)

    kv_positions = torch.arange(n * page, dtype=torch.int32,
                                device=k_pages.device).expand(b, n * page)
    return lin(k_pages), lin(v_pages), kv_positions


def paged_write_kv(pages, values, page_ids, offsets, lanes=None):
    """Scatter per-token K or V rows into the page pool, **in place**.

    ``pages``: ``[Hkv, P, page, D]``; ``values``: ``[B, T, Hkv, D]``;
    ``page_ids``/``offsets``: ``[B, T]``.  ``lanes`` (a 1-D index into the
    flattened ``B * T`` tokens) keeps only the written tokens — the JAX
    function drops masked tokens through out-of-bounds ids instead, which
    PyTorch would refuse.  Returns ``pages``."""
    hkv, _, _, d = pages.shape
    flat = values.reshape(-1, hkv, d)
    pid = page_ids.reshape(-1).long()
    off = offsets.reshape(-1).long()
    if lanes is not None:
        flat, pid, off = flat[lanes], pid[lanes], off[lanes]
    pages.permute(1, 2, 0, 3).index_put_((pid, off), flat.to(pages.dtype))
    return pages


def cached_attention(q, k_cache, v_cache, kv_positions, q_positions):
    """Attention against a pre-allocated KV cache.  q: [B, T, H, D];
    k_cache/v_cache: [B, S, Hkv, D]; kv_positions: [B, S]; q_positions:
    [B, T].  The causal mask ``kv_pos <= q_pos`` doubles as the liveness
    mask; scores in the input dtype, softmax in f32."""
    b, t, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    qg = q.reshape(b, t, hkv, g, d)
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k_cache).float() / math.sqrt(d)
    mask = kv_positions[:, None, None, None, :] <= q_positions[:, None, None, :, None]
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgts,bshd->bthgd", probs, v_cache)
    return out.reshape(b, t, h, d)


@dataclasses.dataclass
class _PagedWrite:
    """Where one forward writes its K/V in the page pool — the same for
    every layer, so :class:`LlamaForCausalLM` works it out once."""

    page_ids: torch.Tensor
    offsets: torch.Tensor
    lanes: Optional[torch.Tensor]


def _paged_write_plan(block_tables, positions, page_size, cache_write_mask):
    pos = positions.to(torch.int32)
    # masked lanes (dead slots, prefill padding) may carry positions beyond
    # the block table: clamp the lookup; their write is left out below
    logical = (pos // page_size).clamp(0, block_tables.shape[1] - 1)
    page_ids = torch.gather(block_tables, 1, logical.long())
    lanes = None
    if cache_write_mask is not None:
        # one device->host sync per forward, before any layer runs
        lanes = cache_write_mask.reshape(-1).nonzero().squeeze(1)
    return _PagedWrite(page_ids, pos % page_size, lanes)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        cfg = config
        qd, kvd = cfg.num_attention_heads * cfg.head_dim, cfg.num_key_value_heads * cfg.head_dim
        self.q_proj = QuantizableDense(cfg.hidden_size, qd, cfg.dtype)
        self.k_proj = QuantizableDense(cfg.hidden_size, kvd, cfg.dtype)
        self.v_proj = QuantizableDense(cfg.hidden_size, kvd, cfg.dtype)
        self.o_proj = QuantizableDense(qd, cfg.hidden_size, cfg.dtype)

    def forward(self, x, positions, cos, sin, cache=None, cache_write_mask=None,
                paged_write: Optional[_PagedWrite] = None, attn_implementation=None,
                segment_ids=None):
        cfg = self.config
        impl = attn_implementation or cfg.attn_implementation
        b, t = x.shape[:2]
        q = self.q_proj(x).reshape(b, t, cfg.num_attention_heads, cfg.head_dim)
        k = self.k_proj(x).reshape(b, t, cfg.num_key_value_heads, cfg.head_dim)
        v = self.v_proj(x).reshape(b, t, cfg.num_key_value_heads, cfg.head_dim)
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)

        if cache is not None and "k_pages" in cache:
            # paged serving path: write this chunk's K/V through the block
            # table (in place), then attend against the slot's pages —
            # batched decode [S, 1] and one sequence's prefill chunk [1, C]
            pw = paged_write
            k_pages = paged_write_kv(cache["k_pages"], k, pw.page_ids, pw.offsets, pw.lanes)
            v_pages = paged_write_kv(cache["v_pages"], v, pw.page_ids, pw.offsets, pw.lanes)
            pos_i32 = positions.to(torch.int32)
            if impl == "flash" and t == 1:
                out = paged_decode_attention(
                    q[:, 0], k_pages, v_pages, cache["block_tables"],
                    pos_i32[:, 0].contiguous(),
                )[:, None]
            elif impl == "flash":
                out = paged_multitoken_attention(
                    q, k_pages, v_pages, cache["block_tables"], pos_i32.contiguous(),
                )
            else:
                k_lin, v_lin, kv_pos = paged_gather_kv(k_pages, v_pages, cache["block_tables"])
                out = cached_attention(q, k_lin, v_lin, kv_pos, pos_i32)
            new_cache = {"k_pages": k_pages, "v_pages": v_pages,
                         "block_tables": cache["block_tables"]}
            return self.o_proj(out.reshape(b, t, -1)), new_cache

        if cache is not None:
            # dense autoregressive path: write K/V and positions at the
            # cache index (in place), attend against the whole cache
            idx = cache["index"]
            pos_write = positions.to(torch.int32)
            if cache_write_mask is not None:
                pos_write = torch.where(cache_write_mask, pos_write,
                                        torch.full_like(pos_write, CACHE_PAD_POSITION))
            cache["k"][:, idx:idx + t] = k.to(cache["k"].dtype)
            cache["v"][:, idx:idx + t] = v.to(cache["v"].dtype)
            cache["pos"][:, idx:idx + t] = pos_write
            out = cached_attention(q, cache["k"], cache["v"], cache["pos"], positions)
            new_cache = {"k": cache["k"], "v": cache["v"], "pos": cache["pos"],
                         "index": idx + t}
            return self.o_proj(out.reshape(b, t, -1)), new_cache

        out = get_attention_impl(impl)(q, k, v, causal=True, segment_ids=segment_ids)
        return self.o_proj(out.reshape(b, t, -1))


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        cfg = config
        self.gate_proj = QuantizableDense(cfg.hidden_size, cfg.intermediate_size, cfg.dtype)
        self.up_proj = QuantizableDense(cfg.hidden_size, cfg.intermediate_size, cfg.dtype)
        self.down_proj = QuantizableDense(cfg.intermediate_size, cfg.hidden_size, cfg.dtype)

    def forward(self, x):
        return self.down_proj(torch.nn.functional.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        cfg = config
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype)
        self.self_attn = LlamaAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype)
        self.mlp = LlamaMLP(cfg)

    def forward(self, x, positions, cos, sin, cache=None, cache_write_mask=None,
                paged_write=None, attn_implementation=None, segment_ids=None):
        attn = self.self_attn(self.input_layernorm(x), positions, cos, sin, cache,
                              cache_write_mask, paged_write, attn_implementation,
                              segment_ids)
        new_cache = None
        if cache is not None:
            attn, new_cache = attn
        h = x + attn
        out = h + self.mlp(self.post_attention_layernorm(h))
        return (out, new_cache) if cache is not None else out


class LMHead(nn.Module):
    """Vocab projection with bf16 operands and **f32 logits**.

    On the card the product is one cuBLAS GEMM that takes bf16 operands,
    accumulates in f32 and writes f32 (``torch.mm(..., out_dtype=
    torch.float32)``), so the logits are never rounded to bf16 — the JAX
    head's ``preferred_element_type=float32``.  On the CPU the operands are
    widened to f32 first (bf16 values are exact in f32), which computes the
    same sums."""

    def __init__(self, hidden: int, vocab_size: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(vocab_size, hidden, dtype=dtype))

    def forward(self, x):
        x2 = x.reshape(-1, x.shape[-1]).to(self.weight.dtype)
        if x2.device.type == "cuda" and self.weight.dtype != torch.float32:
            y = torch.mm(x2, self.weight.t(), out_dtype=torch.float32)
        else:
            y = x2.float() @ self.weight.float().t()
        return y.reshape(*x.shape[:-1], -1)


class _LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        cfg = config
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype)
        self.layers = nn.ModuleList(LlamaBlock(cfg) for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype)


class LlamaForCausalLM(nn.Module):
    """Decoder LM.  ``forward(input_ids, positions=None, segment_ids=None,
    output_hidden=False, cache=None, cache_write_mask=None,
    attn_implementation=None)`` returns f32 logits ``[B, T, V]`` — or the
    final-norm hidden states ``[B, T, H]`` with ``output_hidden`` (the fused
    linear + CE loss applies the head itself) — or ``(logits, new_cache)``
    with a cache (dense from :func:`init_cache`, or the per-layer paged
    views the serving engine builds).  Caches are updated in place;
    ``new_cache`` holds the same tensors.  ``segment_ids`` [B, T] masks
    cross-segment attention (packed sequences, uncached forward only).
    ``attn_implementation`` overrides the config's for one call (the
    serving engine's ``decode_kernel``).

    Built on ``device`` (``"cuda"`` unless the caller asks for the CPU)
    with random weights from ``seed``; ``load_state_dict`` replaces them
    (``models/convert.py`` builds one from a JAX param tree).  Parameters
    are trainable; the serving engine and ``generate`` run under
    ``torch.inference_mode()``."""

    def __init__(self, config: LlamaConfig, *, device=None, seed: int = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        with torch.device(dev):
            self.model = _LlamaModel(config)
            self.lm_head = LMHead(config.hidden_size, config.vocab_size, config.dtype)
        cos, sin = rope_frequencies(config.head_dim, config.max_position_embeddings,
                                    config.rope_theta)
        self.register_buffer("rope_cos", torch.from_numpy(cos).to(dev), persistent=False)
        self.register_buffer("rope_sin", torch.from_numpy(sin).to(dev), persistent=False)
        self._init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        """Linear weights ~ N(0, 1/fan_in), embeddings ~ N(0, 1), norm
        scales 1 — drawn on the model's device from ``seed``.  The two
        projections that write into the residual stream (``o_proj``,
        ``down_proj``) are further scaled by ``1 / (2 * layers)``, so the
        stream stays dominated by its input.  A random bf16 model of 16
        layers without it (or with GPT-2's milder ``1/sqrt(2 * layers)``)
        is chaotic: one bf16 rounding that lands the other way in one
        attention output grows into the logits until a kernel and its
        plain version no longer agree on the argmax at 98 % of
        positions."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        residual_scale = 1.0 / (2 * self.config.num_hidden_layers)
        for name, p in self.named_parameters():
            if name.endswith("layernorm.weight") or name == "model.norm.weight":
                p.fill_(1.0)
                continue
            std = 1.0 if "embed_tokens" in name else 1.0 / math.sqrt(p.shape[1])
            if name.endswith(("o_proj.weight", "down_proj.weight")):
                std *= residual_scale
            p.copy_(torch.randn(p.shape, generator=gen, device=self.device) * std)

    def forward(self, input_ids, positions=None, segment_ids=None, output_hidden: bool = False,
                cache=None, cache_write_mask=None, attn_implementation: Optional[str] = None):
        b, t = input_ids.shape
        if positions is None:
            base = torch.arange(t, device=input_ids.device)
            if cache is not None:
                if "index" not in cache[0]:
                    raise ValueError(
                        "paged layer caches have no global write index — pass "
                        "explicit positions (the serving engine always does)"
                    )
                base = base + cache[0]["index"]
            positions = base.expand(b, t)
        paged_write = None
        if cache is not None and "k_pages" in cache[0]:
            paged_write = _paged_write_plan(cache[0]["block_tables"], positions,
                                            cache[0]["k_pages"].shape[2], cache_write_mask)
        x = self.model.embed_tokens(input_ids)
        new_cache = [] if cache is not None else None
        for i, layer in enumerate(self.model.layers):
            if cache is not None:
                x, layer_cache = layer(x, positions, self.rope_cos, self.rope_sin,
                                       cache[i], cache_write_mask, paged_write,
                                       attn_implementation)
                new_cache.append(layer_cache)
            else:
                x = layer(x, positions, self.rope_cos, self.rope_sin,
                          attn_implementation=attn_implementation, segment_ids=segment_ids)
        x = self.model.norm(x)
        if output_hidden:
            return (x, new_cache) if cache is not None else x
        logits = self.lm_head(x)
        return (logits, new_cache) if cache is not None else logits


def causal_lm_loss(logits, labels, ignore_index: int = -100, shifted: bool = False):
    """Shifted next-token cross-entropy, ``logsumexp - label_logit`` in f32
    (JAX ``causal_lm_loss``).  ``shifted=True``: ``labels`` are already
    next-token aligned with ``logits``."""
    if shifted:
        logits = logits.float()
    else:
        logits = logits[:, :-1].float()
        labels = labels[:, 1:]
    mask = labels != ignore_index
    safe = torch.where(mask, labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = lse - label_logit
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)


def _apply(model, params, input_ids, **kwargs):
    """``model`` run with ``params`` (a name -> tensor dict over its
    parameters, as a train state holds them) in place of its own; with
    ``params=None``, its own."""
    if params is None:
        return model(input_ids, **kwargs)
    return torch.func.functional_call(model, params, (input_ids,), kwargs)


def make_llama_loss_fn(model: LlamaForCausalLM, fused_vocab_chunks: Optional[int] = None):
    """``loss_fn(params, batch)`` for ``Accelerator.prepare_train_step``
    (JAX ``make_llama_loss_fn``).  ``batch`` holds ``input_ids`` and
    ``labels`` (or pre-shifted ``shift_labels``), optionally
    ``segment_ids``.  With ``fused_vocab_chunks``, the head moves inside
    the chunked fused linear + CE (``ops/fused_xent.py``), so the ``[B, T,
    V]`` logits never exist; the port's head weight is ``[V, H]``, the
    ``vocab_major`` layout."""
    if fused_vocab_chunks is None:
        def loss_fn(params, batch):
            logits = _apply(model, params, batch["input_ids"],
                            segment_ids=batch.get("segment_ids"))
            if "shift_labels" in batch:
                return causal_lm_loss(logits, batch["shift_labels"], shifted=True)
            return causal_lm_loss(logits, batch["labels"])

        return loss_fn

    from ..ops.fused_xent import fused_causal_lm_loss

    cfg = model.config

    def fused_loss_fn(params, batch):
        hidden = _apply(model, params, batch["input_ids"],
                        segment_ids=batch.get("segment_ids"), output_hidden=True)
        head = (params if params is not None else dict(model.named_parameters()))
        weight = head["lm_head.weight"].to(cfg.dtype)  # [V, H]
        shifted = "shift_labels" in batch
        return fused_causal_lm_loss(
            hidden, weight, batch["shift_labels"] if shifted else batch["labels"],
            vocab_major=True, num_chunks=fused_vocab_chunks, shifted=shifted,
        )

    return fused_loss_fn


def count_params(params) -> int:
    """Elements of a module's parameters or of a name -> tensor dict."""
    tensors = params.parameters() if isinstance(params, nn.Module) else params.values()
    return sum(int(t.numel()) for t in tensors)


def flops_per_token(cfg: LlamaConfig, seq_len: int) -> float:
    """Training FLOPs per token, ``6 N + 12 L H D T`` (the PaLM appendix
    formula; JAX ``flops_per_token``, untied head)."""
    n_params = (
        cfg.vocab_size * cfg.hidden_size * 2
        + cfg.num_hidden_layers * (
            cfg.hidden_size * cfg.head_dim * (cfg.num_attention_heads + 2 * cfg.num_key_value_heads)
            + cfg.num_attention_heads * cfg.head_dim * cfg.hidden_size
            + 3 * cfg.hidden_size * cfg.intermediate_size
            + 2 * cfg.hidden_size
        )
        + cfg.hidden_size
    )
    attn_flops = 12 * cfg.num_hidden_layers * cfg.num_attention_heads * cfg.head_dim * seq_len
    return 6 * n_params + attn_flops
