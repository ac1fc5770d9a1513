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

Paged pools may hold int8 or e4m3 codes (``init_paged_cache(kv_dtype=)``,
JAX :247-316): the paged branch then quantizes on write
(:func:`paged_write_kv_quantized`) and hands the per-(kv head, page)
scales to the kernels (#5 / #7) or to the native gather.

Multi-tenant LoRA (JAX :478-480, :562-608, :731-737): ``forward(...,
adapter_ids=, lora=)`` threads per-row pool-slot ids and the adapter pool
(``{module name: {"a", "b"}}``, passed on every call as JAX passes its
``lora`` collection, so the model always reads the current slots) to every
dense and the head; the targeted ones add their adapter delta
(``ops/lora.py``).

Memory recipes (JAX :35-101, :634-666, :786-868):

- ``remat=True`` recomputes each decoder layer in the backward
  (``torch.utils.checkpoint``, non-reentrant).  ``remat_policy="full"``
  saves nothing inside a layer; ``"dots"`` saves the cuBLAS products
  (``aten.mm`` / ``addmm`` outputs: JAX's
  ``dots_with_no_batch_dims_saveable``) and recomputes the rest, flash
  attention #1 included; ``"offload"`` keeps only each layer's (or scan
  iteration's) input boundary, its head slice of
  ``boundary_offload_fraction`` of the sequence copied to page-locked host
  memory on a side stream and fetched back for the backward
  (:class:`_BoundaryOffload`; ``boundary_stats`` counts the bytes).
- ``scan_layers=True`` holds the layer weights stacked on a leading axis
  under ``model.layers_scan.block`` (``block_{j}`` with ``scan_block_size``
  j > 1: global layer i is iteration i // j, slot i % j) and runs one
  layer module's forward over each slice (``torch.func.functional_call``);
  :func:`stack_layer_params` / :func:`unstack_layer_params` convert a
  state between the layouts.  The cached paths (``generate``, the serving
  engine) run a scanned model layer by layer the same way.

fp8 compute runs in the dense layers (``models/layers.py``) and the head.

Tensor and sequence parallelism (JAX :462-474, :602-607, :738-757): under
an accelerator's mesh with ``tp > 1`` whose train state holds the plan's
tp shards (``parallel/sharding.py``'s ``TRANSFORMER_TP_RULES``), each
rank's forward runs on its shards, the Megatron split made explicit
(:class:`ParallelForward`):

- the embedding is vocab-parallel: ids outside the rank's rows read
  zeros, the lookups meet in a ``psum`` over ``tp``;
- attention runs on the rank's heads (H/tp q heads and the kv heads they
  read) behind column-parallel q / k / v, MLP on its I/tp features behind
  column-parallel gate / up, each closed by a row-parallel o_proj /
  down_proj whose partial sums meet in a ``psum``; the replicated input
  enters through ``pbroadcast`` (its gradient summed over ``tp``);
- collective-matmul modes ``ring`` / ``bidir`` (where the local sequence
  splits over ``tp``): the activations between the denses are
  sequence-sharded over ``tp``; the column denses gather the sequence
  inside their ring product and the row denses reduce-scatter it
  (``ops/collective_matmul.py``), the embedding reduce-scatters, and the
  norms' replicated weights take ``pbroadcast``;
- the head is column-parallel over the vocabulary (the ring gathers the
  sequence inside its product); logits come back whole
  (``all_gather_invariant``), the hidden states of ``output_hidden`` as
  the input of the vocab-parallel loss (``ops/fused_xent.py``: their
  gradient is summed over ``tp``).

Head counts ``tp`` does not divide (JAX's plan shards q / k / v wherever
their features divide, GSPMD re-lays the half heads): the rank gathers
the q / k / v features over ``tp``, attends over the heads its o_proj
rows read (kv repeated to q width) and keeps its features.

Whether a forward runs the tp split is read per leaf (the embedding, the
head, each dense of the first layer): quantized denses hold whole codes
beside a vocab-sharded embedding and head.  LoRA adapters reach every
dense and the vocab-sharded head (each takes its part of the whole pool,
``models/layers.py``).  A forward with LoRA or quantized denses runs with
the collective matmul off, as does a cached one.

Cached decoding under tp (``generate``, ``beam_search``, the serving
engine on a rank's module from ``parallel.sharding.bind_tp_slices``): the
rank's query heads and the kv heads they read (:func:`rank_heads`; where
tp does not divide the kv heads, k / v's features are gathered and the
rank keeps the one its query heads share), its dense cache or page pools
holding those kv heads only (:meth:`LlamaForCausalLM.cache_kv_heads`), the
paged kernels launched on them, o_proj's partial sums in a ``psum``, the
vocab-parallel head's f32 logits gathered whole (``all_gather_invariant``):
every rank samples the same token.  The scanned stack runs under tp as the
unrolled one, each scan slice on its tp slices of the stacked weights.
``attn_implementation="ulysses"`` is Ulysses sequence parallelism over
``sp`` (``parallel/sequence_parallel.py``): each rank holds a contiguous
slice of the sequence, and its rotary embeddings take the tokens' global
positions.  With the collective matmul on and ``tp`` trivial, q / k / v
ring over ``sp`` and o_proj ring-scatters back, so the all_to_alls leave
the forward (``ulysses_sp_boundary``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import re
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.flash_attention import (
    flash_attention,
    gather_pages,
    paged_decode_attention,
    paged_multitoken_attention,
)
from ..ops.fp8 import fp8_delayed_dot, fp8_meta
from ..ops.lora import lora_apply
from ..ops.precision import fp8_current_scaled_dot, fp8_enabled
from ..parallel import collectives as C
from ..utils.device import resolve_device
from .layers import DenseRoute, QuantizableDense, tp_linear


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
    tie_word_embeddings: bool = False
    attn_implementation: str = "native"  # native | flash | ring | ulysses
    remat: bool = False
    # with remat: "full" recomputes everything, "dots" saves the matmul
    # outputs, "offload" keeps only the layer boundaries, on the host
    remat_policy: str = "full"
    # the layer stack's weights stacked on a leading axis, one layer module
    # run over each slice; scan_block_size layers per iteration
    scan_layers: bool = False
    scan_block_size: int = 1
    # share of each offloaded boundary (its head along the sequence) that
    # goes to pinned host memory; the tail stays on the card
    boundary_offload_fraction: float = 1.0
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.attn_implementation not in ("native", "flash", "ring", "ulysses"):
            raise ValueError(
                f"attn_implementation must be 'native', 'flash', 'ring' or 'ulysses', got "
                f"{self.attn_implementation!r}")
        if self.remat_policy not in ("full", "dots", "offload"):
            raise ValueError(
                f"remat_policy must be 'full', 'dots' or 'offload', got {self.remat_policy!r}")
        if not 0.0 < self.boundary_offload_fraction <= 1.0:
            raise ValueError(
                f"boundary_offload_fraction={self.boundary_offload_fraction} must be in (0, 1] "
                "(1.0 = all boundaries pinned-host; smaller keeps the tail slice of each "
                "boundary in device memory)")
        if self.scan_block_size != 1:
            if not self.scan_layers:
                raise ValueError("scan_block_size > 1 requires scan_layers=True "
                                 "(the unrolled stack never consults it)")
            if self.scan_block_size < 1 or self.num_hidden_layers % self.scan_block_size:
                raise ValueError(f"scan_block_size={self.scan_block_size} must divide "
                                 f"num_hidden_layers={self.num_hidden_layers}")

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

    def forward(self, x: torch.Tensor, par: Optional["ParallelForward"] = None) -> torch.Tensor:
        x32 = x.float()
        normed = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + self.eps)
        weight = self.weight
        if par is not None and par.seq_sharded:
            # each tp rank normalises its own tokens: the replicated
            # weight's gradient is the sum of the ranks'
            weight = C.pbroadcast(weight, "tp", par.mesh)
        return (normed * weight).to(self.dtype)


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
    if name == "ring":
        from ..parallel.context_parallel import ring_attention

        return ring_attention
    if name == "ulysses":
        from ..parallel.sequence_parallel import ulysses_attention

        return ulysses_attention
    raise ValueError(f"unknown attention implementation {name!r}")


# Sentinel position for unwritten / padding dense-cache slots: larger than
# any real token position, so `kv_pos <= q_pos` excludes them.
CACHE_PAD_POSITION = 2**30


def init_cache(config, batch_size: int, max_len: int, dtype=None, device=None,
               num_kv_heads: Optional[int] = None):
    """Per-layer dense KV cache: ``k``/``v`` [B, max_len, Hkv, D], per-slot
    positions ``pos`` [B, max_len] int32 (``CACHE_PAD_POSITION`` = dead)
    and the write ``index`` (a Python int).  ``num_kv_heads``: the kv heads
    the cache holds (a tp rank's, :meth:`LlamaForCausalLM.cache_kv_heads`;
    default all of the config's)."""
    dev = resolve_device(device)
    dtype = dtype or config.dtype
    hkv, d = num_kv_heads or config.num_key_value_heads, config.head_dim
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


# Quantized KV page dtypes (per-(kv head, page) scales; serving/paged_cache
# kv_page_bytes carries the matching accounting).  Codes are symmetric:
# q = round(v * QMAX / amax), dequant = q * (amax / QMAX); the amax lives in
# k_scales / v_scales f32 arrays next to the pages (JAX :247-248).
KV_QUANT_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
KV_QUANT_QMAX = {"int8": 127.0, "fp8": 448.0}


def resolve_kv_dtype(kv_dtype):
    """``None`` / ``""`` / ``"bf16"`` mean the model dtype (no scales);
    ``"int8"`` / ``"fp8"`` arm quantized pages (JAX ``resolve_kv_dtype``)."""
    if kv_dtype in (None, "", "bf16"):
        return None
    if kv_dtype not in KV_QUANT_DTYPES:
        raise ValueError(f"kv_dtype must be '', 'bf16', 'int8' or 'fp8', got {kv_dtype!r}")
    return kv_dtype


def kv_dtype_of(pages) -> str:
    """The ``kv_dtype`` name of a quantized page pool."""
    return "int8" if pages.dtype == torch.int8 else "fp8"


def init_paged_cache(config, num_pages: int, page_size: int, num_slots: int,
                     pages_per_slot: int, dtype=None, kv_dtype=None, device=None,
                     num_kv_heads: Optional[int] = None):
    """The serving engine's paged KV pool, in the JAX layout:

    - per layer ``k_pages``/``v_pages`` ``[Hkv, num_pages, page_size, D]``;
      with ``kv_dtype`` ``"int8"`` / ``"fp8"``, int8 / e4m3 codes at one
      byte per element plus ``k_scales``/``v_scales`` ``[Hkv, num_pages]``
      f32, each page's running amax (0: no content yet);
    - ``block_tables`` ``[num_slots, pages_per_slot]`` int32;
    - ``seq_lens`` ``[num_slots]`` int32;
    - ``free_stack`` ``[num_pages]`` int32 and ``free_top`` (0-d int32),
      the allocator's free list (``serving/paged_cache.py``).

    ``num_kv_heads``: the kv heads the pages hold (a tp rank's, default all
    of the config's)."""
    kv_dtype = resolve_kv_dtype(kv_dtype)
    dev = resolve_device(device)
    dtype = dtype or config.dtype
    hkv, d = num_kv_heads or config.num_key_value_heads, config.head_dim
    shape = (hkv, num_pages, page_size, d)
    page_dtype = KV_QUANT_DTYPES[kv_dtype] if kv_dtype else dtype

    def layer():
        entry = {"k_pages": torch.zeros(shape, dtype=page_dtype, device=dev),
                 "v_pages": torch.zeros(shape, dtype=page_dtype, device=dev)}
        if kv_dtype:
            entry["k_scales"] = torch.zeros(hkv, num_pages, dtype=torch.float32, device=dev)
            entry["v_scales"] = torch.zeros(hkv, num_pages, dtype=torch.float32, device=dev)
        return entry

    return {
        "layers": [layer() for _ in range(config.num_hidden_layers)],
        "block_tables": torch.zeros(num_slots, pages_per_slot, dtype=torch.int32, device=dev),
        "seq_lens": torch.zeros(num_slots, dtype=torch.int32, device=dev),
        "free_stack": torch.arange(num_pages, dtype=torch.int32, device=dev),
        "free_top": torch.tensor(num_pages, dtype=torch.int32, device=dev),
    }


def paged_gather_kv(k_pages, v_pages, block_tables, k_scales=None, v_scales=None,
                    out_dtype=None):
    """Gather a ``[B, S, Hkv, D]`` linear KV view through the block table
    (``S = n * page``), plus each gathered row's within-sequence index
    ``kv_positions`` ``[B, S]`` for :func:`cached_attention`.  Quantized
    pages pass their scales and ``out_dtype``: the gathered codes
    dequantize to ``f32(code) * (amax / QMAX)`` in ``out_dtype`` (default
    f32); JAX's ``kv_dtype`` argument is the pages' own dtype here."""
    hkv, _, page, d = k_pages.shape
    b, n = block_tables.shape
    bt = block_tables.long()

    def lin(pages, scales):
        g = gather_pages(pages, bt)                      # [Hkv, B, n, page, D]
        if scales is not None:
            s = (scales / KV_QUANT_QMAX[kv_dtype_of(pages)])[:, bt]
            g = (g.float() * s[..., None, None]).to(out_dtype or torch.float32)
        return g.permute(1, 2, 3, 0, 4).reshape(b, n * page, hkv, d)

    kv_positions = torch.arange(n * page, dtype=torch.int32,
                                device=k_pages.device).expand(b, n * page)
    return lin(k_pages, k_scales), lin(v_pages, v_scales), kv_positions


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


def _bits(pages):
    """An int8 / uint8 view that PyTorch scatters and gathers for both
    quantized page dtypes (few ops take float8)."""
    return pages.view(torch.uint8) if pages.dtype == torch.float8_e4m3fn else pages


def _to_codes(values, page_dtype):
    """f32 values already rounded / clipped as codes -> the pool's bit
    patterns (``_bits`` dtype)."""
    codes = values.to(page_dtype)
    return codes.view(torch.uint8) if page_dtype == torch.float8_e4m3fn else codes


def paged_write_kv_quantized(pages, scales, values, page_ids, offsets, kv_dtype: str,
                             lanes=None, plan=None):
    """Quantize-on-write into int8 / e4m3 pages with per-(kv head, page)
    running amaxes, **in place** — bitwise JAX's ``paged_write_kv_quantized``:

    1. an offset-0 write opens its page: the page's amax resets to 0 (a
       recycled page never inherits the previous tenant's range);
    2. the amax becomes the running max over every row written so far;
    3. the touched pages' existing codes rescale to the final amax
       (``codes * old / new``; int8 rounded half to even and clipped);
    4. the new rows quantize under the final amax (``v * QMAX / amax``,
       0 where the amax is 0; int8 rounded, both clipped to +-QMAX).

    JAX rescales the touched pages once per written row; every duplicate
    writes identical values, so rescaling each distinct page once gives
    the same bits.  ``lanes`` keeps only the written tokens (JAX drops
    masked ones through out-of-bounds ids in every scatter).  ``plan``, the
    forward's :class:`_QuantWritePlan`, gives the opened and touched pages,
    the same for every layer (each costs a device-to-host sync to find).
    e4m3 pages are scattered through their bit patterns.  Returns
    ``(pages, scales)``."""
    hkv, _, _, d = pages.shape
    qmax = KV_QUANT_QMAX[kv_dtype]
    flat = values.reshape(-1, hkv, d)
    pid = page_ids.reshape(-1).long()
    off = offsets.reshape(-1).long()
    if lanes is not None:
        flat, pid, off = flat[lanes], pid[lanes], off[lanes]
    vals = flat.permute(1, 0, 2).float()                      # [Hkv, N, D]
    row_amax = vals.abs().amax(dim=-1)                        # [Hkv, N]
    plan = plan or _QuantWritePlan.of(pid, off)
    # 1. open fresh pages
    scales[:, plan.opened] = 0.0
    touched = plan.touched
    old_touched = scales[:, touched]
    # 2. running max over this call's rows
    scales.scatter_reduce_(1, pid[None].expand(hkv, -1), row_amax, reduce="amax")
    fin = scales[:, pid]                                      # [Hkv, N]
    fin_touched = scales[:, touched]
    # 3. rescale each touched page's existing codes to the final amax
    ratio = torch.where(fin_touched > 0,
                        old_touched / torch.clamp_min(fin_touched, 1e-30), 1.0)
    bits = _bits(pages)
    rescaled = bits[:, touched].view(pages.dtype).float() * ratio[:, :, None, None]
    if pages.dtype == torch.int8:
        rescaled = torch.clamp(torch.round(rescaled), -qmax, qmax)
    bits[:, touched] = _to_codes(rescaled, pages.dtype)
    # 4. quantize the new rows under the final amax
    q = vals * (qmax / torch.clamp_min(fin, 1e-30))[:, :, None]
    q = torch.where(fin[:, :, None] > 0, q, 0.0)
    if pages.dtype == torch.int8:
        q = torch.round(q)
    q = torch.clamp(q, -qmax, qmax)
    bits.permute(1, 2, 0, 3).index_put_((pid, off), _to_codes(q, pages.dtype).permute(1, 0, 2))
    return pages, scales


def dequantize_kv_pages(pages, scales, kv_dtype: str, dtype):
    """Whole-pool dequantize, ``codes * (amax / QMAX)`` in ``dtype`` (JAX
    ``dequantize_kv_pages``)."""
    qmax = KV_QUANT_QMAX[kv_dtype]
    return (pages.float() * (scales / qmax)[:, :, None, None]).to(dtype)


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
class _QuantWritePlan:
    """The pages a quantized write opens (an offset-0 row) and touches
    (distinct ids), over the written lanes."""

    opened: torch.Tensor
    touched: torch.Tensor

    @classmethod
    def of(cls, pid, off):
        return cls(pid[off == 0], torch.unique(pid))


@dataclasses.dataclass
class _PagedWrite:
    """Where one forward writes its K/V in the page pool — the same for
    every layer, so :class:`LlamaForCausalLM` works it out once."""

    page_ids: torch.Tensor
    offsets: torch.Tensor
    lanes: Optional[torch.Tensor]
    quant: Optional[_QuantWritePlan] = None


def _paged_write_plan(block_tables, positions, page_size, cache_write_mask, quantized=False):
    pos = positions.to(torch.int32)
    # masked lanes (dead slots, prefill padding) may carry positions beyond
    # the block table: clamp the lookup; their write is left out below
    logical = (pos // page_size).clamp(0, block_tables.shape[1] - 1)
    page_ids = torch.gather(block_tables, 1, logical.long())
    offsets = pos % page_size
    lanes = None
    if cache_write_mask is not None:
        # one device->host sync per forward, before any layer runs
        lanes = cache_write_mask.reshape(-1).nonzero().squeeze(1)
    quant = None
    if quantized:
        # and, for quantized pages, two more, not two per layer and K/V
        pid, off = page_ids.reshape(-1).long(), offsets.reshape(-1)
        if lanes is not None:
            pid, off = pid[lanes], off[lanes]
        quant = _QuantWritePlan.of(pid, off)
    return _PagedWrite(page_ids, offsets, lanes, quant)


@dataclasses.dataclass(frozen=True)
class ParallelForward:
    """How one uncached forward lies over the ambient mesh: ``tp`` ranks
    holding weight shards (1 when the weights are whole) and this rank's
    place among them, ``sp`` ranks of a contiguous sequence split, the
    collective-matmul ``mode`` of the tp layout (``off``: activations
    replicated over ``tp``) and whether the Ulysses boundary rings over
    ``sp`` (``sp_mode``, else ``off``)."""

    mesh: object
    tp: int
    tp_rank: int
    sp: int
    sp_rank: int
    mode: str
    sp_mode: str

    @property
    def seq_sharded(self) -> bool:
        """The activations between denses are sequence-sharded over tp."""
        return self.tp > 1 and self.mode != "off"

    @property
    def sp_boundary(self) -> bool:
        return self.sp_mode != "off"

    def tp_route(self) -> Optional[DenseRoute]:
        return DenseRoute(self.mesh, "tp", self.mode) if self.tp > 1 else None

    def tp_input(self, x):
        """A replicated activation read by the column denses of every tp
        rank (mode off): its gradient is summed over ``tp`` (no collective
        where no gradient is taken)."""
        if self.tp > 1 and self.mode == "off" and torch.is_grad_enabled():
            return C.pbroadcast(x, "tp", self.mesh)
        return x


def rank_heads(config, tp: int, rank: int) -> tuple[int, int, int, int]:
    """``(h0, h1, kv0, kv1)``: the query heads ``[h0, h1)`` tp rank ``rank``
    of ``tp`` attends over in a cached forward and the kv heads ``[kv0,
    kv1)`` they read, which its cache holds.  Where ``tp`` divides the kv
    heads a rank holds ``Hkv / tp`` of them; where it does not (tiny's 2 at
    tp 4) the one its query heads share.  Query heads ``tp`` does not
    divide, or a rank's query heads reading more than one kv head unevenly,
    are not ported (ROADMAP item A13h.7)."""
    h, hkv = config.num_attention_heads, config.num_key_value_heads
    rep = h // hkv
    if h % tp:
        raise NotImplementedError(f"cached decoding where tp={tp} does not divide the "
                                  f"{h} query heads is not ported yet (ROADMAP item A13h.7)")
    hq = h // tp
    h0 = rank * hq
    kv0, kv1 = h0 // rep, (h0 + hq - 1) // rep + 1
    if hq % (kv1 - kv0) or any((h0 + j) // rep - kv0 != j // (hq // (kv1 - kv0))
                               for j in range(hq)):
        raise NotImplementedError(f"cached decoding where tp={tp} splits the query groups "
                                  f"of {hkv} kv heads unevenly is not ported yet (ROADMAP "
                                  f"item A13h.7)")
    return h0, h0 + hq, kv0, kv1


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
                segment_ids=None, adapter_ids=None, lora=None,
                par: Optional[ParallelForward] = None):
        cfg = self.config
        impl = attn_implementation or cfg.attn_implementation
        if par is not None and cache is None:
            return self._parallel_forward(x, positions, cos, sin, impl, segment_ids, par,
                                          adapter_ids, lora)
        b, t = x.shape[:2]
        route = par.tp_route() if par is not None else None
        if route is None:
            q = self.q_proj(x, adapter_ids, lora).reshape(b, t, cfg.num_attention_heads,
                                                          cfg.head_dim)
            k = self.k_proj(x, adapter_ids, lora).reshape(b, t, cfg.num_key_value_heads,
                                                          cfg.head_dim)
            v = self.v_proj(x, adapter_ids, lora).reshape(b, t, cfg.num_key_value_heads,
                                                          cfg.head_dim)
        else:
            q, k, v = self._rank_qkv(x, adapter_ids, lora, par, route)
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)

        if cache is not None and "k_pages" in cache:
            # paged serving path: write this chunk's K/V through the block
            # table (in place), then attend against the slot's pages —
            # batched decode [S, 1] and one sequence's prefill chunk [1, C]
            pw = paged_write
            scales = {}
            if "k_scales" in cache:
                # int8 / e4m3 pages: quantize on write against each page's
                # running amax; the kv dtype is the stored codes' own
                kv_dtype = kv_dtype_of(cache["k_pages"])
                k_pages, k_scales = paged_write_kv_quantized(
                    cache["k_pages"], cache["k_scales"], k, pw.page_ids, pw.offsets,
                    kv_dtype, pw.lanes, pw.quant)
                v_pages, v_scales = paged_write_kv_quantized(
                    cache["v_pages"], cache["v_scales"], v, pw.page_ids, pw.offsets,
                    kv_dtype, pw.lanes, pw.quant)
                scales = {"k_scales": k_scales, "v_scales": v_scales}
            else:
                k_pages = paged_write_kv(cache["k_pages"], k, pw.page_ids, pw.offsets, pw.lanes)
                v_pages = paged_write_kv(cache["v_pages"], v, pw.page_ids, pw.offsets, pw.lanes)
            pos_i32 = positions.to(torch.int32)
            if impl == "flash" and t == 1:
                out = paged_decode_attention(
                    q[:, 0], k_pages, v_pages, cache["block_tables"],
                    pos_i32[:, 0].contiguous(), **scales,
                )[:, None]
            elif impl == "flash":
                out = paged_multitoken_attention(
                    q, k_pages, v_pages, cache["block_tables"], pos_i32.contiguous(), **scales,
                )
            else:
                k_lin, v_lin, kv_pos = paged_gather_kv(
                    k_pages, v_pages, cache["block_tables"], scales.get("k_scales"),
                    scales.get("v_scales"), cfg.dtype)
                out = cached_attention(q, k_lin, v_lin, kv_pos, pos_i32)
            new_cache = {"k_pages": k_pages, "v_pages": v_pages,
                         "block_tables": cache["block_tables"], **scales}
            return self.o_proj(out.reshape(b, t, -1), adapter_ids, lora, route=route), new_cache

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
            return self.o_proj(out.reshape(b, t, -1), adapter_ids, lora, route=route), new_cache

        out = get_attention_impl(impl)(q, k, v, causal=True, segment_ids=segment_ids)
        return self.o_proj(out.reshape(b, t, -1), adapter_ids, lora)

    def _rank_qkv(self, x, adapter_ids, lora, par: ParallelForward, route: DenseRoute):
        """A cached forward's q / k / v on this tp rank: its query heads
        and the kv heads they read (:func:`rank_heads`), ``[B, T, heads,
        D]``.  q / k / v are column slices; where tp does not divide the kv
        heads, k / v's features are gathered over ``tp`` and the rank keeps
        the kv heads its query heads read."""
        cfg = self.config
        d = cfg.head_dim
        b, t = x.shape[:2]
        h0, h1, kv0, kv1 = rank_heads(cfg, par.tp, par.tp_rank)
        q = self.q_proj(x, adapter_ids, lora, route=route).reshape(b, t, h1 - h0, d)
        k = self.k_proj(x, adapter_ids, lora, route=route)
        v = self.v_proj(x, adapter_ids, lora, route=route)
        if cfg.num_key_value_heads % par.tp:
            k, v = (C.all_gather(z.contiguous(), "tp", axis=2, mesh=par.mesh)
                    .reshape(b, t, cfg.num_key_value_heads, d)[:, :, kv0:kv1] for z in (k, v))
            return q, k.contiguous(), v.contiguous()
        return q, k.reshape(b, t, kv1 - kv0, d), v.reshape(b, t, kv1 - kv0, d)

    def _parallel_forward(self, x, positions, cos, sin, impl, segment_ids,
                          par: ParallelForward, adapter_ids=None, lora=None):
        """One rank's attention under tp and / or sp (see the module doc):
        the column q / k / v on this rank's shards (rings over ``sp`` at
        the Ulysses boundary), rotary embeddings at the global positions,
        attention over the rank's heads, the row o_proj; LoRA adapters on
        each targeted dense (``models/layers.py``)."""
        cfg = self.config
        d = cfg.head_dim
        if par.sp_boundary:
            route = DenseRoute(par.mesh, "sp", par.sp_mode)
            x_in = x
            # q / k / v come back over the whole sequence, head-sharded
            positions = C.all_gather(positions.contiguous(), "sp", axis=1, mesh=par.mesh)
            if segment_ids is not None:
                segment_ids = C.all_gather(segment_ids.contiguous(), "sp", axis=1,
                                           mesh=par.mesh)
        else:
            route = par.tp_route()
            x_in = par.tp_input(x)
        q = self.q_proj(x_in, adapter_ids, lora, route=route)
        k = self.k_proj(x_in, adapter_ids, lora, route=route)
        v = self.v_proj(x_in, adapter_ids, lora, route=route)
        b, t = q.shape[:2]
        attend = get_attention_impl(impl)
        kw = {"heads_sharded": True} if par.sp_boundary else {}
        qf, kvf = q.shape[-1], k.shape[-1]
        h, hkv, p = cfg.num_attention_heads, cfg.num_key_value_heads, par.tp
        if route is not None and route.axis == "tp" and (h % p or hkv % p):
            # heads split by the features: gather them, attend over the
            # heads this rank's o_proj rows read, keep its features
            i = par.tp_rank
            qa, ka, va = (C.all_gather(z.contiguous(), "tp", axis=2, mesh=par.mesh)
                          for z in (q, k, v))
            h0, h1 = i * qf // d, -(-(i + 1) * qf // d)
            rep = h // hkv
            q = qa.reshape(b, t, h, d)[:, :, h0:h1]
            k = ka.reshape(b, t, hkv, d).repeat_interleave(rep, dim=2)[:, :, h0:h1]
            v = va.reshape(b, t, hkv, d).repeat_interleave(rep, dim=2)[:, :, h0:h1]
            q = apply_rope(q, cos, sin, positions)
            k = apply_rope(k, cos, sin, positions)
            out = attend(q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
                         segment_ids=segment_ids, **kw).reshape(b, t, -1)
            start = i * qf - h0 * d
            out = out[..., start:start + qf]
        else:
            q = apply_rope(q.reshape(b, t, qf // d, d), cos, sin, positions)
            k = apply_rope(k.reshape(b, t, kvf // d, d), cos, sin, positions)
            v = v.reshape(b, t, kvf // d, d)
            out = attend(q, k, v, causal=True, segment_ids=segment_ids, **kw).reshape(b, t, -1)
        return self.o_proj(out, adapter_ids, lora, route=route)


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        cfg = config
        self.gate_proj = QuantizableDense(cfg.hidden_size, cfg.intermediate_size, cfg.dtype)
        self.up_proj = QuantizableDense(cfg.hidden_size, cfg.intermediate_size, cfg.dtype)
        self.down_proj = QuantizableDense(cfg.intermediate_size, cfg.hidden_size, cfg.dtype)

    def forward(self, x, adapter_ids=None, lora=None, par: Optional[ParallelForward] = None):
        if par is not None and par.tp > 1:
            route = par.tp_route()
            x_in = par.tp_input(x)
            gate = self.gate_proj(x_in, adapter_ids, lora, route=route)
            up = self.up_proj(x_in, adapter_ids, lora, route=route)
            return self.down_proj(torch.nn.functional.silu(gate) * up, adapter_ids, lora,
                                  route=route)
        gate = self.gate_proj(x, adapter_ids, lora)
        up = self.up_proj(x, adapter_ids, lora)
        return self.down_proj(torch.nn.functional.silu(gate) * up, adapter_ids, lora)


class LlamaBlock(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        cfg = config
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype)
        self.self_attn = LlamaAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype)
        self.mlp = LlamaMLP(cfg)

    def forward(self, x, positions, cos, sin, cache=None, cache_write_mask=None,
                paged_write=None, attn_implementation=None, segment_ids=None,
                adapter_ids=None, lora=None, par: Optional[ParallelForward] = None):
        attn = self.self_attn(self.input_layernorm(x, par), positions, cos, sin, cache,
                              cache_write_mask, paged_write, attn_implementation,
                              segment_ids, adapter_ids, lora, par)
        new_cache = None
        if cache is not None:
            attn, new_cache = attn
        h = x + attn
        out = h + self.mlp(self.post_attention_layernorm(h, par), adapter_ids, lora, par)
        return (out, new_cache) if cache is not None else out


class _F32Logits(torch.autograd.Function):
    """``x @ w.T`` in f32 from bf16 operands (one cuBLAS GEMM writing f32),
    with the backward ``torch.mm(..., out_dtype=)`` lacks: the f32
    cotangent against the operands widened to f32, each gradient rounded
    once to its operand's dtype, as JAX differentiates a dot with
    ``preferred_element_type=float32``."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = (g @ w.float()).to(x.dtype) if ctx.needs_input_grad[0] else None
        dw = (g.t() @ x.float()).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw


class LMHead(nn.Module):
    """Vocab projection with bf16 operands and **f32 logits**.

    On the card the product is one cuBLAS GEMM that takes bf16 operands,
    accumulates in f32 and writes f32 (``torch.mm(..., out_dtype=
    torch.float32)``), so the logits are never rounded to bf16 (the JAX
    head's ``preferred_element_type=float32``); it runs through
    :class:`_F32Logits`, which adds the backward (LoRA fine-tuning).  On
    the CPU the operands are widened to f32 first (bf16 values are exact
    in f32), which computes the same sums.  With ``lm_head`` a LoRA
    target, the f32 logits take the adapter delta (JAX :731-737)."""

    def __init__(self, hidden: int, vocab_size: int, dtype: torch.dtype):
        super().__init__()
        self.in_features = hidden
        self.out_features = vocab_size
        self.lora_key: Optional[str] = None   # the module name, set by the owning model
        self.weight = nn.Parameter(torch.empty(vocab_size, hidden, dtype=dtype))

    def forward(self, x, adapter_ids=None, lora=None):
        x2 = x.reshape(-1, x.shape[-1]).to(self.weight.dtype)
        if fp8_enabled():
            # f32 logits from e4m3 operands: delayed weight scale with a
            # meta, current scaling without (JAX :707-726)
            meta = fp8_meta(self.lora_key)
            if meta is not None:
                y = fp8_delayed_dot(x2, self.weight.t(), meta,
                                    preferred_element_type=torch.float32)
            else:
                y = fp8_current_scaled_dot(x2, self.weight.t(),
                                           preferred_element_type=torch.float32)
        elif x2.device.type == "cuda" and self.weight.dtype != torch.float32:
            y = _F32Logits.apply(x2, self.weight)
        else:
            y = x2.float() @ self.weight.float().t()
        y = y.reshape(*x.shape[:-1], -1)
        entry = lora.get(self.lora_key) if (adapter_ids is not None and lora) else None
        if entry is not None:
            y = lora_apply(x, y, entry["a"], entry["b"], adapter_ids)
        return y


def _stacked_block(cfg: LlamaConfig, n_iter: int, block_cls=LlamaBlock) -> nn.Module:
    """A ``block_cls`` layer whose every parameter has a leading axis of
    ``n_iter`` (one slice per scan iteration)."""
    block = block_cls(cfg)
    for mod in block.modules():
        for name, p in list(mod._parameters.items()):
            if p is not None:
                setattr(mod, name, nn.Parameter(torch.empty(n_iter, *p.shape, dtype=p.dtype)))
    return block


class _LlamaModel(nn.Module):
    """The embedding, the layer stack of ``block_cls`` layers (JAX's
    ``block_cls``, :762: the Mixtral block swaps the MLP) and the final
    norm."""

    def __init__(self, config: LlamaConfig, block_cls=LlamaBlock):
        super().__init__()
        cfg = config
        # from an empty table: _init_weights draws every parameter, so the
        # layer's own normal_ init is skipped (on meta it would import
        # torch's meta kernels, seconds per process)
        self.embed_tokens = nn.Embedding(
            cfg.vocab_size, cfg.hidden_size,
            _weight=torch.empty(cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype))
        if cfg.scan_layers:
            bs = cfg.scan_block_size
            n_iter = cfg.num_hidden_layers // bs
            self.n_iter = n_iter
            self.layers_scan = nn.Module()
            for j in range(bs):
                self.layers_scan.add_module("block" if bs == 1 else f"block_{j}",
                                            _stacked_block(cfg, n_iter, block_cls))
        else:
            self.layers = nn.ModuleList(block_cls(cfg) for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype)

    def layer_calls(self, units=None) -> list:
        """One callable per layer, in order, each taking a layer's forward
        arguments: the layer modules, or for a scanned stack its block
        module run on the layer's slice of the stacked weights (the slices
        formed once per call, so the backward stacks their gradients
        once).  A stacked leaf the sharded step's ``units`` gather per
        iteration (``parallel/fsdp.py``) stays the stored range, gathered
        slice by slice at each call."""
        if not hasattr(self, "layers_scan"):
            return list(self.layers)
        stacks = []
        for bname, blk in self.layers_scan.named_children():
            prefix = f"model.layers_scan.{bname}."
            names = [n for n, _ in blk.named_parameters()]
            owned = [units is not None and units.owns(prefix + n) for n in names]
            stacks.append((blk, prefix, names, owned,
                           [_get_path(blk, n) if o else _get_path(blk, n).unbind(0)
                            for n, o in zip(names, owned)]))
        calls = []
        for it in range(self.n_iter):
            for blk, prefix, names, owned, slices in stacks:
                calls.append(_ScanSlice(blk, names, [sl if o else sl[it]
                                                     for sl, o in zip(slices, owned)],
                                        prefix, it))
        return calls


def _get_path(module: nn.Module, name: str):
    for part in name.split("."):
        module = getattr(module, part)
    return module


class _ScanSlice:
    """A scanned block's forward on one iteration's slice of its stacked
    weights (``torch.func.functional_call``); ``prefix`` and ``iteration``
    name the train-state leaves the slices come from."""

    def __init__(self, block: nn.Module, names: list, tensors: list, prefix: str = "",
                 iteration: Optional[int] = None):
        self.block, self.names, self.tensors = block, names, tensors
        self.prefix, self.iteration = prefix, iteration

    def params(self) -> list:
        return self.tensors

    def with_params(self, tensors) -> "_ScanSlice":
        return _ScanSlice(self.block, self.names, list(tensors))

    def __call__(self, *args, **kwargs):
        return torch.func.functional_call(self.block, dict(zip(self.names, self.tensors)),
                                          args, kwargs)


def _layer_params(layer) -> tuple[list, list]:
    """(names, tensors) of one layer call's weights, as its forward reads
    them (a module's through attribute access, so a surrounding
    ``functional_call`` shows its tensors)."""
    if isinstance(layer, _ScanSlice):
        return layer.names, layer.params()
    names = [n for n, _ in layer.named_parameters()]
    return names, [_get_path(layer, n) for n in names]


def _rebind(layer, names, tensors):
    """``layer`` run with ``tensors`` as its weights."""
    if isinstance(layer, _ScanSlice):
        return layer.with_params(tensors)
    return _ScanSlice(layer, names, list(tensors))


def _active_units():
    from ..parallel.fsdp import active_units

    return active_units()


def _unit(names, tensors, iteration=None, units=None) -> list:
    """``parallel.fsdp.unit_weights``: the sharded step's per-unit gather
    of these train-state leaves (the tensors themselves outside one)."""
    from ..parallel.fsdp import unit_weights

    return unit_weights(names, tensors, iteration, units)


def _gathered(layer, prefix: str, units):
    """``layer`` run on its weights as the sharded step gathers them (one
    unit)."""
    names, tensors = _layer_params(layer)
    full = _unit([prefix + n for n in names], tensors, getattr(layer, "iteration", None), units)
    return _rebind(layer, names, full)


def _layer_prefix(layer, i: int) -> str:
    """The train-state name prefix of layer call ``i``'s weights."""
    return layer.prefix if isinstance(layer, _ScanSlice) else f"model.layers.{i}."


def _bound_shape(name: str, t: torch.Tensor) -> tuple:
    """The shape of leaf ``name`` the forward computes with: the stored
    range's layout under the sharded step's per-unit gathers, else
    ``t``'s."""
    units = _active_units()
    if units is not None and units.owns(name):
        return tuple(units.plan.layouts[name].shape)
    return tuple(t.shape)


def _dots_policy(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: save the matmul outputs (no batch dims),
    recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in _SAVED_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def boundary_offload_rows(t: int, fraction: float) -> int:
    """The head rows of a length-``t`` boundary that go to the host (JAX
    ``_ScanBody`` :649-656): a fraction below 1 is aligned down to 1024
    rows (8 for ``t < 4096``), at least one alignment, at most ``t``."""
    if fraction >= 1.0:
        return t
    align = 1024 if t >= 4096 else 8
    return min(t, max(align, (int(t * fraction) // align) * align))


class _BoundaryOffload(torch.autograd.Function):
    """One layer (or scan iteration) whose only saved value is its input
    boundary ``x`` ``[B, T, H]``: the head ``n_host`` rows copied to
    page-locked host memory on a side stream (the tail kept on the card),
    the forward run without a graph; the backward fetches the head back,
    reruns the forward with a graph and returns the gradients of ``x`` and
    of the weights."""

    @staticmethod
    def forward(ctx, body, n_host, stats, x, *weights):
        with torch.no_grad():
            out = body(x, weights)
        head = x[:, :n_host]
        if x.device.type == "cuda":
            host = torch.empty(head.shape, dtype=head.dtype, pin_memory=True)
            side = _offload_stream(x.device)
            side.wait_stream(torch.cuda.current_stream(x.device))
            with torch.cuda.stream(side):
                host.copy_(head, non_blocking=True)
                x.record_stream(side)
                event = torch.cuda.Event()
                event.record(side)
            ctx.event = event
        else:
            host = head.clone()
            ctx.event = None
        stats["d2h_bytes"] += host.numel() * host.element_size()
        ctx.host, ctx.body, ctx.stats = host, body, stats
        tail = x[:, n_host:].clone()
        ctx.save_for_backward(tail, *weights)
        return out

    @staticmethod
    def backward(ctx, g):
        tail, *weights = ctx.saved_tensors
        if ctx.event is not None:
            torch.cuda.current_stream(tail.device).wait_event(ctx.event)
            head = ctx.host.to(tail.device, non_blocking=True)
        else:
            head = ctx.host
        ctx.stats["h2d_bytes"] += head.numel() * head.element_size()
        x = (torch.cat([head, tail], dim=1) if tail.shape[1] else head).detach().requires_grad_()
        ws = [w.detach().requires_grad_(w.requires_grad) for w in weights]
        with torch.enable_grad():
            out = ctx.body(x, ws)
        wanted = [x] + [w for w in ws if w.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g, allow_unused=True))
        gx = next(grads)
        return (None, None, None, gx, *[next(grads) if w.requires_grad else None for w in ws])


_OFFLOAD_STREAMS: dict = {}


def _offload_stream(device: torch.device):
    key = device.index if device.index is not None else torch.cuda.current_device()
    if key not in _OFFLOAD_STREAMS:
        _OFFLOAD_STREAMS[key] = torch.cuda.Stream(device=key)
    return _OFFLOAD_STREAMS[key]


class LlamaForCausalLM(nn.Module):
    """Decoder LM.  ``forward(input_ids, positions=None, segment_ids=None,
    output_hidden=False, cache=None, cache_write_mask=None,
    attn_implementation=None, adapter_ids=None, lora=None)`` returns f32 logits ``[B, T, V]`` — or the
    final-norm hidden states ``[B, T, H]`` with ``output_hidden`` (the fused
    linear + CE loss applies the head itself) — or ``(logits, new_cache)``
    with a cache (dense from :func:`init_cache`, or the per-layer paged
    views the serving engine builds).  Caches are updated in place;
    ``new_cache`` holds the same tensors.  ``segment_ids`` [B, T] masks
    cross-segment attention (packed sequences, uncached forward only).
    ``attn_implementation`` overrides the config's for one call (the
    serving engine's ``decode_kernel``).  ``adapter_ids`` [B] and the
    adapter pool ``lora`` route each row through its LoRA adapter (id 0:
    the base model, bitwise).

    Built on ``device`` (``"cuda"`` unless the caller asks for the CPU)
    with random weights from ``seed``; ``load_state_dict`` replaces them
    (``models/convert.py`` builds one from a JAX param tree).  Parameters
    are trainable; the serving engine and ``generate`` run under
    ``torch.inference_mode()``.  ``block_cls`` is the layer class
    (subclasses swap it: ``models/mixtral.py``)."""

    block_cls = LlamaBlock

    def __init__(self, config: LlamaConfig, *, device=None, seed: int = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        with torch.device(dev):
            self.model = _LlamaModel(config, type(self).block_cls)
            self.lm_head = LMHead(config.hidden_size, config.vocab_size, config.dtype)
        if config.tie_word_embeddings:
            # one [V, H] parameter: the head contracts hidden against the
            # embedding table (JAX :899-903)
            self.lm_head.weight = self.model.embed_tokens.weight
        cos, sin = rope_frequencies(config.head_dim, config.max_position_embeddings,
                                    config.rope_theta)
        self.register_buffer("rope_cos", torch.from_numpy(cos).to(dev), persistent=False)
        self.register_buffer("rope_sin", torch.from_numpy(sin).to(dev), persistent=False)
        for name, mod in self.named_modules():
            if isinstance(mod, (QuantizableDense, LMHead)):
                mod.lora_key = name
            if isinstance(mod, QuantizableDense):
                # the Megatron roles (JAX :476-477, :605-607)
                role = name.rsplit(".", 1)[-1]
                mod.tp_mode = ("column" if role in ("q_proj", "k_proj", "v_proj", "gate_proj",
                                                    "up_proj") else "row")
        # bytes the "offload" remat policy moved across the boundary
        self.boundary_stats = {"d2h_bytes": 0, "h2d_bytes": 0}
        if self.device.type != "meta":       # big_modeling.init_empty_weights: no init
            self._init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        """Linear weights ~ N(0, 1/fan_in), embeddings ~ N(0, 1), norm
        scales 1 — drawn on the model's device from ``seed``
        (:meth:`_init_std`)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("layernorm.weight") or name == "model.norm.weight":
                p.fill_(1.0)
                continue
            p.copy_(torch.randn(p.shape, generator=gen, device=self.device)
                    * self._init_std(name, p))

    def _init_std(self, name: str, p: torch.Tensor) -> float:
        """The standard deviation of parameter ``name``'s draw: 1 for the
        embedding, ``1 / sqrt(fan_in)`` for a linear weight.  The two
        projections that write into the residual stream (``o_proj``,
        ``down_proj``) are further scaled by ``1 / (2 * layers)``, so the
        stream stays dominated by its input.  A random bf16 model of 16
        layers without it (or with GPT-2's milder ``1/sqrt(2 * layers)``)
        is chaotic: one bf16 rounding that lands the other way in one
        attention output grows into the logits until a kernel and its
        plain version no longer agree on the argmax at 98 % of
        positions."""
        std = 1.0 if "embed_tokens" in name else 1.0 / math.sqrt(p.shape[-1])
        if name.endswith(("o_proj.weight", "down_proj.weight")):
            std *= 1.0 / (2 * self.config.num_hidden_layers)
        return std

    def _remat_stack(self, layers: list, x, positions, kw: dict):
        """The uncached layer stack under ``remat``: each layer
        checkpointed (``full``: nothing saved inside it; ``dots``: the
        matmul outputs saved), or under ``offload`` each layer (scan
        iteration) a :class:`_BoundaryOffload` whose boundary goes to the
        host, the blocks of a multi-block iteration each recomputed alone
        within it."""
        from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

        cfg = self.config
        args = (positions, self.rope_cos, self.rope_sin)
        # the sharded step's per-unit gathers: the weights go in as the
        # rank's ranges and each call gathers them, so the recompute gathers
        # them again
        units = _active_units()
        if cfg.remat_policy in ("full", "dots"):
            extra = ({} if cfg.remat_policy == "full" else {"context_fn": functools.partial(
                create_selective_checkpoint_contexts, _dots_policy)})
            for i, layer in enumerate(layers):
                # the weights go in as inputs: the recompute runs at the
                # backward, after a surrounding functional_call has put the
                # module's own tensors back
                names, weights = _layer_params(layer)
                full = [_layer_prefix(layer, i) + n for n in names]

                def call(h, *ws, layer=layer, names=names, full=full):
                    ws = _unit(full, ws, getattr(layer, "iteration", None), units)
                    return _rebind(layer, names, ws)(h, *args, **kw)

                x = checkpoint(call, x, *weights, use_reentrant=False, **extra)
            return x
        bs = cfg.scan_block_size if cfg.scan_layers else 1
        n_host = boundary_offload_rows(x.shape[1], cfg.boundary_offload_fraction)
        for start in range(0, len(layers), bs):
            group = layers[start:start + bs]
            named = [_layer_params(layer) for layer in group]
            prefixes = [_layer_prefix(layer, start + j) for j, layer in enumerate(group)]

            def body(h, weights, group=group, named=named, prefixes=prefixes):
                it = iter(weights)
                for layer, (names, _), prefix in zip(group, named, prefixes):
                    ws = _unit([prefix + n for n in names], [next(it) for _ in names],
                               getattr(layer, "iteration", None), units)
                    call = _rebind(layer, names, ws)
                    if len(group) > 1:
                        h = checkpoint(call, h, *args, use_reentrant=False, **kw)
                    else:
                        h = call(h, *args, **kw)
                return h

            x = _BoundaryOffload.apply(body, n_host, self.boundary_stats, x,
                                       *[w for _, ws in named for w in ws])
        return x

    def _tp_sharded(self) -> bool:
        """Whether any leaf the tp plan splits is held as a tp slice (the
        train state's under a tp plan, or :func:`~..parallel.sharding.
        bind_tp_slices`'s) rather than whole: the embedding, the head or a
        full-precision dense of the first layer, each read on its own (a
        quantized dense holds whole codes beside a vocab-sharded
        embedding and head)."""
        cfg = self.config
        emb = self.model.embed_tokens.weight
        if _bound_shape("model.embed_tokens.weight", emb)[0] != cfg.vocab_size:
            return True
        if self._head_sharded():
            return True
        scan = hasattr(self.model, "layers_scan")
        bname, block = (next(iter(self.model.layers_scan.named_children())) if scan
                        else ("0", self.model.layers[0]))
        prefix = f"model.layers_scan.{bname}." if scan else "model.layers.0."
        for name, mod in block.named_modules():
            if not isinstance(mod, QuantizableDense) or mod.weight is None or not mod.tp_mode:
                continue
            column = mod.tp_mode == "column"
            shape = _bound_shape(prefix + name + ".weight", mod.weight)
            if shape[(0 if column else 1) + scan] != (mod.out_features if column
                                                      else mod.in_features):
                return True
        return False

    def _plain_denses(self, adapter_ids) -> bool:
        """Whether this forward runs LoRA or quantized denses, which take
        their tp route with the collective matmul off."""
        return adapter_ids is not None or any(
            isinstance(mod, QuantizableDense) and mod.weight is None for mod in self.modules())

    def parallel_forward(self, t_local: int, impl: str, cached: bool = False,
                         adapter_ids=None) -> Optional[ParallelForward]:
        """How a forward of ``t_local`` tokens a rank lies over the newest
        accelerator state's mesh, or None outside tp / sp.  A ``cached``
        forward (``generate``, the serving engine) runs over ``tp`` alone,
        with the collective matmul off, as JAX's hook falls back for it
        (``accelerate_tpu/ops/collective_matmul.py:315-336``); so does one
        with LoRA (``adapter_ids``) or quantized denses."""
        from ..ops.collective_matmul import collective_matmul_mode, ulysses_sp_boundary
        from ..state import ambient_mesh

        mesh = ambient_mesh()[0]
        if mesh is None:
            return None
        sizes = C.mesh_sizes(mesh)
        tp, sp = sizes.get("tp", 1), 1 if cached else sizes.get("sp", 1)
        if tp > 1 and not self._tp_sharded():
            tp = 1      # whole weights: every rank computes the whole forward
        if tp == 1 and sp == 1:
            return None
        cfg = self.config
        if sp > 1 and impl != "ulysses":
            raise ValueError(f"an sp axis of {sp} ranks needs attn_implementation='ulysses', "
                             f"got {impl!r}")
        ring = not cached and not self._plain_denses(adapter_ids)
        mode = collective_matmul_mode() if ring else "off"
        if tp == 1 or t_local % tp or t_local < tp:
            mode = "off"
        sp_mode = "off"
        if (ring and impl == "ulysses" and sp > 1
                and ulysses_sp_boundary(cfg.num_attention_heads, cfg.num_key_value_heads,
                                        t_local * sp)):
            sp_mode = collective_matmul_mode()
        return ParallelForward(mesh=mesh, tp=tp,
                               tp_rank=C.axis_index("tp", mesh) if tp > 1 else 0, sp=sp,
                               sp_rank=C.axis_index("sp", mesh) if sp > 1 else 0, mode=mode,
                               sp_mode=sp_mode)

    def cache_kv_heads(self) -> int:
        """The kv heads a KV cache of this model holds on the calling rank
        (:func:`init_cache` / :func:`init_paged_cache`'s ``num_kv_heads``):
        all of the config's outside a tp world, else the rank's
        (:func:`rank_heads`)."""
        par = self.parallel_forward(1, self.config.attn_implementation, cached=True)
        if par is None or par.tp == 1:
            return self.config.num_key_value_heads
        _, _, kv0, kv1 = rank_heads(self.config, par.tp, par.tp_rank)
        return kv1 - kv0

    def tp_degree(self) -> int:
        """The ranks of the tp world whose slices this model holds (1
        outside one)."""
        par = self.parallel_forward(1, self.config.attn_implementation, cached=True)
        return 1 if par is None else par.tp

    def _embed(self, input_ids, par: Optional[ParallelForward]):
        """The token embeddings; under tp vocab-parallel (a shard of the
        table's rows) or, replicated, sliced to the rank's tokens in the
        sequence-sharded layout."""
        emb = self.model.embed_tokens
        w = _unit(["model.embed_tokens.weight"], [emb.weight])[0]
        if par is None or par.tp == 1:
            return emb(input_ids) if w is emb.weight else torch.nn.functional.embedding(
                input_ids, w)
        if w.shape[0] != self.config.vocab_size:
            rows = w.shape[0]
            local = input_ids - par.tp_rank * rows
            valid = (local >= 0) & (local < rows)
            e = torch.nn.functional.embedding(local.clamp(0, rows - 1), w)
            e = e * valid[..., None].to(e.dtype)
            if par.seq_sharded:
                return C.reduce_scatter(e, "tp", axis=1, mesh=par.mesh)
            return C.psum(e, "tp", mesh=par.mesh)
        if par.seq_sharded:
            e = torch.nn.functional.embedding(input_ids, C.pbroadcast(w, "tp", par.mesh))
            return torch.chunk(e, par.tp, dim=1)[par.tp_rank]
        return emb(input_ids) if w is emb.weight else torch.nn.functional.embedding(input_ids, w)

    @property
    def head_name(self) -> str:
        """The train-state name of the head's weight (the embedding's when
        they are tied)."""
        return "model.embed_tokens.weight" if self.config.tie_word_embeddings else "lm_head.weight"

    def fsdp_units(self) -> list:
        """The units the sharded step gathers one at a time, as lists of
        train-state names: the embedding, each decoder block (each block
        of the scanned stack, gathered iteration by iteration), the final
        norm and the head (``parallel/fsdp.py``)."""
        canon = {id(p): n for n, p in self.named_parameters()}

        def names(mod):
            return [canon[id(p)] for p in mod.parameters()]

        blocks = (list(self.model.layers_scan.children()) if hasattr(self.model, "layers_scan")
                  else list(self.model.layers))
        return ([names(self.model.embed_tokens)] + [names(b) for b in blocks]
                + [names(self.model.norm), names(self.lm_head)])

    def _head(self):
        """The head module on its weight as the sharded step gathers it,
        and that weight."""
        w = _unit([self.head_name], [self.lm_head.weight])[0]
        head = self.lm_head if w is self.lm_head.weight else _rebind(self.lm_head, ["weight"],
                                                                    [w])
        return head, w

    def _head_sharded(self) -> bool:
        return _bound_shape(self.head_name, self.lm_head.weight)[0] != self.config.vocab_size

    def _hidden_out(self, x, par: Optional[ParallelForward]):
        """The final-norm states under tp, whole over the rank's sequence:
        with a vocab-sharded head, the input of a rank-local loss (their
        gradient summed over ``tp``); with a whole head, one every rank
        reads alike."""
        if par is None or par.tp == 1:
            return x
        if par.seq_sharded:
            gather = C.all_gather if self._head_sharded() else C.all_gather_invariant
            return gather(x.contiguous(), "tp", axis=1, mesh=par.mesh)
        return C.pbroadcast(x, "tp", par.mesh) if self._head_sharded() else x

    def _logits(self, x, par: Optional[ParallelForward], adapter_ids, lora):
        """f32 logits ``[B, T, V]``; under tp the head is column-parallel
        over the vocabulary (the ring gathers the sequence inside its
        product, JAX :738-757) and the shards are gathered whole."""
        head, w = self._head()
        if par is None or par.tp == 1:
            return head(x, adapter_ids, lora)
        if not self._head_sharded():
            return head(self._hidden_out(x, par), adapter_ids, lora)
        cfg = self.config
        x_in = par.tp_input(x)
        logits = tp_linear(x_in, w, "column", par.tp_route(),
                           cfg.hidden_size, cfg.vocab_size, out_dtype=torch.float32,
                           fp8=fp8_enabled(), meta=fp8_meta(self.lm_head.lora_key)
                           if fp8_enabled() else None)
        entry = lora.get(self.lm_head.lora_key) if (adapter_ids is not None and lora) else None
        if entry is not None:
            # the rank's vocabulary columns of b
            n = logits.shape[-1]
            b = entry["b"][..., par.tp_rank * n:(par.tp_rank + 1) * n].contiguous()
            logits = lora_apply(x_in, logits, entry["a"], b, adapter_ids)
        return C.all_gather_invariant(logits.contiguous(), "tp", axis=logits.dim() - 1,
                                      mesh=par.mesh)

    def forward(self, input_ids, positions=None, segment_ids=None, output_hidden: bool = False,
                cache=None, cache_write_mask=None, attn_implementation: Optional[str] = None,
                adapter_ids=None, lora: Optional[dict] = None):
        b, t = input_ids.shape
        impl = attn_implementation or self.config.attn_implementation
        par = self.parallel_forward(t, impl, cached=cache is not None, adapter_ids=adapter_ids)
        if positions is None and par is not None and par.sp > 1:
            # this rank's contiguous slice: rotary embeddings at the tokens'
            # global positions
            from ..parallel.sequence_parallel import shard_positions

            positions = shard_positions(t, par.sp_rank, input_ids.device).expand(b, t)
        if positions is None and cache is None and impl == "ring":
            # this rank's shard of the ring's layout: rotary embeddings at
            # the tokens' global positions, as the ring's causal mask
            from ..parallel.context_parallel import ring_shard_positions

            positions = ring_shard_positions(t, input_ids.device).expand(b, t)
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
                                            cache[0]["k_pages"].shape[2], cache_write_mask,
                                            quantized="k_scales" in cache[0])
        cfg = self.config
        if adapter_ids is not None and cfg.scan_layers:
            raise ValueError(
                "adapter_ids (multi-tenant LoRA) has no scan_layers path: the adapters key "
                "the per-layer module names; convert with unstack_layer_params and "
                "scan_layers=False")
        x = self._embed(input_ids, par)
        new_cache = [] if cache is not None else None
        units = _active_units() if cache is None else None
        layers = self.model.layer_calls(units)
        if cache is None and cfg.remat and torch.is_grad_enabled():
            x = self._remat_stack(layers, x, positions, dict(
                attn_implementation=attn_implementation, segment_ids=segment_ids,
                adapter_ids=adapter_ids, lora=lora, par=par))
            layers = []
        for i, layer in enumerate(layers):
            if cache is not None:
                x, layer_cache = layer(x, positions, self.rope_cos, self.rope_sin,
                                       cache[i], cache_write_mask, paged_write,
                                       attn_implementation, adapter_ids=adapter_ids, lora=lora,
                                       par=par)
                new_cache.append(layer_cache)
            else:
                if units is not None:
                    layer = _gathered(layer, _layer_prefix(layer, i), units)
                x = layer(x, positions, self.rope_cos, self.rope_sin,
                          attn_implementation=attn_implementation, segment_ids=segment_ids,
                          adapter_ids=adapter_ids, lora=lora, par=par)
        norm = self.model.norm
        w = _unit(["model.norm.weight"], [norm.weight])[0]
        x = norm(x, par) if w is norm.weight else _rebind(norm, ["weight"], [w])(x, par)
        if output_hidden:
            return (x, new_cache) if cache is not None else self._hidden_out(x, par)
        logits = self._logits(x, par, adapter_ids, lora)
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


def _check_sp_labels(batch) -> None:
    """Under ``sp`` a rank's last token's target lives on the next rank:
    the labels must come pre-shifted."""
    from ..state import ambient_mesh

    mesh = ambient_mesh()[0]
    if (mesh is not None and C.mesh_sizes(mesh).get("sp", 1) > 1 and isinstance(batch, dict)
            and "shift_labels" not in batch):
        raise ValueError("under sp the batch needs shift_labels (next-token targets shifted "
                         "before the sequence was split: shard_batch_along_sequence, or a "
                         "loader prepared by the Accelerator)")


def make_llama_loss_fn(model: LlamaForCausalLM, fused_vocab_chunks: Optional[int] = None):
    """``loss_fn(params, batch)`` for ``Accelerator.prepare_train_step``
    (JAX ``make_llama_loss_fn``).  ``batch`` holds ``input_ids`` and
    ``labels`` (or pre-shifted ``shift_labels``), optionally
    ``segment_ids``.  With ``fused_vocab_chunks``, the head moves inside
    the chunked fused linear + CE (``ops/fused_xent.py``), so the ``[B, T,
    V]`` logits never exist; the port's head weight is ``[V, H]``, the
    ``vocab_major`` layout.  With the head's rows sharded over ``tp``, the
    vocab-parallel form (``vocab_parallel_causal_lm_loss``), each rank
    walking ``ceil(fused_vocab_chunks / tp)`` chunks of its shard.  Under
    ``sp`` each rank holds a slice of the sequence, so the batch must
    carry ``shift_labels`` (``parallel.sequence_parallel.
    shard_batch_along_sequence`` and the prepared loader make them)."""
    if fused_vocab_chunks is None:
        def loss_fn(params, batch):
            _check_sp_labels(batch)
            logits = _apply(model, params, batch["input_ids"],
                            segment_ids=batch.get("segment_ids"))
            if "shift_labels" in batch:
                return causal_lm_loss(logits, batch["shift_labels"], shifted=True)
            return causal_lm_loss(logits, batch["labels"])

        loss_fn.fsdp_units = model.fsdp_units
        return loss_fn

    from ..ops.fused_xent import fused_causal_lm_loss

    cfg = model.config

    def fused_loss_fn(params, batch):
        _check_sp_labels(batch)
        hidden = _apply(model, params, batch["input_ids"],
                        segment_ids=batch.get("segment_ids"), output_hidden=True)
        head = (params if params is not None else dict(model.named_parameters()))
        weight = _unit([model.head_name], [head[model.head_name]])[0].to(cfg.dtype)  # [V, H]
        shifted = "shift_labels" in batch
        if weight.shape[0] != cfg.vocab_size:
            from ..ops.fused_xent import vocab_parallel_causal_lm_loss
            from ..state import ambient_mesh

            mesh = ambient_mesh()[0]
            tp = C.axis_size("tp", mesh)
            return vocab_parallel_causal_lm_loss(
                hidden, weight, batch["shift_labels"] if shifted else batch["labels"],
                offset=C.axis_index("tp", mesh) * weight.shape[0],
                num_chunks=-(-fused_vocab_chunks // tp), shifted=shifted, mesh=mesh)
        return fused_causal_lm_loss(
            hidden, weight, batch["shift_labels"] if shifted else batch["labels"],
            vocab_major=True, num_chunks=fused_vocab_chunks, shifted=shifted,
        )

    fused_loss_fn.fsdp_units = model.fsdp_units
    return fused_loss_fn


_LAYER_NAME = re.compile(r"model\.layers\.(\d+)\.(.+)")
_SCAN_NAME = re.compile(r"model\.layers_scan\.block(?:_(\d+))?\.(.+)")


def stack_layer_params(params: dict, scan_block_size: int = 1) -> dict:
    """A state over the unrolled layers (``model.layers.{i}.<name>``) in
    the ``scan_layers=True`` layout (JAX :979): ``model.layers_scan.block.
    <name>`` stacked on a leading axis of L, or with ``scan_block_size`` bs
    > 1 ``model.layers_scan.block_{j}.<name>`` over L / bs iterations
    (global layer i at iteration i // bs, slot i % bs).  Other names pass
    through; a state without layers comes back as it is."""
    layers: dict = {}
    out = {}
    for name, t in params.items():
        m = _LAYER_NAME.fullmatch(name)
        if m:
            layers.setdefault(int(m.group(1)), {})[m.group(2)] = t
        else:
            out[name] = t
    if not layers:
        return dict(params)
    n = len(layers)
    bs = scan_block_size
    if n % bs:
        raise ValueError(f"{n} layers not divisible by scan_block_size={bs}")
    for j in range(bs):
        prefix = "model.layers_scan.block" + ("" if bs == 1 else f"_{j}")
        for key in layers[0]:
            out[f"{prefix}.{key}"] = torch.stack([layers[i][key] for i in range(j, n, bs)])
    return out


def unstack_layer_params(params: dict) -> dict:
    """Inverse of :func:`stack_layer_params` (JAX :1017), the block size
    read from the stacked names."""
    stacked: dict = {}
    out = {}
    for name, t in params.items():
        m = _SCAN_NAME.fullmatch(name)
        if m:
            stacked.setdefault(int(m.group(1) or 0), {})[m.group(2)] = t
        else:
            out[name] = t
    if not stacked:
        return dict(params)
    bs = len(stacked)
    for j, block in stacked.items():
        for key, t in block.items():
            for it in range(t.shape[0]):
                out[f"model.layers.{it * bs + j}.{key}"] = t[it]
    return out


def count_params(params) -> int:
    """Elements of a module's parameters or of a name -> tensor dict."""
    tensors = params.parameters() if isinstance(params, nn.Module) else params.values()
    return sum(int(t.numel()) for t in tensors)


def flops_per_token(cfg: LlamaConfig, seq_len: int) -> float:
    """Training FLOPs per token, ``6 N + 12 L H D T`` (the PaLM appendix
    formula; JAX ``flops_per_token``)."""
    n_params = (
        cfg.vocab_size * cfg.hidden_size * (1 if cfg.tie_word_embeddings else 2)
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
