"""Device-side page allocator for the paged KV cache (mirrors
``accelerate_tpu/serving/paged_cache.py``).

The pool is built by :func:`~accelerate_tpu_torch.models.llama.
init_paged_cache`; this module is the allocator arithmetic on it, integer
for integer the JAX package's:

- ``free_stack``/``free_top`` form a stack of free physical page ids; pops
  never rewrite the stack (entries above ``free_top`` are dead), pushes
  overwrite dead entries; a batch of lanes pops or pushes in one scatter
  with computed ranks.
- The JAX functions drop masked lanes by routing their scatter index out
  of bounds (``mode="drop"``), which PyTorch refuses (an error on the CPU,
  a device fault on CUDA).  Here masked lanes are filtered out with the
  boolean mask before the scatter (one device-to-host sync per call).
- The scatters update ``block_tables``/``free_stack`` **in place** (there
  is no buffer donation to ask for it); each function also returns them,
  in the JAX functions' return shape.
"""

from __future__ import annotations

from typing import Optional

import torch


def pages_for(tokens, page_size: int):
    """Pages needed to hold ``tokens`` tokens (ceil division; 0 -> 0)."""
    return -(-tokens // page_size)


def allocate(block_tables, free_stack, free_top, slots, logical_pages, need):
    """Pop one page per needing lane and write it into the block table.

    ``slots``/``logical_pages``/``need``: aligned ``[K]`` tensors — lane
    *i* takes a fresh physical page at ``block_tables[slots[i],
    logical_pages[i]]`` iff ``need[i]``.  ``block_tables`` is updated in
    place.  Returns ``(block_tables, free_top)``; ``free_stack`` itself is
    untouched (pops only move the top)."""
    need = need.to(torch.bool)
    n_need = need.to(torch.int32)
    rank = torch.cumsum(n_need, 0, dtype=torch.int32) - 1          # 0-based grab order
    src = (free_top - 1 - rank).clamp(0, free_stack.shape[0] - 1)
    pages = free_stack[src.long()]
    lanes = need.nonzero().squeeze(1)
    block_tables[slots[lanes].long(), logical_pages[lanes].long()] = pages[lanes]
    return block_tables, free_top - n_need.sum(dtype=torch.int32)


def release(block_tables, seq_lens, free_stack, free_top, release_mask, page_size: int):
    """Push every page owned by the masked slots back onto the free stack.

    A slot owns ``ceil(seq_len / page_size)`` pages (its block-table
    prefix).  Returns ``(seq_lens, free_stack, free_top)`` with released
    slots' lengths zeroed; ``free_stack`` is updated in place.  The
    block-table rows stay stale on purpose: the positional liveness mask
    never reads past ``seq_len``."""
    release_mask = release_mask.to(torch.bool)
    n = block_tables.shape[1]
    owned = release_mask[:, None] & (
        torch.arange(n, device=block_tables.device)[None, :]
        < pages_for(seq_lens, page_size)[:, None]
    )
    free_stack, free_top = push_pages(
        free_stack, free_top, block_tables.reshape(-1), owned.reshape(-1)
    )
    seq_lens = torch.where(release_mask, torch.zeros_like(seq_lens), seq_lens)
    return seq_lens, free_stack, free_top


def push_pages(free_stack, free_top, pages, mask):
    """Push a masked set of physical pages back onto the free stack, in
    place.  ``pages``/``mask``: aligned ``[K]`` tensors.  Returns
    ``(free_stack, free_top)``."""
    mask = mask.to(torch.bool)
    n_mask = mask.to(torch.int32)
    rank = torch.cumsum(n_mask, 0, dtype=torch.int32) - 1
    lanes = mask.nonzero().squeeze(1)
    free_stack[(free_top + rank[lanes]).long()] = pages[lanes].to(free_stack.dtype)
    return free_stack, free_top + n_mask.sum(dtype=torch.int32)


def kv_page_bytes(config, page_size: int, dtype_bytes: int = 2,
                  kv_dtype: str = "", num_kv_heads: Optional[int] = None) -> int:
    """Bytes of ONE physical page across all layers — the unit the
    allocator hands out.  Dense pages: ``2 (K+V) * L * page_size * Hkv * D
    * dtype_bytes``.  Quantized pages (``kv_dtype`` ``"int8"`` / ``"fp8"``):
    one byte per code plus the per-(kv head, page) f32 scale, ``2 * L *
    Hkv * 4`` bytes (JAX ``kv_page_bytes``).  ``num_kv_heads``: the heads
    a pool holds (a tp rank's; default the config's)."""
    hkv = num_kv_heads or config.num_key_value_heads
    if kv_dtype in ("int8", "fp8"):
        data = (2 * config.num_hidden_layers * page_size * hkv * config.head_dim)
        return data + 2 * config.num_hidden_layers * hkv * 4
    return (2 * config.num_hidden_layers * page_size * hkv * config.head_dim * dtype_bytes)


def kv_pool_accounting(config, num_pages: int, page_size: int,
                       dtype_bytes: int = 2, kv_dtype: str = "",
                       num_kv_heads: Optional[int] = None) -> dict:
    """Predicted KV memory of a pool geometry: bytes per physical page
    across all layers, the pool's bytes and token capacity, and the share
    of one H100's 80 GB the pool takes.  A quantized pool also reports its
    ``kv_dtype`` and ``capacity_vs_bf16``, the token-capacity multiple at
    equal memory (JAX ``kv_pool_accounting``).  ``num_kv_heads``: a tp
    rank's heads (``ServingEngine.kv_heads``), its pool being their
    pages only."""
    per_page = kv_page_bytes(config, page_size, dtype_bytes, kv_dtype, num_kv_heads)
    total = per_page * num_pages
    out = {
        "page_size_tokens": page_size,
        "num_pages": num_pages,
        "bytes_per_page": per_page,
        "pool_bytes": total,
        "pool_gib": round(total / 2**30, 4),
        "tokens_capacity": num_pages * page_size,
        "hbm_frac": {"h100_80GB": round(total / 80e9, 6)},
    }
    if kv_dtype in ("int8", "fp8"):
        out["kv_dtype"] = kv_dtype
        out["capacity_vs_bf16"] = round(kv_page_bytes(config, page_size, 2, "", num_kv_heads)
                                        / per_page, 4)
    return out
