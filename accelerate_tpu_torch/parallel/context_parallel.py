"""Context parallelism: ring attention over the ``cp`` mesh dimension
(mirrors ``accelerate_tpu/parallel/context_parallel.py``).

The sequence is split over ``cp`` ranks in the zigzag layout: rank i holds
chunks ``(i, 2cp - 1 - i)`` of ``2cp`` equal chunks, so each rank does the
same causal work (:func:`zigzag_shard` / :func:`zigzag_unshard` reorder a
sequence on the host).  Each rank attends its query shard to every rank's
KV shard, one block at a time, through the port's flash attention with
the blocks' global positions and ``return_lse=True`` (kernels #1-#3 on
CUDA tensors, their plain versions on the CPU), and combines the blocks
through the differentiable logsumexp (:func:`_combine_lse`, started from
JAX's finite ``NEG_INF``), so the backward reaches #2 / #3 with an lse
cotangent.  A block in which a query row sees no key leaves that row an
lse near ``-0.7 * FLT_MAX``: it weighs zero in the combine whatever its
output.

:func:`ring_attention_rank` is one rank's block loop, given where each
step's KV shard comes from.  Both rotate methods run it:

- ``allgather``: every rank's K / V (and KV segment ids) gathered once
  (``all_gather_into_tensor``; the backward reduce-scatters their
  gradients);
- ``alltoall``: the neighbour ring, each step's K / V / segment ids passed
  on over ``batch_isend_irecv`` (the backward passes the gradients back).

Both visit the KV ranks in the ring's order ``rank, rank - 1, ...``, so
they give the same blocks combined in the same order (the JAX package's
``allgather`` combines in rank order instead; the two agree to rounding).
:func:`virtual_ring_attention` runs every rank's loop in one process.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import numpy as np
import torch

from ..ops.flash_attention import flash_attention, flash_attention_plain
from . import collectives

NEG_INF = -1e30


def _chunk_index_map(cp: int):
    """Zigzag layout: rank i holds global chunks (i, 2cp - 1 - i)."""
    return [(i, 2 * cp - 1 - i) for i in range(cp)]


def _order(cp: int) -> list:
    return [c for pair in _chunk_index_map(cp) for c in pair]


def zigzag_shard(x, cp: int, axis: int = 1):
    """Reorder ``x`` along ``axis`` so contiguous per-rank shards carry the
    zigzag chunk pairs (a tensor or an array, returned as given)."""
    t = x.shape[axis]
    assert t % (2 * cp) == 0, f"seq len {t} must divide 2*cp={2*cp}"
    if isinstance(x, torch.Tensor):
        chunks = torch.chunk(x, 2 * cp, dim=axis)
        return torch.cat([chunks[i] for i in _order(cp)], dim=axis)
    chunks = np.split(np.asarray(x), 2 * cp, axis=axis)
    return np.concatenate([chunks[i] for i in _order(cp)], axis=axis)


def zigzag_unshard(x, cp: int, axis: int = 1):
    inverse = np.argsort(_order(cp))
    if isinstance(x, torch.Tensor):
        chunks = torch.chunk(x, 2 * cp, dim=axis)
        return torch.cat([chunks[i] for i in inverse], dim=axis)
    chunks = np.split(np.asarray(x), 2 * cp, axis=axis)
    return np.concatenate([chunks[i] for i in inverse], axis=axis)


def _zigzag_positions(t_local: int, t_global: int, cp_rank: int, cp: int, device=None):
    """The global token positions ``cp_rank`` holds in the zigzag layout."""
    chunk = t_global // (2 * cp)
    first = cp_rank * chunk
    second = (2 * cp - 1 - cp_rank) * chunk
    base = torch.arange(chunk, device=device)
    return torch.cat([first + base, second + base])


def shard_positions(t_local: int, cp_rank: int, cp: int, zigzag: bool = True, device=None):
    """The global positions of ``cp_rank``'s shard: zigzag where the
    sequence splits into ``2cp`` chunks, else contiguous."""
    t_global = t_local * cp
    if zigzag and t_global % (2 * cp) == 0:
        return _zigzag_positions(t_local, t_global, cp_rank, cp, device)
    return cp_rank * t_local + torch.arange(t_local, device=device)


def _combine_lse(a, b):
    """Combine two ``(out [B, T, H, D], lse [B, T, H])`` partial attentions
    in f32; differentiable."""
    out_a, lse_a = a
    out_b, lse_b = b
    m = torch.maximum(lse_a, lse_b)
    wa = torch.exp(lse_a - m)
    wb = torch.exp(lse_b - m)
    den = torch.clamp(wa + wb, min=1e-30)
    out = out_a * (wa / den)[..., None] + out_b * (wb / den)[..., None]
    return out, m + torch.log(den)


def ring_attention_rank(q, kv_of: Callable, rank: int, cp: int, *, causal: bool = True,
                        sm_scale: Optional[float] = None, zigzag: bool = True, seg=None,
                        plain: bool = False):
    """One rank's ring: ``q`` ``[B, T/cp, H, D]`` (this rank's shard,
    ``seg`` its segment ids) attends the KV shard of each ring step ``s =
    0 .. cp-1``, ``kv_of(s) -> (k, v, kv_seg)`` from rank ``(rank - s) %
    cp``, one flash block each with the global positions under
    ``causal``, combined in step order.  ``plain`` runs the blocks on the
    plain versions of #1-#3.  Returns the attention in ``q.dtype``."""
    b, t_local, h, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    attend = flash_attention_plain if plain else flash_attention
    q = q.contiguous()
    pos_q = shard_positions(t_local, rank, cp, zigzag, q.device).expand(b, t_local)
    acc = (torch.zeros(b, t_local, h, d, dtype=torch.float32, device=q.device),
           torch.full((b, t_local, h), NEG_INF, dtype=torch.float32, device=q.device))
    for s in range(cp):
        kv_rank = (rank - s) % cp
        k_blk, v_blk, kv_seg = kv_of(s)
        pos_kv = shard_positions(k_blk.shape[1], kv_rank, cp, zigzag, q.device).expand(
            b, k_blk.shape[1])
        out, lse = attend(q, k_blk.contiguous(), v_blk.contiguous(), causal=causal,
                          sm_scale=sm_scale, segment_ids=seg,
                          kv_segment_ids=kv_seg if seg is not None else None,
                          positions=pos_q if causal else None,
                          kv_positions=pos_kv if causal else None, return_lse=True)
        acc = _combine_lse(acc, (out.float(), lse))
    return acc[0].to(q.dtype)


def virtual_ring_attention(q, k, v, cp: int, *, causal: bool = True,
                           sm_scale: Optional[float] = None, segment_ids=None,
                           zigzag: bool = True, plain: bool = False):
    """Every rank of a ``cp`` ring in turn, in one process: ``q`` / ``k`` /
    ``v`` ``[B, T, ...]`` (and ``segment_ids`` ``[B, T]``) already in the
    ring's layout (zigzag-reordered under ``causal``) are split into the
    ranks' shards, each rank runs :func:`ring_attention_rank` on the
    others' shards, and the outputs are concatenated back in that layout.
    Differentiable through every block."""
    qs, ks, vs = (torch.chunk(x, cp, dim=1) for x in (q, k, v))
    segs = torch.chunk(segment_ids, cp, dim=1) if segment_ids is not None else [None] * cp
    outs = []
    for rank in range(cp):
        def kv_of(s, rank=rank):
            j = (rank - s) % cp
            return ks[j], vs[j], segs[j]

        outs.append(ring_attention_rank(qs[rank], kv_of, rank, cp, causal=causal,
                                        sm_scale=sm_scale, zigzag=zigzag, seg=segs[rank],
                                        plain=plain))
    return torch.cat(outs, dim=1)


def ring_attention_sharded(q, k, v, seg=None, *, mesh=None, axis_name: str = "cp",
                           causal: bool = True, sm_scale: Optional[float] = None,
                           rotate_method: str = "alltoall", zigzag: bool = True):
    """This rank's ring attention (the JAX ``shard_map`` body): ``q``
    ``[B, T/cp, H, D]``, ``k`` / ``v`` ``[B, T/cp, Hkv, D]`` (GQA: K / V
    travel at kv-head width), ``seg`` ``[B, T/cp]`` local segment ids
    whose KV side travels with K / V.  Returns ``[B, T/cp, H, D]``."""
    if rotate_method not in ("allgather", "alltoall"):
        raise ValueError(f"rotate_method must be 'allgather' or 'alltoall', got "
                         f"{rotate_method!r}")
    cp = collectives.axis_size(axis_name, mesh)
    rank = collectives.axis_index(axis_name, mesh)
    if cp == 1:
        return ring_attention_rank(q, lambda s: (k, v, seg), 0, 1, causal=causal,
                                   sm_scale=sm_scale, zigzag=zigzag, seg=seg)
    if rotate_method == "allgather":
        # differentiable: the backward reduce-scatters the gradients back
        k_all = collectives.all_gather(k.contiguous(), axis_name, axis=0, tiled=False,
                                       mesh=mesh)
        v_all = collectives.all_gather(v.contiguous(), axis_name, axis=0, tiled=False,
                                       mesh=mesh)
        seg_all = (collectives.all_gather(seg.contiguous(), axis_name, axis=0, tiled=False,
                                          mesh=mesh) if seg is not None else None)

        def kv_of(s):
            j = (rank - s) % cp
            return k_all[j], v_all[j], seg_all[j] if seg is not None else None
    else:
        cur = {"k": k.contiguous(), "v": v.contiguous(), "seg": seg}

        def kv_of(s):
            if s:
                # differentiable: the backward passes the gradients back
                cur["k"] = collectives.ring_permute(cur["k"], axis_name, 1, mesh=mesh)
                cur["v"] = collectives.ring_permute(cur["v"], axis_name, 1, mesh=mesh)
                if cur["seg"] is not None:
                    cur["seg"] = collectives.ring_permute(cur["seg"].contiguous(), axis_name, 1,
                                                          mesh=mesh)
            return cur["k"], cur["v"], cur["seg"]
    return ring_attention_rank(q, kv_of, rank, cp, causal=causal, sm_scale=sm_scale,
                               zigzag=zigzag, seg=seg)


@functools.lru_cache(maxsize=None)
def make_ring_attention(mesh, axis_name: str = "cp", rotate_method: str = "alltoall",
                        zigzag: bool = True):
    """``attn(q, k, v, *, causal=True, segment_ids=None)`` over ``mesh``'s
    ``axis_name``, on each rank's LOCAL shards (under zigzag, the caller
    reorders tokens and segment ids with :func:`zigzag_shard` first, as
    ``Accelerator.maybe_context_parallel`` does).  Without causality the
    shards are contiguous."""

    def attn(q, k, v, *, causal: bool = True, segment_ids=None):
        seg = segment_ids.to(torch.int32) if segment_ids is not None else None
        return ring_attention_sharded(q, k, v, seg, mesh=mesh, axis_name=axis_name,
                                      causal=causal, rotate_method=rotate_method,
                                      zigzag=zigzag)

    return attn


def ring_shard_positions(t_local: int, device=None):
    """The global positions of this rank's shard of a ``t_local``-token
    sequence on the newest accelerator state's ``cp`` ring (``arange``
    without one).  The JAX model applies its rotary embeddings at the
    zigzag array index; the port at the token's position, so a cp step
    computes the unsharded step's loss."""
    from ..state import ambient_mesh

    mesh = ambient_mesh()[0]
    if mesh is None:
        return torch.arange(t_local, device=device)
    cp = collectives.axis_size("cp", mesh)
    return shard_positions(t_local, collectives.axis_index("cp", mesh), cp, device=device)


def ring_attention(q, k, v, *, causal: bool = True, segment_ids=None):
    """The config-name entry (``LlamaConfig(attn_implementation="ring")``):
    the ring over the newest accelerator state's mesh, ``alltoall``."""
    from ..state import ambient_mesh

    mesh = ambient_mesh()[0]
    if mesh is None:
        raise RuntimeError("ring attention needs a device mesh: construct an Accelerator "
                           "with a parallelism_config first")
    return make_ring_attention(mesh, rotate_method="alltoall")(
        q, k, v, causal=causal, segment_ids=segment_ids)
