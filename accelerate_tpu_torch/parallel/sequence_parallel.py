"""Ulysses sequence parallelism over the ``sp`` mesh dimension (mirrors
``accelerate_tpu/parallel/sequence_parallel.py``).

Activations are sharded along the sequence everywhere but inside
attention, where two ``all_to_all``s re-shard to the heads, so every rank
attends over the whole sequence for its share of the heads (DeepSpeed
Ulysses).  Each rank holds a contiguous ``T / sp`` slice of the sequence
(not cp's zigzag); the model applies its rotary embeddings at the
tokens' global positions (:func:`shard_positions`).  The inner attention
is the port's :func:`~..ops.flash_attention.flash_attention`: kernels
#1-#3 on a CUDA tensor, their plain versions on the CPU.

Requires ``num_heads % sp == 0`` and ``seq_len % sp == 0``; under tp, sp
splits the rank's tp share of the heads.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from . import collectives as C


def _default_inner(q, k, v, *, causal: bool = True, segment_ids=None):
    from ..ops.flash_attention import flash_attention

    return flash_attention(q, k, v, causal=causal, segment_ids=segment_ids)


def ulysses_attention_sharded(q, k, v, seg=None, *, mesh=None, axis_name: str = "sp",
                              causal: bool = True, inner_attn: Optional[Callable] = None,
                              heads_sharded: bool = False):
    """One rank's Ulysses attention (the JAX ``shard_map`` body): ``q`` /
    ``k`` / ``v`` ``[B, T/sp, H, D]`` -> ``[B, T/sp, H, D]``.

    all_to_all #1 sends heads and gathers the sequence (``[B, T, H/sp,
    D]``); the inner attention runs causal by index over the whole
    sequence; all_to_all #2 sends it back.  GQA stays at kv-head width
    (rank r's q heads read rank r's kv heads) when the caller has made
    ``Hkv % sp == 0``.  ``seg`` ``[B, T/sp]`` is all-gathered.

    ``heads_sharded`` (the collective-matmul boundary,
    ``ops/collective_matmul.ulysses_sp_boundary``): q / k / v arrive as
    ``[B, T, H/sp, D]`` and the output leaves so, ``seg`` whole; no
    all_to_all runs."""
    inner = inner_attn or _default_inner
    if heads_sharded:
        q_h, k_h, v_h, seg_full = q, k, v, seg
    else:
        def seq2head(x):
            return C.all_to_all(x.contiguous(), axis_name, split_axis=2, concat_axis=1,
                                mesh=mesh)

        q_h, k_h, v_h = seq2head(q), seq2head(k), seq2head(v)
        seg_full = (C.all_gather(seg.contiguous(), axis_name, axis=1, mesh=mesh)
                    if seg is not None else None)
    kwargs = {"segment_ids": seg_full} if seg_full is not None else {}
    out_h = inner(q_h.contiguous(), k_h.contiguous(), v_h.contiguous(), causal=causal,
                  **kwargs)
    if heads_sharded:
        return out_h
    return C.all_to_all(out_h.contiguous(), axis_name, split_axis=1, concat_axis=2, mesh=mesh)


@functools.lru_cache(maxsize=None)
def make_ulysses_attention(mesh, axis_name: str = "sp", inner_attn: Optional[Callable] = None):
    """``attn(q, k, v, *, causal=True, segment_ids=None,
    heads_sharded=False)`` over ``mesh``'s ``axis_name`` on each rank's
    local shards (JAX :85).  kv heads that do not split over ``sp`` are
    repeated to q width first (the aligned case keeps kv at its width).
    ``heads_sharded`` q / k / v hold this rank's heads already (the
    boundary's gate, ``ulysses_sp_boundary``, checked the split)."""

    def attn(q, k, v, *, causal: bool = True, segment_ids=None, heads_sharded: bool = False):
        h_q, h_kv = q.shape[2], k.shape[2]
        sp = C.axis_size(axis_name, mesh)
        if heads_sharded:
            if h_q % h_kv:
                raise ValueError(f"heads_sharded ulysses: {h_q} q heads over {h_kv} kv heads")
        elif h_kv != h_q and h_kv % sp != 0:
            rep = h_q // h_kv
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        if not heads_sharded and h_q % sp != 0:
            raise ValueError(f"num_heads {h_q} must be divisible by sp={sp}")
        seg = segment_ids.to(torch.int32) if segment_ids is not None else None
        return ulysses_attention_sharded(q, k, v, seg, mesh=mesh, axis_name=axis_name,
                                         causal=causal, inner_attn=inner_attn,
                                         heads_sharded=heads_sharded)

    return attn


def ulysses_attention(q, k, v, *, causal: bool = True, segment_ids=None,
                      heads_sharded: bool = False):
    """The config-name entry (``LlamaConfig(attn_implementation=
    "ulysses")``) over the newest accelerator state's mesh; without a mesh
    (or at ``sp`` 1) the inner attention on the local sequence."""
    from ..state import ambient_mesh

    mesh = ambient_mesh()[0]
    if mesh is None or C.mesh_sizes(mesh).get("sp", 1) == 1:
        return _default_inner(q, k, v, causal=causal, segment_ids=segment_ids)
    return make_ulysses_attention(mesh)(q, k, v, causal=causal, segment_ids=segment_ids,
                                        heads_sharded=heads_sharded)


# ---------------------------------------------------------------------------
# the sequence-sharded batch and the loss
# ---------------------------------------------------------------------------


def shard_positions(t_local: int, sp_rank: int, device=None) -> torch.Tensor:
    """The global positions of ``sp_rank``'s contiguous ``t_local`` tokens."""
    return sp_rank * t_local + torch.arange(t_local, device=device)


def shard_batch_along_sequence(batch, mesh, axis_name: str = "sp", seq_axis: int = 1):
    """This rank's contiguous slice of the sequence of every tensor of a
    batch (a dict, or one tensor) with at least ``seq_axis + 1`` dims (JAX
    :156 re-specs the global batch the same way).  ``labels`` are shifted
    to next-token targets first (``shift_labels``, ``-100`` past the end):
    a slice's last token's target lives on the next rank.  The loss then
    averages with every rank's tokens in the denominator (the train step's
    global token mean, or :func:`cross_rank_token_mean`)."""
    n = C.axis_size(axis_name, mesh)
    rank = C.axis_index(axis_name, mesh)

    def take(x):
        if not isinstance(x, torch.Tensor) or x.dim() <= seq_axis:
            return x
        if x.shape[seq_axis] % n:
            raise ValueError(f"sequence dim {seq_axis} of {tuple(x.shape)} does not split "
                             f"over {axis_name}={n}")
        return torch.chunk(x, n, dim=seq_axis)[rank].contiguous()

    if not isinstance(batch, dict):
        return take(batch)
    batch = dict(batch)
    if "labels" in batch and "shift_labels" not in batch and n > 1:
        labels = batch.pop("labels")
        shift = torch.roll(labels, -1, dims=seq_axis)
        shift.narrow(seq_axis, labels.shape[seq_axis] - 1, 1).fill_(-100)
        batch["shift_labels"] = shift
    return {k: take(v) for k, v in batch.items()}


def cross_rank_token_mean(per_token_loss, mask, axis_names, mesh=None):
    """``sum(loss * mask) / sum(mask)`` with both sums taken over the named
    dimensions (JAX :176); differentiable (the sums' backward is the
    identity, so each rank's tokens weigh ``1 / sum(mask)``)."""
    num = torch.sum(per_token_loss * mask)
    den = torch.sum(mask).to(num.dtype)
    num = C.psum(num, axis_names, mesh)
    den = C.psum(den, axis_names, mesh)
    return num / torch.clamp(den, min=1.0)
