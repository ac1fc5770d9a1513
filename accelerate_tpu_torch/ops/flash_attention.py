"""Paged attention for the serving engine: the two kernel wrappers and their
plain PyTorch versions.

Mirrors ``accelerate_tpu/ops/flash_attention.py``:

- :func:`paged_decode_attention` (JAX ``paged_decode_attention``, :675):
  ragged single-token decode over a paged KV pool;
- :func:`paged_multitoken_attention` (JAX ``paged_multitoken_attention``,
  :829): a window of ``T`` contiguous query tokens per slot (chunked
  prefill).

Both keep the JAX public layouts.  On a CUDA tensor a wrapper launches its
hand-written kernel (``csrc/paged_attention.cu``, built at first use) or
raises; on a CPU tensor it runs the plain version beside it.  Each wrapper
counts its kernel launches in a plain integer attribute, ``launches``.
Only bf16 pages (the plain configuration) are taken here: quantized pages
are ROADMAP B5/B6's quantized variants (kernels #5 and #7).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

_KERNEL_HEAD_DIMS = (64, 96, 128)


_P, _I = ctypes.c_void_p, ctypes.c_int
# device, q, k_pages, v_pages, block_tables, positions, out, then
# S T H Hkv D P page n, sm_scale and the stream
_LAUNCH = ([_I] + [_P] * 6 + [_I] * 8 + [ctypes.c_float, _P], _I)
_SIGNATURES = {
    "paged_decode_attention_bf16": _LAUNCH,
    "paged_multitoken_attention_bf16": _LAUNCH,
    "paged_attention_error_string": ([_I], ctypes.c_char_p),
}


def _lib() -> ctypes.CDLL:
    return _build.load("paged_attention", _SIGNATURES)


def _check_kernel_operands(name, q, k_pages, v_pages, block_tables, positions):
    """The kernel takes bf16 q/pages and int32 tables/positions, contiguous,
    on one CUDA device, 16-byte aligned, at a head dim it was built for."""
    dev = q.device
    for label, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                     ("block_tables", block_tables), ("positions", positions)):
        if t.device != dev:
            raise ValueError(f"{name}: {label} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    for label, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {label} must be bfloat16 for the CUDA "
                            f"kernel, got {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be 16-byte aligned")
    for label, t in (("block_tables", block_tables), ("positions", positions)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {label} must be int32, got {t.dtype}")
    d = q.shape[-1]
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: the CUDA kernel is built for head dims "
                         f"{_KERNEL_HEAD_DIMS}, got {d}")
    if k_pages.shape != v_pages.shape:
        raise ValueError(f"{name}: k_pages {tuple(k_pages.shape)} and v_pages "
                         f"{tuple(v_pages.shape)} differ")


def _geometry(q_heads, k_pages, block_tables, d):
    hkv, num_pages, page_size, d_kv = k_pages.shape
    if d_kv != d:
        raise ValueError(f"head dim {d} != page head dim {d_kv}")
    if q_heads % hkv != 0:
        raise ValueError(f"num q heads {q_heads} not divisible by kv heads {hkv}")
    return hkv, num_pages, page_size, block_tables.shape[1]


def paged_multitoken_attention_plain(q, k_pages, v_pages, block_tables, positions,
                                     *, sm_scale: Optional[float] = None):
    """Plain PyTorch version of the paged attention kernels, in f32.

    Gathers each slot's ``n * page_size`` kv rows through its block table
    and applies the kernels' semantics at once: scores ``(q . k) *
    sm_scale`` in f32, row ``i`` of slot ``s`` sees kv index ``j`` iff
    ``j <= positions[s, 0] + i``, masked scores take the finite
    ``DEFAULT_MASK_VALUE``, ``p . v`` in f32, divide by the row sum (or by
    1 where it is 0).  Pages past the window's last row are skipped, as the
    kernels skip them: a slot whose window lies before position 0 returns
    zeros.  Returns ``q.dtype``."""
    s_slots, width, h, d = q.shape
    hkv, _, page_size, n = _geometry(h, k_pages, block_tables, d)
    group = h // hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    bt = block_tables.long()
    k = k_pages[:, bt].float().reshape(hkv, s_slots, n * page_size, d)
    v = v_pages[:, bt].float().reshape(hkv, s_slots, n * page_size, d)
    qg = q.float().reshape(s_slots, width, hkv, group, d)
    scores = torch.einsum("stkgd,ksjd->skgtj", qg, k) * sm_scale
    row_pos = positions[:, :1].long() + torch.arange(width, device=q.device)
    kv_idx = torch.arange(n * page_size, device=q.device)
    live = kv_idx[None, None, :] <= row_pos[:, :, None]            # [S, T, J]
    visited = (kv_idx[None, :] // page_size) <= torch.where(
        row_pos[:, -1:] < 0, -1, row_pos[:, -1:] // page_size)      # [S, J]
    scores = torch.where(live[:, None, None], scores,
                         torch.tensor(DEFAULT_MASK_VALUE, device=q.device))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m) * visited[:, None, None, None, :]
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("skgtj,ksjd->skgtd", p, v) / torch.where(l == 0, 1.0, l)
    return out.permute(0, 3, 1, 2, 4).reshape(s_slots, width, h, d).to(q.dtype)


def paged_decode_attention_plain(q, k_pages, v_pages, block_tables, positions,
                                 *, sm_scale: Optional[float] = None):
    """Plain PyTorch version of :func:`paged_decode_attention`: the
    multi-token version at a window of one token."""
    return paged_multitoken_attention_plain(
        q[:, None], k_pages, v_pages, block_tables, positions[:, None],
        sm_scale=sm_scale,
    )[:, 0]


def _run(wrapper, plain, q, k_pages, v_pages, block_tables, positions, sm_scale):
    """Both wrappers' body: the plain version on a CPU tensor; on a CUDA
    tensor, checks the operands, launches ``<wrapper>_bf16`` on the current
    stream into a fresh output and counts the launch; any other device
    raises."""
    name = wrapper.__name__
    s_slots, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    width = q.shape[1] if q.dim() == 4 else 1
    hkv, num_pages, page_size, n = _geometry(h, k_pages, block_tables, d)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return plain(q, k_pages, v_pages, block_tables, positions, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    _check_kernel_operands(name, q, k_pages, v_pages, block_tables, positions)
    if positions.shape != q.shape[:-2] or block_tables.shape[0] != s_slots:
        raise ValueError(f"{name}: positions {tuple(positions.shape)} / "
                         f"block_tables {tuple(block_tables.shape)} do not "
                         f"match q {tuple(q.shape)}")
    out = torch.empty_like(q)
    err = getattr(_lib(), f"{name}_bf16")(
        q.device.index or 0, q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_tables.data_ptr(), positions.data_ptr(),
        out.data_ptr(), s_slots, width, h, hkv, d, num_pages, page_size, n,
        float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        msg = _lib().paged_attention_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA kernel launch failed: {msg} ({err})")
    wrapper.launches += 1
    return out


def paged_decode_attention(q, k_pages, v_pages, block_tables, positions, *,
                           sm_scale: Optional[float] = None):
    """Ragged single-token decode attention over a paged KV pool (JAX
    ``paged_decode_attention``).

    q: ``[S, H, D]``; k_pages/v_pages: ``[Hkv, P, page_size, D]``;
    block_tables: ``[S, n]`` int32; positions: ``[S]`` int32 — kv indices
    ``0..position`` are live.  GQA without repeating K/V.  Returns
    ``[S, H, D]`` in ``q.dtype``.

    CUDA tensors launch ``paged_decode_attention_bf16``
    (``csrc/paged_attention.cu``) on the current stream; CPU tensors run
    :func:`paged_decode_attention_plain`."""
    return _run(paged_decode_attention, paged_decode_attention_plain,
                q, k_pages, v_pages, block_tables, positions, sm_scale)


paged_decode_attention.launches = 0


def paged_multitoken_attention(q, k_pages, v_pages, block_tables, positions, *,
                               sm_scale: Optional[float] = None):
    """Multi-token paged attention (JAX ``paged_multitoken_attention``): a
    ``T``-token query window per slot against that slot's paged K/V — the
    chunked-prefill shape ``[1, C]``.

    q: ``[S, T, H, D]``; positions: ``[S, T]`` int32, **contiguous per
    row** (``positions[s, i] == positions[s, 0] + i``; only column 0 is
    read).  Row ``i`` causal-masks at ``positions[s, 0] + i``.  Returns
    ``[S, T, H, D]``.

    CUDA tensors launch ``paged_multitoken_attention_bf16``; CPU tensors
    run :func:`paged_multitoken_attention_plain`."""
    return _run(paged_multitoken_attention, paged_multitoken_attention_plain,
                q, k_pages, v_pages, block_tables, positions, sm_scale)


paged_multitoken_attention.launches = 0


def reset_launch_counts() -> None:
    """Zero both wrappers' launch counters."""
    paged_decode_attention.launches = 0
    paged_multitoken_attention.launches = 0
