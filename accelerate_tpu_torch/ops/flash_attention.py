"""Flash attention for training and paged attention for serving: the kernel
wrappers and their plain PyTorch versions.

Mirrors ``accelerate_tpu/ops/flash_attention.py``:

- :func:`flash_attention` (JAX ``flash_attention``, :1135): causal /
  segment / position-masked attention over ``[B, T, H, D]`` queries with
  GQA, differentiable in q, k, v and (with ``return_lse``) in the
  logsumexp.  Its forward is kernel #1 (:func:`flash_fwd`, JAX
  ``_attn_kernel``), its backward kernels #2 (:func:`flash_dq`,
  ``_dq_kernel``) and #3 (:func:`flash_dkv`, ``_dkv_kernel``);
  :func:`flash_attention_plain` is the same function on the plain versions;
- :func:`paged_decode_attention` (JAX ``paged_decode_attention``, :675):
  ragged single-token decode over a paged KV pool;
- :func:`paged_multitoken_attention` (JAX ``paged_multitoken_attention``,
  :829): a window of ``T`` contiguous query tokens per slot (chunked
  prefill).

All keep the JAX public layouts.  On a CUDA tensor a wrapper launches its
hand-written kernel (``csrc/flash_attention.cu``, ``csrc/paged_attention.cu``,
built at first use) or raises; on a CPU tensor it runs the plain version
beside it.  Each wrapper counts its kernel launches in a plain integer
attribute, ``launches``.  Only bf16 pages (the plain configuration) are
taken here: quantized pages are ROADMAP B5/B6's quantized variants
(kernels #5 and #7).
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


# ---------------------------------------------------------------------------
# Flash attention (kernels #1-#3)
# ---------------------------------------------------------------------------

# device, q, k, v, seg_q, seg_kv, pos_q, pos_kv (NULL when absent), then the
# kernel's own tensors, then B T S H Hkv D causal, sm_scale and the stream
_FLASH_HEAD = [_I] + [_P] * 7
_FLASH_TAIL = [_I] * 7 + [ctypes.c_float, _P]
_FLASH_SIGNATURES = {
    "flash_attention_fwd_bf16": (_FLASH_HEAD + [_P] * 2 + _FLASH_TAIL, _I),   # out, lse
    "flash_attention_dq_bf16": (_FLASH_HEAD + [_P] * 4 + _FLASH_TAIL, _I),    # g, lse, delta, dq
    "flash_attention_dkv_bf16": (_FLASH_HEAD + [_P] * 5 + _FLASH_TAIL, _I),   # g, lse, delta, dk, dv
    "flash_attention_error_string": ([_I], ctypes.c_char_p),
}


def _flash_lib() -> ctypes.CDLL:
    return _build.load("flash_attention", _FLASH_SIGNATURES)


def _valid_mask(t, s, causal, seg_q, seg_kv, pos_q, pos_kv, device):
    """``[B or 1, T, S]``: which (query, key) pairs attend — the causal
    comparison by index, or by position where positions are given, and
    segment equality (JAX ``_masked_scores``)."""
    valid = torch.ones(1, t, s, dtype=torch.bool, device=device)
    if causal:
        if pos_q is not None:
            valid = pos_q[:, :, None] >= pos_kv[:, None, :]
        else:
            rows = torch.arange(t, device=device)[:, None]
            valid = (rows >= torch.arange(s, device=device)[None])[None]
    if seg_q is not None:
        valid = valid & (seg_q[:, :, None] == seg_kv[:, None, :])
    return valid


def _plain_scores(q, k, valid, sm_scale):
    """Masked scores ``[B, Hkv, G, T, S]`` in f32 and the mask broadcast to
    them; q ``[B, T, H, D]``, k ``[B, S, Hkv, D]``."""
    b, t, h, d = q.shape
    hkv = k.shape[2]
    qg = q.float().reshape(b, t, hkv, h // hkv, d)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * sm_scale
    valid = valid[:, None, None]
    return torch.where(valid, scores, DEFAULT_MASK_VALUE), valid


def flash_fwd_plain(q, k, v, seg_q=None, seg_kv=None, pos_q=None, pos_kv=None, *,
                    causal: bool = True, sm_scale: float):
    """Plain version of kernel #1: softmax attention in f32 with the
    kernel's masks and casts — masked pairs score ``DEFAULT_MASK_VALUE``,
    ``p`` is rounded to the input dtype before ``p . v``, the output is
    divided by the row sum (by 1 where it is 0).  Returns ``out`` ``[B, T,
    H, D]`` in ``q.dtype`` and ``lse`` ``[B, H, T]`` in f32."""
    b, t, h, d = q.shape
    s = k.shape[1]
    valid = _valid_mask(t, s, causal, seg_q, seg_kv, pos_q, pos_kv, q.device)
    scores, _ = _plain_scores(q, k, valid, sm_scale)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0, 1.0, l)
    out = torch.einsum("bkgts,bskd->bkgtd", p.to(v.dtype).float(), v.float()) / safe_l
    out = out.permute(0, 3, 1, 2, 4).reshape(b, t, h, d).to(q.dtype)
    lse = (m + torch.log(safe_l))[..., 0].reshape(b, h, t)
    return out, lse


def _plain_bwd_tiles(q, k, v, g, lse, delta, valid_bts, sm_scale):
    """(p, ds) ``[B, Hkv, G, T, S]`` of the backward recompute (JAX
    ``_bwd_tile``): ``p = exp(s - lse)`` and ``ds = p (dp - delta) scale``,
    both hard-zeroed off the mask."""
    b, t, h, d = q.shape
    hkv = k.shape[2]
    scores, valid = _plain_scores(q, k, valid_bts, sm_scale)
    lse5 = lse.reshape(b, hkv, h // hkv, t)[..., None]
    delta5 = delta.reshape(b, hkv, h // hkv, t)[..., None]
    p = torch.where(valid, torch.exp(scores - lse5), 0.0)
    gg = g.float().reshape(b, t, hkv, h // hkv, d)
    dp = torch.einsum("btkgd,bskd->bkgts", gg, v.float())
    ds = torch.where(valid, p * (dp - delta5) * sm_scale, 0.0)
    return p, ds


def flash_dq_plain(q, k, v, g, lse, delta, seg_q=None, seg_kv=None, pos_q=None,
                   pos_kv=None, *, causal: bool = True, sm_scale: float):
    """Plain version of kernel #2: ``dq = ds . k`` with ``ds`` rounded to
    the input dtype first.  ``lse``/``delta`` ``[B, H, T]`` f32 (``delta``
    already holds ``rowsum(g . out) - g_lse``).  Returns ``q.dtype``."""
    b, t, h, d = q.shape
    valid = _valid_mask(t, k.shape[1], causal, seg_q, seg_kv, pos_q, pos_kv, q.device)
    _, ds = _plain_bwd_tiles(q, k, v, g, lse, delta, valid, sm_scale)
    dq = torch.einsum("bkgts,bskd->btkgd", ds.to(q.dtype).float(), k.float())
    return dq.reshape(b, t, h, d).to(q.dtype)


def flash_dkv_plain(q, k, v, g, lse, delta, seg_q=None, seg_kv=None, pos_q=None,
                    pos_kv=None, *, causal: bool = True, sm_scale: float):
    """Plain version of kernel #3: ``dk = ds^T . q`` and ``dv = p^T . g``
    summed over each kv head's group of q heads, ``ds`` and ``p`` rounded
    to the input dtype first.  Returns ``(dk, dv)`` in k's / v's dtype."""
    b, t, h, d = q.shape
    hkv = k.shape[2]
    valid = _valid_mask(t, k.shape[1], causal, seg_q, seg_kv, pos_q, pos_kv, q.device)
    p, ds = _plain_bwd_tiles(q, k, v, g, lse, delta, valid, sm_scale)
    qg = q.float().reshape(b, t, hkv, h // hkv, d)
    gg = g.float().reshape(b, t, hkv, h // hkv, d)
    dk = torch.einsum("bkgts,btkgd->bskd", ds.to(q.dtype).float(), qg)
    dv = torch.einsum("bkgts,btkgd->bskd", p.to(q.dtype).float(), gg)
    return dk.to(k.dtype), dv.to(v.dtype)


def _check_flash_operands(name, tensors: dict, ints: dict, f32s: dict):
    """The flash kernels take bf16 q/k/v/g, int32 segment ids and
    positions, f32 lse/delta; all contiguous on one CUDA device, 16-byte
    aligned, at a head dim they were built for."""
    dev = tensors["q"].device
    for group, dtype in ((tensors, torch.bfloat16), (ints, torch.int32),
                         (f32s, torch.float32)):
        for label, t in group.items():
            if t is None:
                continue
            if t.device != dev:
                raise ValueError(f"{name}: {label} is on {t.device}, q on {dev}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: {label} must be contiguous")
            if t.dtype != dtype:
                raise TypeError(f"{name}: {label} must be {dtype} for the CUDA "
                                f"kernel, got {t.dtype}")
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: {label} must be 16-byte aligned")
    q, k = tensors["q"], tensors["k"]
    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: the CUDA kernel is built for head dims "
                         f"{_KERNEL_HEAD_DIMS}, got {d}")
    want = {"k": (b, s, hkv, d), "v": (b, s, hkv, d), "g": (b, t, h, d),
            "seg_q": (b, t), "pos_q": (b, t), "seg_kv": (b, s), "pos_kv": (b, s),
            "lse": (b, h, t), "delta": (b, h, t)}
    for label, x in {**tensors, **ints, **f32s}.items():
        if x is not None and label in want and tuple(x.shape) != want[label]:
            raise ValueError(f"{name}: {label} has shape {tuple(x.shape)}, "
                             f"expected {want[label]} for q {tuple(q.shape)}")
    if h % hkv:
        raise ValueError(f"{name}: num q heads {h} not divisible by kv heads {hkv}")


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch_flash(wrapper, cname, q, k, v, seg_q, seg_kv, pos_q, pos_kv, own: list,
                  causal, sm_scale):
    """Launch the C function ``cname`` on the current stream with ``own``
    (the kernel's own operands and outputs, in the C order) and count the
    launch on ``wrapper``."""
    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    err = getattr(_flash_lib(), cname)(
        q.device.index or 0, q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(seg_q),
        _ptr(seg_kv), _ptr(pos_q), _ptr(pos_kv), *[x.data_ptr() for x in own],
        b, t, s, h, hkv, d, int(causal), float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        msg = _flash_lib().flash_attention_error_string(err).decode()
        raise RuntimeError(f"{wrapper.__name__}: CUDA kernel launch failed: {msg} ({err})")
    wrapper.launches += 1


def _flash_route(name, q):
    """True for the CUDA kernel, False for the plain version; raises on any
    other device."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    return True


def flash_fwd(q, k, v, seg_q=None, seg_kv=None, pos_q=None, pos_kv=None, *,
              causal: bool = True, sm_scale: float):
    """Kernel #1 (JAX ``_attn_kernel``): ``(out [B, T, H, D], lse [B, H, T]
    f32)``.  CUDA tensors launch ``flash_attention_fwd_bf16``
    (``csrc/flash_attention.cu``); CPU tensors run :func:`flash_fwd_plain`."""
    if not _flash_route("flash_fwd", q):
        return flash_fwd_plain(q, k, v, seg_q, seg_kv, pos_q, pos_kv,
                               causal=causal, sm_scale=sm_scale)
    _check_flash_operands("flash_fwd", {"q": q, "k": k, "v": v},
                          {"seg_q": seg_q, "seg_kv": seg_kv, "pos_q": pos_q,
                           "pos_kv": pos_kv}, {})
    b, t, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
    _launch_flash(flash_fwd, "flash_attention_fwd_bf16", q, k, v, seg_q, seg_kv, pos_q, pos_kv, [out, lse],
                  causal, sm_scale)
    return out, lse


flash_fwd.launches = 0


def flash_dq(q, k, v, g, lse, delta, seg_q=None, seg_kv=None, pos_q=None, pos_kv=None,
             *, causal: bool = True, sm_scale: float):
    """Kernel #2 (JAX ``_dq_kernel``): dq ``[B, T, H, D]``.  CUDA tensors
    launch ``flash_attention_dq_bf16``; CPU tensors run
    :func:`flash_dq_plain`."""
    if not _flash_route("flash_dq", q):
        return flash_dq_plain(q, k, v, g, lse, delta, seg_q, seg_kv, pos_q, pos_kv,
                              causal=causal, sm_scale=sm_scale)
    _check_flash_operands("flash_dq", {"q": q, "k": k, "v": v, "g": g},
                          {"seg_q": seg_q, "seg_kv": seg_kv, "pos_q": pos_q,
                           "pos_kv": pos_kv}, {"lse": lse, "delta": delta})
    dq = torch.empty_like(q)
    _launch_flash(flash_dq, "flash_attention_dq_bf16", q, k, v, seg_q, seg_kv, pos_q, pos_kv, [g, lse, delta, dq],
                  causal, sm_scale)
    return dq


flash_dq.launches = 0


def flash_dkv(q, k, v, g, lse, delta, seg_q=None, seg_kv=None, pos_q=None, pos_kv=None,
              *, causal: bool = True, sm_scale: float):
    """Kernel #3 (JAX ``_dkv_kernel``): ``(dk, dv)`` ``[B, S, Hkv, D]``,
    each GQA group's q heads summed in the kernel, deterministic.  CUDA
    tensors launch ``flash_attention_dkv_bf16``; CPU tensors run
    :func:`flash_dkv_plain`."""
    if not _flash_route("flash_dkv", q):
        return flash_dkv_plain(q, k, v, g, lse, delta, seg_q, seg_kv, pos_q, pos_kv,
                               causal=causal, sm_scale=sm_scale)
    _check_flash_operands("flash_dkv", {"q": q, "k": k, "v": v, "g": g},
                          {"seg_q": seg_q, "seg_kv": seg_kv, "pos_q": pos_q,
                           "pos_kv": pos_kv}, {"lse": lse, "delta": delta})
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_flash(flash_dkv, "flash_attention_dkv_bf16", q, k, v, seg_q, seg_kv, pos_q, pos_kv,
                  [g, lse, delta, dk, dv], causal, sm_scale)
    return dk, dv


flash_dkv.launches = 0


class _Flash(torch.autograd.Function):
    """``(out, lse [B, H, T])`` with both outputs differentiable (JAX
    ``_flash`` custom_vjp).  The forward is kernel #1; the backward forms
    ``delta = rowsum(g . out) - g_lse`` as one torch op, then runs kernels
    #2 and #3 — or the three plain versions when ``plain`` is set.  The
    kernel wrappers are looked up when called, so a caller can route them
    (``chip_smoke.py`` holds each launch against its plain version)."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, pos_q, pos_kv, causal, sm_scale, plain):
        fwd = flash_fwd_plain if plain else flash_fwd
        out, lse = fwd(q, k, v, seg_q, seg_kv, pos_q, pos_kv, causal=causal,
                       sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, out, lse, seg_q, seg_kv, pos_q, pos_kv)
        ctx.causal, ctx.sm_scale, ctx.plain = causal, sm_scale, plain
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, out, lse, seg_q, seg_kv, pos_q, pos_kv = ctx.saved_tensors
        if g is None:
            g = torch.zeros_like(out)
        g = g.contiguous()
        delta = (g.float() * out.float()).sum(dim=-1).transpose(1, 2)
        if g_lse is not None:
            delta = delta - g_lse.float()
        delta = delta.contiguous()
        dq_fn, dkv_fn = ((flash_dq_plain, flash_dkv_plain) if ctx.plain
                         else (flash_dq, flash_dkv))
        kw = dict(causal=ctx.causal, sm_scale=ctx.sm_scale)
        dq = dq_fn(q, k, v, g, lse, delta, seg_q, seg_kv, pos_q, pos_kv, **kw)
        dk, dv = dkv_fn(q, k, v, g, lse, delta, seg_q, seg_kv, pos_q, pos_kv, **kw)
        return dq, dk, dv, None, None, None, None, None, None, None


def _flash_call(q, k, v, *, causal, segment_ids, kv_segment_ids, positions,
                kv_positions, sm_scale, block_q, block_k, return_lse, plain):
    """:func:`flash_attention`'s argument checks (the JAX ``ValueError``s)
    and the call of :class:`_Flash`."""
    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if h % hkv != 0:
        raise ValueError(f"num q heads {h} not divisible by kv heads {hkv}")
    for label, blk in (("block_q", block_q), ("block_k", block_k)):
        if blk is not None:
            raise ValueError(f"{label}={blk}: the CUDA kernels use their own tiles "
                             "(csrc/flash_attention.cu); leave it None")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    seg_q = seg_kv = pos_q = pos_kv = None
    if segment_ids is not None:
        if kv_segment_ids is None:
            if s != t:
                raise ValueError(
                    "segment_ids without kv_segment_ids requires self-attention (T == S)"
                )
            kv_segment_ids = segment_ids
        seg_q = segment_ids.to(torch.int32).contiguous()
        seg_kv = kv_segment_ids.to(torch.int32).contiguous()
        if seg_q.shape[-1] != t:
            raise ValueError("segment_ids length must match the query sequence")
        if seg_kv.shape[-1] != s:
            raise ValueError("kv_segment_ids length must match the KV sequence")
    elif kv_segment_ids is not None:
        raise ValueError("kv_segment_ids requires segment_ids")
    if positions is not None:
        pos_q = positions.to(torch.int32).contiguous()
        pos_kv = (positions if kv_positions is None else kv_positions).to(torch.int32).contiguous()
        if pos_q.shape[-1] != t:
            raise ValueError("positions length must match the query sequence")
        if pos_kv.shape[-1] != s:
            raise ValueError("kv_positions length must match the KV sequence")
    out, lse = _Flash.apply(q, k, v, seg_q, seg_kv, pos_q, pos_kv, causal,
                            float(sm_scale), plain)
    if return_lse:
        return out, lse.transpose(1, 2)
    return out


def flash_attention(q, k, v, *, causal: bool = True, segment_ids=None,
                    kv_segment_ids=None, positions=None, kv_positions=None,
                    sm_scale: Optional[float] = None, block_q: Optional[int] = None,
                    block_k: Optional[int] = None, return_lse: bool = False):
    """Drop-in replacement for :func:`~..models.llama.native_attention`
    (JAX ``flash_attention``).

    q: ``[B, T, H, D]``; k/v: ``[B, S, Hkv, D]``; GQA without repeating
    K/V.  ``segment_ids`` ``[B, T]`` masks cross-segment pairs;
    ``kv_segment_ids`` ``[B, S]`` gives the KV side its own ids (without
    it, ``T == S`` is required and the query ids are reused).
    ``positions``/``kv_positions`` ``[B, T]``/``[B, S]`` make the causal
    comparison positional.  ``return_lse`` also returns the logsumexp
    ``[B, T, H]`` (f32, differentiable).  ``block_q``/``block_k`` stay in
    the JAX signature but must be None: the CUDA kernels use their own
    tiles (``csrc/flash_attention.cu``).

    CUDA tensors run kernels #1-#3 (bf16, head dims 64/96/128, else
    raises); CPU tensors their plain versions."""
    return _flash_call(q, k, v, causal=causal, segment_ids=segment_ids,
                       kv_segment_ids=kv_segment_ids, positions=positions,
                       kv_positions=kv_positions, sm_scale=sm_scale, block_q=block_q,
                       block_k=block_k, return_lse=return_lse, plain=False)


def flash_attention_plain(q, k, v, *, causal: bool = True, segment_ids=None,
                          kv_segment_ids=None, positions=None, kv_positions=None,
                          sm_scale: Optional[float] = None, block_q: Optional[int] = None,
                          block_k: Optional[int] = None, return_lse: bool = False):
    """:func:`flash_attention` on the plain versions of kernels #1-#3 on
    any device: forward and backward in f32 with the kernels' masks,
    ``DEFAULT_MASK_VALUE`` and casts (``p`` and ``ds`` rounded to the input
    dtype before their products)."""
    return _flash_call(q, k, v, causal=causal, segment_ids=segment_ids,
                       kv_segment_ids=kv_segment_ids, positions=positions,
                       kv_positions=kv_positions, sm_scale=sm_scale, block_q=block_q,
                       block_k=block_k, return_lse=return_lse, plain=True)


def reset_launch_counts() -> None:
    """Zero every kernel wrapper's launch counter."""
    for wrapper in (paged_decode_attention, paged_multitoken_attention, flash_fwd,
                    flash_dq, flash_dkv):
        wrapper.launches = 0
