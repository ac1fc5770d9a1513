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
hand-written kernel (``csrc/flash_attention.cu``, ``csrc/paged_decode.cu``
for decode and the fused LoRA decode on the split plan of
:func:`decode_split_plan`, ``csrc/paged_prefill.cu`` for a prefill window;
built at first use) or raises; on a CPU tensor it
runs the plain version beside it.  Each wrapper counts its kernel launches
in a plain integer attribute, ``launches``, on itself whatever the module's
names hold, so a caller may route a stand-in in its place
(``chip_smoke.py`` does).

Quantized pages (int8 or e4m3 codes with per-(kv head, page) f32 amaxes
``k_scales`` / ``v_scales`` ``[Hkv, P]``, JAX :675 / :829): given the
scales, the two paged wrappers hand over to
:func:`paged_decode_attention_quant` (kernel #5, JAX
``_paged_decode_kernel_quant``) and :func:`paged_multitoken_attention_quant`
(#7, ``_paged_multitoken_kernel_quant``), which count their own launches.
Codes widen to ``f32(code) * (amax / QMAX)`` (JAX ``_dequant_tile`` :579;
QMAX 127 for int8, 448 for e4m3).

:func:`fused_bgmv_paged_decode` (JAX :1011) is decode with a per-slot LoRA
query delta folded in: the delta ``(x . A[id]) . B[id]`` in f32, roped at
the slot's position, added to the pre-roped base query in an f32 tile,
then the decode page loop — kernel #8 (JAX ``_fused_bgmv_decode_kernel``)
over bf16 pages, #9 (``_fused_bgmv_decode_kernel_quant``) over quantized
pages.  Like JAX's engine, the port's engine does not call it; it is a
public op of its own.
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
# the same with k_scales, v_scales after v_pages
_QLAUNCH = ([_I] + [_P] * 8 + [_I] * 8 + [ctypes.c_float, _P], _I)
# kernels #4 / #5 (csrc/paged_decode.cu): device, q, k_pages, v_pages,
# [k_scales, v_scales,] block_tables, positions, out, work, counters, then
# S H Hkv D P page n span rows, sm_scale and the stream
_DECODE_LAUNCH = ([_I] + [_P] * 8 + [_I] * 9 + [ctypes.c_float, _P], _I)
_DECODE_QLAUNCH = ([_I] + [_P] * 10 + [_I] * 9 + [ctypes.c_float, _P], _I)
# kernels #8 / #9 (the same file): device, q_base, x, a_stack, b_stack, ids,
# cos, sin, k_pages, v_pages, k_scales, v_scales, block_tables, positions,
# out, work, counters, then S H Hkv D P page n span rows cluster d_in r N
# max_len, sm_scale and the stream
_FUSED_LAUNCH = ([_I] + [_P] * 16 + [_I] * 14 + [ctypes.c_float, _P], _I)
_DECODE_SIGNATURES = {
    "paged_decode_attention_bf16": _DECODE_LAUNCH,
    **{f"paged_decode_attention_{suffix}": _DECODE_QLAUNCH for suffix in ("int8", "fp8")},
    **{f"fused_bgmv_paged_decode_{suffix}": _FUSED_LAUNCH for suffix in ("bf16", "int8", "fp8")},
    "paged_decode_error_string": ([_I], ctypes.c_char_p),
}
# kernels #6 (bf16 pages) and #7 (codes) on the tensor cores (csrc/paged_prefill.cu)
_PREFILL_SIGNATURES = {
    "paged_multitoken_attention_bf16": _LAUNCH,
    **{f"paged_multitoken_attention_{suffix}": _QLAUNCH for suffix in ("int8", "fp8")},
    "paged_prefill_error_string": ([_I], ctypes.c_char_p),
}
# #6 / #7's tiles: 64 query rows by 64 kv tokens, whatever the page size
# (each token found through its own block-table entry); their shared
# memory, beside 1 KB of alignment: bf16 pages three stages of bf16 K and
# V tiles of 64-column chunks and a page id per block-table entry; codes
# one pair of bf16 tiles, two stages of K and V codes, two f32 column
# scales per token, and per entry the page id and its two amaxes
PREFILL_ROWS, PREFILL_KV_TILE = 64, 64
_PREFILL_BF16_STAGES = 3
_MAX_SHARED_BYTES = 232448      # H100: a block's opt-in shared memory

# Max code magnitude per quantized page dtype (JAX _KV_QMAX :649): symmetric
# int8 uses the full [-127, 127] band; e4m3 codes saturate at 448
_KV_QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0}
_KV_SUFFIX = {torch.int8: "int8", torch.float8_e4m3fn: "fp8"}


def _kv_qmax_for(pages) -> float:
    """QMAX of a quantized page pool (JAX ``_kv_qmax_for``)."""
    if pages.dtype not in _KV_QMAX:
        raise ValueError(f"quantized KV pages must be int8 or float8_e4m3fn, got {pages.dtype}")
    return _KV_QMAX[pages.dtype]


def _decode_lib() -> ctypes.CDLL:
    return _build.load("paged_decode", _DECODE_SIGNATURES)


def _prefill_lib() -> ctypes.CDLL:
    return _build.load("paged_prefill", _PREFILL_SIGNATURES)


# #4 / #5 split a slot's page loop into chunks of this many kv tokens (at
# least one page), one block each (csrc/paged_decode.cu)
DECODE_CHUNK_TOKENS = 256


def decode_split_plan(slots: int, heads: int, kv_heads: int, head_dim: int, page_size: int,
                      pages_per_slot: int) -> dict:
    """The launch plan of kernels #4 / #5 (``csrc/paged_decode.cu``), host
    arithmetic only.  A chunk is ``span`` pages of a block table
    (``DECODE_CHUNK_TOKENS // page_size``, at least 1): a slot at ``pos``
    uses the first ``ceil(min(pos + 1, pages_per_slot * page_size) /
    (span * page_size))`` of the ``chunks`` a table holds, whatever the
    other slots hold.  A block takes ``rows`` query rows (the GQA group
    rounded up to 2, 4 or 8; groups above 8 take ``row_tiles`` tiles of 8).
    ``workspace`` is the f32 shape of the chunks' partials (acc over the
    head dim, then m and l), needed only where ``chunks`` > 1, and
    ``counters`` the int32 count of the per-(slot, kv head x row tile)
    counters the last chunk of each merges under."""
    if page_size < 1 or pages_per_slot < 1:
        raise ValueError(f"paged_decode_attention: page size {page_size} and pages per slot "
                         f"{pages_per_slot} must be positive")
    if kv_heads < 1 or heads % kv_heads:
        raise ValueError(f"num q heads {heads} not divisible by kv heads {kv_heads}")
    group = heads // kv_heads
    rows = 2 if group <= 2 else 4 if group <= 4 else 8
    row_tiles = -(-group // rows)
    span = max(1, DECODE_CHUNK_TOKENS // page_size)
    chunks = -(-pages_per_slot // span)
    return {"span": span, "chunk_tokens": span * page_size, "chunks": chunks, "rows": rows,
            "row_tiles": row_tiles,
            "workspace": (slots, kv_heads * row_tiles, chunks, rows, head_dim + 2),
            "counters": slots * kv_heads * row_tiles}


# #8 / #9 form thread-block clusters of at most this many blocks (the
# portable cluster size) that share one h = x . A[id]
FUSED_MAX_CLUSTER = 8


def fused_decode_plan(slots: int, heads: int, kv_heads: int, head_dim: int, page_size: int,
                      pages_per_slot: int) -> dict:
    """The launch plan of kernels #8 / #9 (``csrc/paged_decode.cu``), host
    arithmetic only: :func:`decode_split_plan`'s split, workspace and
    counters unchanged (so an id-0 slot's output is #4 / #5's bitwise), and
    the ``kv_heads * row_tiles`` blocks of a (slot, chunk) grouped into
    thread-block clusters of ``cluster`` blocks, the largest divisor of
    that count up to 8, each block computing h over 1/cluster of d_in's
    rows.  A cluster's blocks share their slot and chunk, so they are live
    or dead together."""
    plan = decode_split_plan(slots, heads, kv_heads, head_dim, page_size, pages_per_slot)
    blocks = kv_heads * plan["row_tiles"]
    cluster = max(c for c in range(1, FUSED_MAX_CLUSTER + 1) if blocks % c == 0)
    return {**plan, "cluster": cluster}


# the zeroed counters of #4 / #5 (and #8 / #9, on the same plan), one buffer
# per (device, stream, size): every launch leaves them at 0, so none pays a
# memset and their address is fixed; launches on one stream run in order,
# so they never share a buffer with a launch in flight on another stream
_DECODE_COUNTERS: dict = {}


def _decode_counters(device, stream: int, size: int, name: str = "paged_decode_attention"):
    key = (device.index or 0, stream, size)
    buf = _DECODE_COUNTERS.get(key)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"{name}: the merge counters of this stream and size must be "
                "allocated before a CUDA graph capture: run the call once on the capture "
                "stream outside the capture")
        buf = _DECODE_COUNTERS[key] = torch.zeros(size, dtype=torch.int32, device=device)
    return buf


def prefill_plan(width: int, heads: int, kv_heads: int, page_size: int, head_dim: int,
                 pages_per_slot: int, *, quantized: bool) -> dict:
    """The launch plan of kernel #6 (bf16 pages) or #7 (``quantized``: int8
    / e4m3 codes) for a ``width``-token window per slot: ``row_tiles``
    blocks of 64 token-major query rows per (slot, kv head); kv tiles of 64
    tokens whatever the page size, each token found through its own
    block-table entry, so a slot's table spans ``kv_tiles`` of them (a page
    of 64 is one tile, a page of 128 two); the block's shared memory.
    Raises ValueError for what the kernel does not take: a head dim other
    than 64, 96 or 128, a page size below 1, or a block table too long for
    shared memory."""
    name = "paged_multitoken_attention" + ("_quant" if quantized else "")
    if head_dim not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: the CUDA kernel is built for head dims {_KERNEL_HEAD_DIMS}, "
                         f"got {head_dim}")
    if page_size < 1:
        raise ValueError(f"{name}: page size must be positive, got {page_size}")
    tile = 2 * -(-head_dim // 64) * PREFILL_KV_TILE * 128      # a bf16 (K, V) tile pair
    if quantized:
        shared = (tile + 4 * PREFILL_KV_TILE * head_dim + 2 * PREFILL_KV_TILE * 4
                  + 12 * pages_per_slot + 1024)
    else:
        shared = _PREFILL_BF16_STAGES * tile + 4 * pages_per_slot + 1024
    if shared > _MAX_SHARED_BYTES:
        raise ValueError(f"{name}: {pages_per_slot} block-table entries per slot need "
                         f"{shared} bytes of shared memory, above {_MAX_SHARED_BYTES}")
    group = heads // kv_heads
    return {"row_tiles": -(-width * group // PREFILL_ROWS), "rows": PREFILL_ROWS,
            "kv_tile": PREFILL_KV_TILE,
            "kv_tiles": -(-pages_per_slot * page_size // PREFILL_KV_TILE),
            "shared_bytes": shared}


def _check_kernel_operands(name, q, k_pages, v_pages, block_tables, positions,
                           k_scales=None, v_scales=None):
    """The kernel takes bf16 q, bf16 pages (or int8 / e4m3 pages with f32
    scales ``[Hkv, P]``) and int32 tables/positions, contiguous, on one
    CUDA device, 16-byte aligned, at a head dim it was built for."""
    dev = q.device
    quantized = k_scales is not None
    tensors = [("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
               ("block_tables", block_tables), ("positions", positions)]
    if quantized:
        tensors += [("k_scales", k_scales), ("v_scales", v_scales)]
    for label, t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: {label} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    page_dtypes = tuple(_KV_QMAX) if quantized else (torch.bfloat16,)
    for label, t, dtypes in (("q", q, (torch.bfloat16,)), ("k_pages", k_pages, page_dtypes),
                             ("v_pages", v_pages, (k_pages.dtype,))):
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: {label} must be {' or '.join(map(str, dtypes))} for "
                            f"the CUDA kernel, got {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be 16-byte aligned")
    for label, t in (("block_tables", block_tables), ("positions", positions)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {label} must be int32, got {t.dtype}")
    if quantized:
        for label, t in (("k_scales", k_scales), ("v_scales", v_scales)):
            if t.dtype != torch.float32 or tuple(t.shape) != tuple(k_pages.shape[:2]):
                raise ValueError(f"{name}: {label} must be float32 {tuple(k_pages.shape[:2])}, "
                                 f"got {t.dtype} {tuple(t.shape)}")
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


def gather_pages(pages, index):
    """``pages[:, index]``, for e4m3 pages through their bit patterns
    (PyTorch indexes few float8 ops, on the CPU above all)."""
    if pages.dtype == torch.float8_e4m3fn:
        return pages.view(torch.uint8)[:, index].view(pages.dtype)
    return pages[:, index]


def _page_values(pages, scales, block_tables):
    """``[Hkv, S, n, page, D]`` f32 rows of each slot's pages; quantized
    pages widen to ``f32(code) * (amax / QMAX)`` (JAX ``_dequant_tile``)."""
    bt = block_tables.long()
    vals = gather_pages(pages, bt).float()
    if scales is not None:
        vals = vals * (scales / _kv_qmax_for(pages))[:, bt][..., None, None]
    return vals


def paged_multitoken_attention_plain(q, k_pages, v_pages, block_tables, positions,
                                     *, k_scales=None, v_scales=None,
                                     sm_scale: Optional[float] = None):
    """Plain PyTorch version of the paged attention kernels, in f32.

    Gathers each slot's ``n * page_size`` kv rows through its block table
    (quantized pages dequantized as the kernels do, given ``k_scales`` /
    ``v_scales``) and applies the kernels' semantics at once: scores ``(q .
    k) * sm_scale`` in f32, row ``i`` of slot ``s`` sees kv index ``j`` iff
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
    k = _page_values(k_pages, k_scales, block_tables).reshape(hkv, s_slots, n * page_size, d)
    v = _page_values(v_pages, v_scales, block_tables).reshape(hkv, s_slots, n * page_size, d)
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
                                 *, k_scales=None, v_scales=None,
                                 sm_scale: Optional[float] = None):
    """Plain PyTorch version of :func:`paged_decode_attention`: the
    multi-token version at a window of one token."""
    return paged_multitoken_attention_plain(
        q[:, None], k_pages, v_pages, block_tables, positions[:, None],
        k_scales=k_scales, v_scales=v_scales, sm_scale=sm_scale,
    )[:, 0]


def _run(name, plain, q, k_pages, v_pages, block_tables, positions, sm_scale,
         k_scales=None, v_scales=None, *, decode: bool):
    """The paged wrappers' body: the plain version on a CPU tensor; on a
    CUDA tensor, checks the operands, launches
    ``paged_decode_attention_*`` (``decode``: kernel #4 / #5,
    ``csrc/paged_decode.cu``, on :func:`decode_split_plan`) or
    ``paged_multitoken_attention_*`` (#6 / #7, ``csrc/paged_prefill.cu``,
    on :func:`prefill_plan`), ``_bf16`` or ``_int8`` / ``_fp8`` for
    quantized pages, on the current stream into a fresh output and counts
    the launch on the wrapper ``name``; any other device raises."""
    s_slots, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    width = q.shape[1] if q.dim() == 4 else 1
    hkv, num_pages, page_size, n = _geometry(h, k_pages, block_tables, d)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    quantized = k_scales is not None
    if quantized != (v_scales is not None):
        raise ValueError(f"{name}: pass both k_scales and v_scales, or neither")
    if q.device.type == "cpu":
        return plain(q, k_pages, v_pages, block_tables, positions, k_scales=k_scales,
                     v_scales=v_scales, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    _check_kernel_operands(name, q, k_pages, v_pages, block_tables, positions,
                           k_scales, v_scales)
    if positions.shape != q.shape[:-2] or block_tables.shape[0] != s_slots:
        raise ValueError(f"{name}: positions {tuple(positions.shape)} / "
                         f"block_tables {tuple(block_tables.shape)} do not "
                         f"match q {tuple(q.shape)}")
    out = torch.empty_like(q)
    scale_ptrs = [k_scales.data_ptr(), v_scales.data_ptr()] if quantized else []
    suffix = _KV_SUFFIX[k_pages.dtype] if quantized else "bf16"
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if decode:
        plan = decode_split_plan(s_slots, h, hkv, d, page_size, n)
        lib, err_string = _decode_lib(), "paged_decode_error_string"
        work = counters = None
        if plan["chunks"] > 1:
            work = torch.empty(plan["workspace"], dtype=torch.float32, device=q.device)
            counters = _decode_counters(q.device, stream, plan["counters"])
        err = getattr(lib, f"paged_decode_attention_{suffix}")(
            q.device.index or 0, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            *scale_ptrs, block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            None if work is None else work.data_ptr(),
            None if counters is None else counters.data_ptr(),
            s_slots, h, hkv, d, num_pages, page_size, n, plan["span"], plan["rows"],
            float(sm_scale), stream,
        )
    else:
        prefill_plan(width, h, hkv, page_size, d, n, quantized=quantized)
        lib, err_string = _prefill_lib(), "paged_prefill_error_string"
        err = getattr(lib, f"paged_multitoken_attention_{suffix}")(
            q.device.index or 0, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            *scale_ptrs, block_tables.data_ptr(), positions.data_ptr(),
            out.data_ptr(), s_slots, width, h, hkv, d, num_pages, page_size, n,
            float(sm_scale), stream,
        )
    if err:
        raise RuntimeError(f"{name}: CUDA kernel launch failed: "
                           f"{getattr(lib, err_string)(err).decode()} ({err})")
    _WRAPPERS[name].launches += 1
    return out


def paged_decode_attention(q, k_pages, v_pages, block_tables, positions, *,
                           k_scales=None, v_scales=None,
                           sm_scale: Optional[float] = None):
    """Ragged single-token decode attention over a paged KV pool (JAX
    ``paged_decode_attention``).

    q: ``[S, H, D]``; k_pages/v_pages: ``[Hkv, P, page_size, D]``;
    block_tables: ``[S, n]`` int32; positions: ``[S]`` int32 — kv indices
    ``0..position`` are live.  GQA without repeating K/V.  Returns
    ``[S, H, D]`` in ``q.dtype``.  Quantized pages pass ``k_scales`` /
    ``v_scales`` ``[Hkv, P]`` f32 and go to
    :func:`paged_decode_attention_quant` (kernel #5).

    CUDA tensors launch ``paged_decode_attention_bf16``
    (``csrc/paged_decode.cu``: the page loop split over blocks on the plan
    of :func:`decode_split_plan`, merged in the same launch) on the current
    stream, with that stream's merge counters: a CUDA graph capture needs
    one call on its capture stream beforehand, and the graph's launches
    keep that stream's counters, so replay it in order with the stream's
    own launches.  CPU tensors run :func:`paged_decode_attention_plain`."""
    if k_scales is not None or v_scales is not None:
        return paged_decode_attention_quant(q, k_pages, v_pages, block_tables, positions,
                                            k_scales=k_scales, v_scales=v_scales,
                                            sm_scale=sm_scale)
    return _run("paged_decode_attention", paged_decode_attention_plain, q, k_pages, v_pages,
                block_tables, positions, sm_scale, decode=True)


paged_decode_attention.launches = 0


def paged_decode_attention_quant(q, k_pages, v_pages, block_tables, positions, *,
                                 k_scales, v_scales, sm_scale: Optional[float] = None):
    """Kernel #5 (JAX ``_paged_decode_kernel_quant``): decode over int8 /
    e4m3 pages with their per-(kv head, page) amaxes.  CUDA tensors launch
    ``paged_decode_attention_{int8,fp8}`` (``csrc/paged_decode.cu``); CPU
    tensors run :func:`paged_decode_attention_plain` with the scales."""
    return _run("paged_decode_attention_quant", paged_decode_attention_plain, q, k_pages,
                v_pages, block_tables, positions, sm_scale, k_scales, v_scales, decode=True)


paged_decode_attention_quant.launches = 0


def paged_multitoken_attention(q, k_pages, v_pages, block_tables, positions, *,
                               k_scales=None, v_scales=None,
                               sm_scale: Optional[float] = None):
    """Multi-token paged attention (JAX ``paged_multitoken_attention``): a
    ``T``-token query window per slot against that slot's paged K/V — the
    chunked-prefill shape ``[1, C]``.

    q: ``[S, T, H, D]``; positions: ``[S, T]`` int32, **contiguous per
    row** (``positions[s, i] == positions[s, 0] + i``; only column 0 is
    read).  Row ``i`` causal-masks at ``positions[s, 0] + i``.  Returns
    ``[S, T, H, D]``.  Quantized pages pass ``k_scales`` / ``v_scales``
    and go to :func:`paged_multitoken_attention_quant` (kernel #7).

    CUDA tensors launch kernel #6, the tensor-core kernel
    ``paged_multitoken_attention_bf16`` (``csrc/paged_prefill.cu``), on the
    plan of :func:`prefill_plan`, which refuses what it does not take; CPU
    tensors run :func:`paged_multitoken_attention_plain`."""
    if k_scales is not None or v_scales is not None:
        return paged_multitoken_attention_quant(q, k_pages, v_pages, block_tables, positions,
                                                k_scales=k_scales, v_scales=v_scales,
                                                sm_scale=sm_scale)
    return _run("paged_multitoken_attention", paged_multitoken_attention_plain, q, k_pages,
                v_pages, block_tables, positions, sm_scale, decode=False)


paged_multitoken_attention.launches = 0


def paged_multitoken_attention_quant(q, k_pages, v_pages, block_tables, positions, *,
                                     k_scales, v_scales, sm_scale: Optional[float] = None):
    """Kernel #7 (JAX ``_paged_multitoken_kernel_quant``): the multi-token
    window over int8 / e4m3 pages.  CUDA tensors launch the tensor-core
    kernel ``paged_multitoken_attention_{int8,fp8}``
    (``csrc/paged_prefill.cu``) on the plan of :func:`prefill_plan`,
    which refuses what it does not take; CPU tensors run
    :func:`paged_multitoken_attention_plain` with the scales."""
    return _run("paged_multitoken_attention_quant", paged_multitoken_attention_plain, q,
                k_pages, v_pages, block_tables, positions, sm_scale, k_scales, v_scales,
                decode=False)


paged_multitoken_attention_quant.launches = 0


# ---------------------------------------------------------------------------
# Fused LoRA query + paged decode (kernels #8, #9)
# ---------------------------------------------------------------------------

FUSED_MAX_RANK = 64


def _fused_geometry(x, q_base, a_stack, b_stack, k_pages):
    """JAX's argument checks (:1051, :1056-1059)."""
    s_slots, h, d = q_base.shape
    hkv = k_pages.shape[0]
    if h % hkv != 0:
        raise ValueError(f"num q heads {h} not divisible by kv heads {hkv}")
    num_adapters, _, rank = a_stack.shape
    if tuple(b_stack.shape) != (num_adapters, rank, h * d):
        raise ValueError(
            f"b_stack shape {tuple(b_stack.shape)} != {(num_adapters, rank, h * d)}"
        )
    return s_slots, h, d, hkv, num_adapters, rank


def fused_query_plain(x, q_base, a_stack, b_stack, adapter_ids, cos, sin, positions):
    """The f32 query of kernels #8 / #9: the delta ``(x . A[id]) . B[id]``
    in f32, roped split-half in f32 at ``clamp(pos, 0, max_len - 1)``, then
    ``f32(q_base) + gate * delta`` (``gate = (id != 0)``).  ``[S, H, D]``
    f32."""
    s_slots, h, d = q_base.shape
    ids = adapter_ids.long()
    hl = torch.bmm(x.float()[:, None], a_stack[ids].float())           # [S, 1, r]
    delta = torch.bmm(hl, b_stack[ids].float())[:, 0].reshape(s_slots, h, d)
    p = positions.long().clamp(0, cos.shape[0] - 1)
    c, sn = cos.float()[p][:, None], sin.float()[p][:, None]             # [S, 1, D/2]
    d1, d2 = delta.chunk(2, dim=-1)
    roped = torch.cat([d1 * c - d2 * sn, d2 * c + d1 * sn], dim=-1)
    gate = (ids != 0).float()[:, None, None]
    return q_base.float() + gate * roped


def fused_bgmv_paged_decode_plain(x, q_base, a_stack, b_stack, adapter_ids, cos, sin,
                                  k_pages, v_pages, block_tables, positions, *,
                                  k_scales=None, v_scales=None,
                                  sm_scale: Optional[float] = None):
    """Plain PyTorch version of kernels #8 / #9 with their roundings:
    :func:`fused_query_plain`'s f32 query, then
    :func:`paged_decode_attention_plain` on it, which never rounds it.
    Returns ``q_base.dtype``."""
    _fused_geometry(x, q_base, a_stack, b_stack, k_pages)
    q = fused_query_plain(x, q_base, a_stack, b_stack, adapter_ids, cos, sin, positions)
    return paged_decode_attention_plain(q, k_pages, v_pages, block_tables, positions,
                                        k_scales=k_scales, v_scales=v_scales,
                                        sm_scale=sm_scale).to(q_base.dtype)


def _run_fused(name, x, q_base, a_stack, b_stack, adapter_ids, cos, sin, k_pages, v_pages,
               block_tables, positions, k_scales, v_scales, sm_scale):
    """The fused wrappers' body: the plain version on a CPU tensor; on a
    CUDA tensor, checks the operands, launches
    ``fused_bgmv_paged_decode_{bf16,int8,fp8}`` (``csrc/paged_decode.cu``,
    on :func:`fused_decode_plan`) on the current stream with that stream's
    merge counters and counts the launch on the wrapper ``name``."""
    s_slots, h, d, hkv, num_adapters, rank = _fused_geometry(x, q_base, a_stack, b_stack,
                                                             k_pages)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if (k_scales is None) != (v_scales is None):
        raise ValueError(f"{name}: pass both k_scales and v_scales, or neither")
    if q_base.device.type == "cpu":
        return fused_bgmv_paged_decode_plain(
            x, q_base, a_stack, b_stack, adapter_ids, cos, sin, k_pages, v_pages,
            block_tables, positions, k_scales=k_scales, v_scales=v_scales, sm_scale=sm_scale)
    if q_base.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q_base.device}")
    _check_kernel_operands(name, q_base, k_pages, v_pages, block_tables, positions,
                           k_scales, v_scales)
    dev = q_base.device
    for label, t, dtype in (("x", x, torch.bfloat16), ("a_stack", a_stack, torch.bfloat16),
                            ("b_stack", b_stack, torch.bfloat16),
                            ("adapter_ids", adapter_ids, torch.int32),
                            ("cos", cos, torch.float32), ("sin", sin, torch.float32)):
        if t.device != dev or not t.is_contiguous() or t.dtype != dtype:
            raise ValueError(f"{name}: {label} must be a contiguous {dtype} tensor on {dev}, "
                             f"got {t.dtype} on {t.device}")
        if label not in ("x", "adapter_ids") and t.data_ptr() % 16:   # 16-byte loads
            raise ValueError(f"{name}: {label} must be 16-byte aligned")
    d_in = x.shape[1]
    max_len = cos.shape[0]
    if (tuple(x.shape) != (s_slots, d_in) or a_stack.shape[1] != d_in
            or tuple(adapter_ids.shape) != (s_slots,) or tuple(positions.shape) != (s_slots,)
            or block_tables.shape[0] != s_slots
            or tuple(cos.shape) != (max_len, d // 2) or tuple(sin.shape) != (max_len, d // 2)):
        raise ValueError(f"{name}: operand shapes do not fit q_base {tuple(q_base.shape)}")
    if rank > FUSED_MAX_RANK:
        raise ValueError(f"{name}: the CUDA kernel takes rank <= {FUSED_MAX_RANK}, got {rank}")
    _, num_pages, page_size, n = _geometry(h, k_pages, block_tables, d)
    plan = fused_decode_plan(s_slots, h, hkv, d, page_size, n)
    out = torch.empty_like(q_base)
    quantized = k_scales is not None
    suffix = _KV_SUFFIX[k_pages.dtype] if quantized else "bf16"
    stream = torch.cuda.current_stream(dev).cuda_stream
    work = counters = None
    if plan["chunks"] > 1:
        work = torch.empty(plan["workspace"], dtype=torch.float32, device=dev)
        counters = _decode_counters(dev, stream, plan["counters"], name)
    lib = _decode_lib()
    err = getattr(lib, f"fused_bgmv_paged_decode_{suffix}")(
        dev.index or 0, q_base.data_ptr(), x.data_ptr(), a_stack.data_ptr(),
        b_stack.data_ptr(), adapter_ids.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if quantized else None, v_scales.data_ptr() if quantized else None,
        block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
        None if work is None else work.data_ptr(),
        None if counters is None else counters.data_ptr(),
        s_slots, h, hkv, d, num_pages, page_size, n, plan["span"], plan["rows"],
        plan["cluster"], d_in, rank, num_adapters, max_len, float(sm_scale), stream,
    )
    if err:
        msg = lib.paged_decode_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA kernel launch failed: {msg} ({err})")
    _WRAPPERS[name].launches += 1
    return out


def fused_bgmv_paged_decode(x, q_base, a_stack, b_stack, adapter_ids, cos, sin, k_pages,
                            v_pages, block_tables, positions, *, k_scales=None, v_scales=None,
                            sm_scale: Optional[float] = None):
    """Fused per-tenant LoRA query projection + paged decode attention (JAX
    ``fused_bgmv_paged_decode``): kernel #8.

    x: ``[S, d_in]`` attention input (post-norm hidden states); q_base:
    ``[S, H, D]`` base queries, already roped; a_stack ``[N, d_in, r]``;
    b_stack ``[N, r, H*D]`` (the AdapterStore pool layout, row 0 the id-0
    base slot); adapter_ids ``[S]`` int32; cos/sin ``[max_len, D/2]`` f32
    rope tables (dead slots' positions clamp to the table); the rest as in
    :func:`paged_decode_attention`.  Quantized pages pass ``k_scales`` /
    ``v_scales`` and go to :func:`fused_bgmv_paged_decode_quant` (#9).
    Returns ``[S, H, D]`` in ``q_base.dtype``.

    CUDA tensors launch ``fused_bgmv_paged_decode_bf16``
    (``csrc/paged_decode.cu``: #4's split page loop on
    :func:`fused_decode_plan`, the LoRA prologue shared in a thread-block
    cluster, the f32 query as two bf16 halves on the tensor cores; bf16
    operands, r <= 64), with the current stream's merge counters as
    :func:`paged_decode_attention` takes them (a CUDA graph capture needs
    one call on its capture stream beforehand); CPU tensors run
    :func:`fused_bgmv_paged_decode_plain`."""
    if k_scales is not None or v_scales is not None:
        return fused_bgmv_paged_decode_quant(
            x, q_base, a_stack, b_stack, adapter_ids, cos, sin, k_pages, v_pages,
            block_tables, positions, k_scales=k_scales, v_scales=v_scales, sm_scale=sm_scale)
    return _run_fused("fused_bgmv_paged_decode", x, q_base, a_stack, b_stack, adapter_ids,
                      cos, sin, k_pages, v_pages, block_tables, positions, None, None, sm_scale)


fused_bgmv_paged_decode.launches = 0


def fused_bgmv_paged_decode_quant(x, q_base, a_stack, b_stack, adapter_ids, cos, sin,
                                  k_pages, v_pages, block_tables, positions, *, k_scales,
                                  v_scales, sm_scale: Optional[float] = None):
    """Kernel #9 (JAX ``_fused_bgmv_decode_kernel_quant``): the fused op over
    int8 / e4m3 pages with their per-(kv head, page) amaxes.  CUDA tensors
    launch ``fused_bgmv_paged_decode_{int8,fp8}``; CPU tensors run
    :func:`fused_bgmv_paged_decode_plain` with the scales."""
    return _run_fused("fused_bgmv_paged_decode_quant", x, q_base, a_stack, b_stack,
                      adapter_ids, cos, sin, k_pages, v_pages, block_tables, positions,
                      k_scales, v_scales, sm_scale)


fused_bgmv_paged_decode_quant.launches = 0


# ---------------------------------------------------------------------------
# Flash attention (kernels #1-#3)
# ---------------------------------------------------------------------------

# device, q, k, v, seg_q, seg_kv, pos_q, pos_kv (NULL when absent), then the
# kernel's own tensors, then B T S H Hkv D causal, sm_scale and the stream
_FLASH_HEAD = [_I] + [_P] * 7
_FLASH_TAIL = [_I] * 7 + [ctypes.c_float, _P]
_FLASH_SIGNATURES = {
    **{f"flash_attention_{kind}_{suffix}": (_FLASH_HEAD + [_P] * n + _FLASH_TAIL, _I)
       for suffix in ("bf16", "f16")
       for kind, n in (("fwd", 2),     # out, lse
                       ("dq", 4),      # g, lse, delta, dq
                       ("dkv", 5))},   # g, lse, delta, dk, dv
    "flash_attention_error_string": ([_I], ctypes.c_char_p),
}
# the kernels' element types and their instances' suffixes
_FLASH_DTYPES = {torch.bfloat16: "bf16", torch.float16: "f16"}


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


def _check_flash_operands(name, tensors: dict, ints: dict, f32s: dict) -> str:
    """The flash kernels take bf16 or f16 q/k/v/g (all of q's dtype),
    int32 segment ids and positions, f32 lse/delta; all contiguous on one
    CUDA device, 16-byte aligned, at a head dim they were built for.
    Returns the instance's suffix (``"bf16"`` / ``"f16"``)."""
    dev = tensors["q"].device
    suffix = _FLASH_DTYPES.get(tensors["q"].dtype)
    if suffix is None:
        raise TypeError(f"{name}: q must be torch.bfloat16 or torch.float16 for the CUDA "
                        f"kernel, got {tensors['q'].dtype}")
    for group, dtype in ((tensors, tensors["q"].dtype), (ints, torch.int32),
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
    return suffix


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch_flash(name, cname, q, k, v, seg_q, seg_kv, pos_q, pos_kv, own: list,
                  causal, sm_scale):
    """Launch the C function ``cname`` on the current stream with ``own``
    (the kernel's own operands and outputs, in the C order) and count the
    launch on the wrapper ``name``."""
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
        raise RuntimeError(f"{name}: CUDA kernel launch failed: {msg} ({err})")
    _WRAPPERS[name].launches += 1


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
    f32)``.  CUDA tensors launch ``flash_attention_fwd_bf16`` or, for f16
    operands, ``flash_attention_fwd_f16`` (``csrc/flash_attention.cu``:
    ``wgmma`` products on tiles that TMA brings in from a producer
    warpgroup); CPU tensors run :func:`flash_fwd_plain`."""
    if not _flash_route("flash_fwd", q):
        return flash_fwd_plain(q, k, v, seg_q, seg_kv, pos_q, pos_kv,
                               causal=causal, sm_scale=sm_scale)
    suffix = _check_flash_operands("flash_fwd", {"q": q, "k": k, "v": v},
                                   {"seg_q": seg_q, "seg_kv": seg_kv, "pos_q": pos_q,
                                    "pos_kv": pos_kv}, {})
    b, t, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
    _launch_flash("flash_fwd", f"flash_attention_fwd_{suffix}", q, k, v, seg_q, seg_kv, pos_q,
                  pos_kv, [out, lse], causal, sm_scale)
    return out, lse


flash_fwd.launches = 0


def flash_dq(q, k, v, g, lse, delta, seg_q=None, seg_kv=None, pos_q=None, pos_kv=None,
             *, causal: bool = True, sm_scale: float):
    """Kernel #2 (JAX ``_dq_kernel``): dq ``[B, T, H, D]``.  CUDA tensors
    launch ``flash_attention_dq_bf16`` (``_f16`` for f16 operands); CPU
    tensors run :func:`flash_dq_plain`."""
    if not _flash_route("flash_dq", q):
        return flash_dq_plain(q, k, v, g, lse, delta, seg_q, seg_kv, pos_q, pos_kv,
                              causal=causal, sm_scale=sm_scale)
    suffix = _check_flash_operands("flash_dq", {"q": q, "k": k, "v": v, "g": g},
                                   {"seg_q": seg_q, "seg_kv": seg_kv, "pos_q": pos_q,
                                    "pos_kv": pos_kv}, {"lse": lse, "delta": delta})
    dq = torch.empty_like(q)
    _launch_flash("flash_dq", f"flash_attention_dq_{suffix}", q, k, v, seg_q, seg_kv, pos_q,
                  pos_kv, [g, lse, delta, dq], causal, sm_scale)
    return dq


flash_dq.launches = 0


def flash_dkv(q, k, v, g, lse, delta, seg_q=None, seg_kv=None, pos_q=None, pos_kv=None,
              *, causal: bool = True, sm_scale: float):
    """Kernel #3 (JAX ``_dkv_kernel``): ``(dk, dv)`` ``[B, S, Hkv, D]``,
    each GQA group's q heads summed in the kernel, deterministic.  CUDA
    tensors launch ``flash_attention_dkv_bf16`` (``_f16`` for f16
    operands); CPU tensors run :func:`flash_dkv_plain`."""
    if not _flash_route("flash_dkv", q):
        return flash_dkv_plain(q, k, v, g, lse, delta, seg_q, seg_kv, pos_q, pos_kv,
                               causal=causal, sm_scale=sm_scale)
    suffix = _check_flash_operands("flash_dkv", {"q": q, "k": k, "v": v, "g": g},
                                   {"seg_q": seg_q, "seg_kv": seg_kv, "pos_q": pos_q,
                                    "pos_kv": pos_kv}, {"lse": lse, "delta": delta})
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_flash("flash_dkv", f"flash_attention_dkv_{suffix}", q, k, v, seg_q, seg_kv, pos_q,
                  pos_kv, [g, lse, delta, dk, dv], causal, sm_scale)
    return dk, dv


flash_dkv.launches = 0

# the wrappers' counters, bound here so that a stand-in routed in under a
# wrapper's module name neither takes nor hides a launch
_WRAPPERS = {fn.__name__: fn for fn in (
    paged_decode_attention, paged_multitoken_attention, paged_decode_attention_quant,
    paged_multitoken_attention_quant, fused_bgmv_paged_decode, fused_bgmv_paged_decode_quant,
    flash_fwd, flash_dq, flash_dkv)}


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

    CUDA tensors run kernels #1-#3 (bf16 or f16, head dims 64/96/128,
    else raises); CPU tensors their plain versions."""
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
    for wrapper in _WRAPPERS.values():
        wrapper.launches = 0
