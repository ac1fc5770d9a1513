"""Weight-only int8 matmul (W8A16): the kernel wrappers and their plain
PyTorch versions (mirrors ``accelerate_tpu/ops/quantized_matmul.py``).

:func:`quantized_matmul` (JAX :173) computes ``x @ W`` for a
:class:`~accelerate_tpu_torch.utils.quantization.QuantizedTensor` ``W``
``[H, F]`` with JAX's dispatch, so both packages pick the same formula for
the same call:

- the dequantize + matmul fallback for nf4 codes, a quantization block
  that does not divide F or is not a multiple of 128, and an H with no
  lane-aligned K tile (``_k_tile`` :44);
- kernel #12, :func:`quantized_matmul_wholef` (JAX ``_qmm_wholef_kernel``
  :101), when ``wholef`` is set or, unset, at ``m <= 8`` rows, and
  ``_wholef_tiles`` (:158) finds a K tile;
- kernel #11, :func:`quantized_matmul_tiled` (JAX ``_qmm_kernel`` :59),
  otherwise (``wholef=False`` pins it).

The CUDA kernels use their own tiles (``csrc/quantized_matmul.cu``), so
JAX's tile knobs ``block_m`` / ``block_k`` / ``block_f`` are not taken; the
route is the one JAX takes at its default tiles.  #11's tile plan
(:func:`tiled_plan`) is the port's own: 16- or 64-row tiles at decode
width (m <= 64), 128-row tiles above, and a split of H over blocks that the
kernel adds back itself, in one launch; so is #12's (:func:`wholef_plan`:
128-column tiles by up to 8 slices of H, one cluster a tile, one launch).
The two kernels round differently, and each plain version follows its own
kernel:

- #11: ``w = bf16(f32(code) * scale)``, then ``bf16(x) @ w`` in f32;
- #12: per quantization block ``b`` of F, ``bf16(f32(x) * s[b, :]) @
  bf16(codes[:, b])`` in f32 (the scale folded into x).

The kernels read rows of x and of the scales as 16-byte vectors, so
:func:`quantized_matmul` pads an H that is no multiple of 8 with zero rows
of codes, scales and x, which add exact zeros to every sum.

On a CUDA tensor a wrapper launches its kernel (built at first use) or
raises; on a CPU tensor it runs its plain version.  Each wrapper counts its
launches in ``launches``, on itself whatever the module's names hold, so a
caller may route a stand-in in their place.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.quantization import QuantizedTensor, dequantize
from . import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
# device, x, codes, scales, out, [partial, counters (both NULL unless
# split),] then M H F qblock [block_m] splits out_is_f32, and the stream
_SIGNATURES = {
    "qmm_tiled": ([_I] + [_P] * 6 + [_I] * 7 + [_P], _I),
    "qmm_wholef": ([_I] + [_P] * 4 + [_I] * 6 + [_P], _I),
    "qmm_error_string": ([_I], ctypes.c_char_p),
}
_NUM_SMS = 132          # H100 SXM
_TILED_BN, _TILED_BK = 128, 64
_DECODE_MAX_M = 64      # #11's decode-width plan up to here, the prefill plan above
_MAX_SPLITS = 8         # #11's slices of H, all read at once by the kernel's sum
_WHOLEF_BF, _WHOLEF_BK, _WHOLEF_MAX_M = 128, 64, 8
_WHOLEF_MIN_PER = 2     # #12's shortest slice in K tiles: partials a small share of the codes
_WHOLEF_MAX_PER = 64    # #12's longest slice: the staged x * s fits shared memory
_WHOLEF_MAX_SPLITS = 8  # #12's slices: the blocks of one (portable) thread-block cluster


def _lib() -> ctypes.CDLL:
    return _build.load("quantized_matmul", _SIGNATURES)


# -- JAX's dispatch ------------------------------------------------------------


def _k_tile(h: int, block_k: int):
    """Largest multiple-of-128 divisor of ``h`` that fits in ``block_k``,
    or None (JAX ``_k_tile``)."""
    for bk in range(min(block_k, h) // 128 * 128, 0, -128):
        if h % bk == 0:
            return bk
    return None


_WHOLEF_TILE_BYTES = 4 * 1024 * 1024


def _wholef_tiles(h: int, f: int):
    """(bk, masked_k) of the whole-F kernel, or None when no lane-aligned K
    tile fits JAX's VMEM budget at this F (JAX ``_wholef_tiles``)."""
    budget = min(1024, _WHOLEF_TILE_BYTES // f, h) // 128 * 128
    if budget < 128:
        return None
    bk = _k_tile(h, budget)
    masked_k = False
    if bk is None or (bk < 384 and budget > bk):
        bk, masked_k = budget, True
    return bk, masked_k


def _route(m: int, qt: QuantizedTensor, wholef) -> str:
    """``"fallback"``, ``"wholef"`` (#12) or ``"tiled"`` (#11): the
    formula JAX's ``quantized_matmul`` picks for this call at its default
    tiles."""
    h, f = qt.shape[-2], qt.shape[-1]
    if wholef is None:
        wholef = m <= 8
    block_k = 1024 if m <= 8 else 512
    bk = _k_tile(h, block_k)
    aligned_bk = min(block_k // 128 * 128, h // 128 * 128)
    if aligned_bk > 0 and (bk is None or (bk < 384 and aligned_bk > bk)):
        bk = aligned_bk
    if (qt.scheme != "int8" or len(qt.shape) != 2 or f % qt.block_size != 0
            or qt.block_size % 128 != 0 or bk is None):
        return "fallback"
    if wholef and _wholef_tiles(h, f) is not None:
        return "wholef"
    return "tiled"


def _operands(qt: QuantizedTensor):
    """Codes ``[H, F]`` and scales ``[F / block, H]`` (the k2d layout; a
    flat int8 layout reshapes to it, JAX :249-251)."""
    h, f = qt.shape
    if qt.layout == "k2d":
        return qt.data, qt.scale
    return qt.data.reshape(h, f), qt.scale.reshape(h, f // qt.block_size).t()


# -- plain versions --------------------------------------------------------------


def quantized_matmul_plain(x, codes, scales, *, qblock: int, out_dtype=None):
    """Plain version of kernel #11: ``w = bf16(f32(code) * s[f / qblock,
    h])``, then ``bf16(x) @ w`` accumulated in f32.  x ``[m, H]``, codes
    ``[H, F]`` int8, scales ``[F / qblock, H]`` f32.  Returns ``[m, F]`` in
    ``out_dtype`` (default x's)."""
    h, f = codes.shape
    w = (codes.float().reshape(h, f // qblock, qblock) * scales.t()[:, :, None])
    w = w.reshape(h, f).to(torch.bfloat16).float()
    out = x.to(torch.bfloat16).float() @ w
    return out.to(out_dtype or x.dtype)


def quantized_matmul_wholef_plain(x, codes, scales, *, qblock: int, out_dtype=None):
    """Plain version of kernel #12: per quantization block ``b`` of F,
    ``bf16(f32(x) * s[b, :]) @ bf16(codes[:, b])`` accumulated in f32.
    Same operands and result as :func:`quantized_matmul_plain`."""
    h, f = codes.shape
    nb = f // qblock
    xs = (x.to(torch.bfloat16).float()[:, None, :] * scales[None]).to(torch.bfloat16).float()
    out = torch.einsum("mbh,hbq->mbq", xs, codes.float().reshape(h, nb, qblock))
    return out.reshape(x.shape[0], f).to(out_dtype or x.dtype)


# -- kernel wrappers --------------------------------------------------------------


def _check_operands(name, x, codes, scales, qblock, out_dtype):
    """The kernels take bf16 x ``[m, H]``, int8 codes ``[H, F]`` and f32
    scales ``[F / qblock, H]``, contiguous on one CUDA device and 16-byte
    aligned, H a multiple of 8, F a multiple of the 128-aligned ``qblock``,
    and write bf16 or f32."""
    dev = x.device
    for label, t, dtype in (("x", x, torch.bfloat16), ("codes", codes, torch.int8),
                            ("scales", scales, torch.float32)):
        if t.device != dev:
            raise ValueError(f"{name}: {label} is on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {label} must be {dtype}, got {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be 16-byte aligned")
    m, h = x.shape
    hc, f = codes.shape
    if hc != h or tuple(scales.shape) != (f // qblock, h):
        raise ValueError(f"{name}: x {tuple(x.shape)}, codes {tuple(codes.shape)} and "
                         f"scales {tuple(scales.shape)} do not match (qblock {qblock})")
    if h % 8 or qblock % 128 or f % qblock:
        raise ValueError(f"{name}: the CUDA kernel needs H % 8 == 0 and F a multiple "
                         f"of a 128-aligned quantization block (H {h}, F {f}, block {qblock})")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: the CUDA kernel writes bfloat16 or float32, not {out_dtype}")


@dataclass(frozen=True)
class TiledPlan:
    """Kernel #11's launch plan for an ``[m, H] @ [H, F]`` call.

    Tiles are ``block_m`` rows by 128 output columns: ``block_m`` 16 (m <=
    16) or 64 (m <= 64) at decode width, where the call is bound by the
    code bytes, and 128 above, where it is bound by the tensor cores.  H
    is cut into ``splits`` slices of ``k_tiles_per_split`` 64-row K tiles
    (the last may be shorter); with ``splits > 1`` the kernel adds the
    slices itself, counting arrivals on ``tiles`` int32 counters."""

    block_m: int
    splits: int
    k_tiles_per_split: int
    tiles: int


def tiled_plan(m: int, h: int, f: int) -> TiledPlan:
    """#11's tile plan.  H is split while the output tiles leave SMs idle
    (two blocks of each tile fit on the SMs), into at most 8 slices (the kernel's sum reads all of a position's
    slices at once), each at least two K tiles at decode width and four at
    prefill width.  The slice count is then the one the C entry point
    recomputes from it (``ceil(k_tiles / ceil(k_tiles / splits))``)."""
    decode = m <= _DECODE_MAX_M
    block_m = 16 if m <= 16 else 64 if decode else 128
    tiles = (f // _TILED_BN) * -(-m // block_m)
    k_tiles = -(-h // _TILED_BK)
    min_per = 2 if decode else 4
    splits = max(1, min(_MAX_SPLITS, -(-k_tiles // min_per), _NUM_SMS // tiles))
    per = -(-k_tiles // splits)
    return TiledPlan(block_m=block_m, splits=-(-k_tiles // per), k_tiles_per_split=per,
                     tiles=tiles)


@dataclass(frozen=True)
class WholefPlan:
    """Kernel #12's launch plan for an ``[m, H] @ [H, F]`` call, ``m <= 8``.

    Blocks are 128 output columns (``tiles`` of them) by a slice of
    ``k_tiles_per_split`` 64-row K tiles of H (the last may be shorter);
    with ``splits > 1`` the blocks of a column tile form a thread-block
    cluster and add their slices through distributed shared memory, in
    the same launch."""

    splits: int
    k_tiles_per_split: int
    tiles: int


def wholef_plan(m: int, h: int, f: int) -> WholefPlan:
    """#12's plan: about one and a half waves of blocks on the SMs (H split
    while the column tiles leave SMs idle; a block's chain of tiles is
    latency-bound, so a second block on an SM hides it: on the card the
    600m denses ran fastest so), at most 8 slices (a cluster), each at
    least two K tiles and at most 64 (the slice's staged ``bf16(x * s)`` in
    shared memory, so H <= 32768).  The slice count is then the one the C
    entry point recomputes from it (``ceil(k_tiles / ceil(k_tiles /
    splits))``); ``m`` does not change the plan.  Raises ValueError for an
    H above 32768."""
    del m
    tiles = f // _WHOLEF_BF
    k_tiles = -(-h // _WHOLEF_BK)
    if k_tiles > _WHOLEF_MAX_SPLITS * _WHOLEF_MAX_PER:
        raise ValueError(f"quantized_matmul_wholef: the CUDA kernel takes H <= "
                         f"{_WHOLEF_MAX_SPLITS * _WHOLEF_MAX_PER * _WHOLEF_BK}, got {h}")
    splits = max(1, min(3 * _NUM_SMS // (2 * tiles), -(-k_tiles // _WHOLEF_MIN_PER),
                        _WHOLEF_MAX_SPLITS), -(-k_tiles // _WHOLEF_MAX_PER))
    per = -(-k_tiles // splits)
    return WholefPlan(splits=-(-k_tiles // per), k_tiles_per_split=per, tiles=tiles)


def _raise_on(name, err):
    if err:
        msg = _lib().qmm_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA kernel launch failed: {msg} ({err})")


# The arrival counters of #11's split calls: one zeroed int32 buffer per
# (device, stream, size), allocated at the first split call on that stream
# and left at zero by every launch, so no launch pays a memset.  Launches
# on one stream run in order and may share a buffer; launches on two
# streams never do.
_COUNTERS: dict = {}


def _counters(device, stream: int, size: int):
    key = (device.index or 0, stream, size)
    buf = _COUNTERS.get(key)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "quantized_matmul_tiled: the split's counters of this stream and size must be "
                "allocated before a CUDA graph capture: run the call once on the capture "
                "stream outside the capture")
        buf = _COUNTERS[key] = torch.zeros(size, dtype=torch.int32, device=device)
    return buf


def _device_route(name, x) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return True


def quantized_matmul_tiled(x, codes, scales, *, qblock: int, out_dtype=None):
    """Kernel #11 (JAX ``_qmm_kernel``): ``[m, F]``.  CUDA tensors launch
    ``qmm_tiled`` (``csrc/quantized_matmul.cu``) once, on the plan of
    :func:`tiled_plan`; CPU tensors run :func:`quantized_matmul_plain`.
    A split call's counters are its stream's (``_counters``): a CUDA graph
    capture needs one eager call of the same plan on its stream first."""
    out_dtype = out_dtype or x.dtype
    if not _device_route("quantized_matmul_tiled", x):
        return quantized_matmul_plain(x, codes, scales, qblock=qblock, out_dtype=out_dtype)
    _check_operands("quantized_matmul_tiled", x, codes, scales, qblock, out_dtype)
    m, h = x.shape
    f = codes.shape[1]
    plan = tiled_plan(m, h, f)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    out = torch.empty(m, f, dtype=out_dtype, device=x.device)
    partial = counters = None
    if plan.splits > 1:
        partial = torch.empty(plan.splits, m, f, dtype=torch.float32, device=x.device)
        counters = _counters(x.device, stream, plan.tiles)
    _raise_on("quantized_matmul_tiled", _lib().qmm_tiled(
        x.device.index or 0, x.data_ptr(), codes.data_ptr(), scales.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(),
        None if counters is None else counters.data_ptr(),
        m, h, f, qblock, plan.block_m, plan.splits, int(out_dtype == torch.float32), stream,
    ))
    _WRAPPERS["quantized_matmul_tiled"].launches += 1
    return out


quantized_matmul_tiled.launches = 0


def quantized_matmul_wholef(x, codes, scales, *, qblock: int, out_dtype=None):
    """Kernel #12 (JAX ``_qmm_wholef_kernel``), ``m <= 8``: ``[m, F]``.
    CUDA tensors launch ``qmm_wholef`` once, on the plan of
    :func:`wholef_plan` (no scratch: a split adds its slices inside a
    cluster); CPU tensors run :func:`quantized_matmul_wholef_plain`."""
    out_dtype = out_dtype or x.dtype
    if not _device_route("quantized_matmul_wholef", x):
        return quantized_matmul_wholef_plain(x, codes, scales, qblock=qblock,
                                             out_dtype=out_dtype)
    _check_operands("quantized_matmul_wholef", x, codes, scales, qblock, out_dtype)
    m, h = x.shape
    if m > _WHOLEF_MAX_M:
        raise ValueError(f"quantized_matmul_wholef: the CUDA kernel takes at most "
                         f"{_WHOLEF_MAX_M} rows, got {m}")
    f = codes.shape[1]
    plan = wholef_plan(m, h, f)
    out = torch.empty(m, f, dtype=out_dtype, device=x.device)
    _raise_on("quantized_matmul_wholef", _lib().qmm_wholef(
        x.device.index or 0, x.data_ptr(), codes.data_ptr(), scales.data_ptr(), out.data_ptr(),
        m, h, f, qblock, plan.splits, int(out_dtype == torch.float32),
        torch.cuda.current_stream(x.device).cuda_stream,
    ))
    _WRAPPERS["quantized_matmul_wholef"].launches += 1
    return out


quantized_matmul_wholef.launches = 0

# the wrappers' counters, bound here so that a stand-in routed in under a
# wrapper's module name neither takes nor hides a launch
_WRAPPERS = {fn.__name__: fn for fn in (quantized_matmul_tiled, quantized_matmul_wholef)}


def quantized_matmul(x, qt: QuantizedTensor, *, out_dtype=None, wholef: Optional[bool] = None):
    """``x @ W`` for an int8 :class:`QuantizedTensor` ``W`` ``[H, F]``
    (JAX ``quantized_matmul``).  x: ``[..., H]``; returns ``[..., F]`` in
    ``out_dtype`` (default x's).  The route (module docstring) is JAX's:
    the fallback ``dequantize`` to bf16 + matmul, #12 or #11; ``wholef``
    None picks by m, True forces #12 where it has a K tile, False #11."""
    h, f = qt.shape[-2], qt.shape[-1]
    lead = x.shape[:-1]
    m = int(np.prod(lead)) if lead else 1
    route = _route(m, qt, wholef)
    out_dtype = out_dtype or x.dtype
    if route == "fallback":
        w = dequantize(qt, torch.bfloat16)
        if x.dtype == torch.bfloat16:
            y = torch.matmul(x, w)
        else:   # JAX promotes the bf16 weight to x's wider type
            y = torch.matmul(x, w.to(torch.promote_types(x.dtype, torch.bfloat16)))
        return y.to(out_dtype)
    codes, scales = _operands(qt)
    x2 = x.reshape(m, h).to(torch.bfloat16)
    if h % 8:   # zero rows to a multiple of 8 (module docstring)
        pad = -h % 8
        x2, codes = F.pad(x2, (0, pad)), F.pad(codes, (0, 0, 0, pad))
        scales = F.pad(scales, (0, pad))
    x2, codes, scales = x2.contiguous(), codes.contiguous(), scales.contiguous()
    fn = quantized_matmul_wholef if route == "wholef" else quantized_matmul_tiled
    out = fn(x2, codes, scales, qblock=qt.block_size, out_dtype=out_dtype)
    return out.reshape(*lead, f)


def reset_launch_counts() -> None:
    """Zero both kernel wrappers' launch counters."""
    for wrapper in _WRAPPERS.values():
        wrapper.launches = 0
