"""Segment-batched multi-adapter LoRA (mirrors ``accelerate_tpu/ops/lora.py``).

One base model serves many tenants' LoRA adapters.  Every resident
adapter's factors live **stacked** on the device (``a_stack [P+1, d_in,
r]``, ``b_stack [P+1, r, d_out]``, JAX's ``[in, out]`` orientation; slot 0
is the null adapter, all zeros), and each batch row carries a pool-slot id
(0 = the base model).  The adapter contribution is one gathered product
over the ids, ``y[b] += (x[b] @ a_stack[ids[b]]) @ b_stack[ids[b]]``, for
any tenant mix.

Two routes, two roundings (:func:`lora_apply`):

- **native**: gathers ``a_stack[ids]`` / ``b_stack[ids]`` cast to
  ``x.dtype`` and runs two batched products in that dtype (``torch.bmm``),
  so ``h`` is rounded to ``x.dtype`` — JAX's two einsums.  Bitwise equal to
  the per-row :func:`lora_apply_sequential`.
- **bgmv**: kernel #10 for T = 1 decode: ``h`` and the delta in f32,
  rounded once to ``x.dtype``.  :func:`lora_apply` calls
  :func:`bgmv_apply` (``csrc/lora.cu``: the delta and the select below in
  one launch); :func:`bgmv` is the delta alone (JAX's ``bgmv``).

Both return ``where(ids > 0, y + delta, y)``, so id-0 rows are bitwise the
base output, negative zeros included.  ``"auto"`` takes bgmv at T = 1 on
any device — the CUDA kernel on a CUDA tensor, its plain version
:func:`bgmv_apply_plain` (the kernel's rounding) on a CPU tensor — and
native otherwise (JAX's ``auto`` takes bgmv only on a TPU).

The device pool behind the stacks is
:class:`accelerate_tpu_torch.serving.adapters.AdapterStore`.  Pools and
adapters are flat dicts keyed by the port's module names
(``model.layers.0.self_attn.q_proj``): ``{name: {"a": ..., "b": ...}}``.
"""

from __future__ import annotations

import ctypes
import math
import threading
from contextlib import contextmanager
from typing import Optional

import torch

from . import _build

# ---------------------------------------------------------------------------
# Kernel-mode dispatch
# ---------------------------------------------------------------------------

LORA_KERNELS = ("auto", "native", "bgmv")

_mode_state = threading.local()


def normalize_lora_kernel(mode: Optional[str]) -> str:
    mode = (mode or "auto").lower()
    if mode not in LORA_KERNELS:
        raise ValueError(f"lora kernel must be one of {LORA_KERNELS}, got {mode!r}")
    return mode


def set_lora_kernel(mode: Optional[str]) -> None:
    """Install the ambient LoRA kernel mode of this thread (``None``
    restores ``auto``).  The serving engine scopes its
    :class:`~accelerate_tpu_torch.utils.dataclasses.LoraPlugin` mode around
    each step with :func:`lora_kernel`."""
    _mode_state.mode = normalize_lora_kernel(mode) if mode is not None else "auto"


def lora_kernel_mode() -> str:
    return getattr(_mode_state, "mode", "auto")


@contextmanager
def lora_kernel(mode: str):
    """Scoped ambient kernel override."""
    prev = lora_kernel_mode()
    set_lora_kernel(mode)
    try:
        yield
    finally:
        set_lora_kernel(prev)


def _resolve_kernel(mode: str, t: int) -> str:
    if mode == "auto":
        return "bgmv" if t == 1 else "native"
    return mode


# ---------------------------------------------------------------------------
# The segment-batched adapter matmul
# ---------------------------------------------------------------------------


def lora_apply(x, y, a_stack, b_stack, adapter_ids, *, kernel: Optional[str] = None):
    """Add each row's adapter contribution to the base output ``y`` (JAX
    ``lora_apply``).

    ``x``: ``[B, T, d_in]`` (or ``[B, d_in]``); ``y``: the base product with
    trailing dim ``d_out``; ``a_stack``/``b_stack``: ``[P+1, d_in, r]`` /
    ``[P+1, r, d_out]`` (slot 0 = the null adapter); ``adapter_ids``:
    ``[B]`` int pool-slot indices on ``x``'s device.  Id-0 rows come back
    bitwise unchanged (a ``where`` select, not ``y + 0``).  ``kernel``
    overrides the ambient mode (:func:`lora_kernel`); at T = 1 under bgmv
    the whole call is :func:`bgmv_apply`, looked up when called."""
    ids = torch.as_tensor(adapter_ids, device=x.device).to(torch.int32)
    squeeze = x.dim() == 2
    if squeeze:
        x = x[:, None, :]
        y = y[:, None, :]
    t = x.shape[1]
    mode = _resolve_kernel(normalize_lora_kernel(kernel) if kernel is not None
                           else lora_kernel_mode(), t)
    if mode == "bgmv" and t == 1:
        out = bgmv_apply(x[:, 0].contiguous(), y[:, 0].contiguous(), a_stack, b_stack,
                         ids)[:, None]
    else:
        idx = ids.long()
        a = a_stack[idx].to(x.dtype)                # [B, d_in, r]
        b = b_stack[idx].to(x.dtype)                # [B, r, d_out]
        delta = torch.bmm(torch.bmm(x, a), b)
        out = torch.where((ids > 0)[:, None, None], y + delta.to(y.dtype), y)
    return out[:, 0] if squeeze else out


def lora_apply_sequential(x, y, a_stack, b_stack, adapter_ids):
    """Per-request reference schedule (JAX ``lora_apply_sequential``): one
    adapter product per row, a Python loop over rows.  The batched native
    :func:`lora_apply` reproduces it bitwise."""
    ids = [int(i) for i in torch.as_tensor(adapter_ids).reshape(-1).tolist()]
    squeeze = x.dim() == 2
    if squeeze:
        x = x[:, None, :]
        y = y[:, None, :]
    rows = []
    for i, tid in enumerate(ids):
        if tid == 0:
            rows.append(y[i])
            continue
        a = a_stack[tid].to(x.dtype)
        b = b_stack[tid].to(x.dtype)
        delta = torch.bmm(torch.bmm(x[i][None], a[None]), b[None])
        rows.append(y[i] + delta[0].to(y.dtype))
    out = torch.stack(rows)
    return out[:, 0] if squeeze else out


# ---------------------------------------------------------------------------
# Kernel #10: batched gather-matmul for T = 1 decode
# ---------------------------------------------------------------------------

BGMV_MAX_RANK = 64

_P, _I = ctypes.c_void_p, ctypes.c_int
# device, x, [y,] a_stack, b_stack, ids, out, then S d_in r d_out N, the stream
_SIGNATURES = {
    "bgmv_bf16": ([_I] + [_P] * 5 + [_I] * 5 + [_P], _I),
    "bgmv_apply_bf16": ([_I] + [_P] * 6 + [_I] * 5 + [_P], _I),
    "lora_error_string": ([_I], ctypes.c_char_p),
}


def _lib() -> ctypes.CDLL:
    return _build.load("lora", _SIGNATURES)


def bgmv_plain(x, a_stack, b_stack, ids):
    """Plain PyTorch version of kernel #10's delta with its rounding: per
    row, ``h = x[s] . A[ids[s]]`` and ``delta = h . B[ids[s]]`` in f32
    (operands widened to f32), rounded once to ``x.dtype``; a row whose id
    is outside ``[1, N)`` gives zeros, as the kernel writes them."""
    ids = torch.as_tensor(ids, device=x.device)
    valid = (ids > 0) & (ids < a_stack.shape[0])
    idx = torch.where(valid, ids, torch.zeros_like(ids)).long()
    h = torch.bmm(x.float()[:, None], a_stack[idx].float())        # [S, 1, r]
    delta = torch.bmm(h, b_stack[idx].float())[:, 0]               # [S, d_out]
    return torch.where(valid[:, None], delta, torch.zeros_like(delta)).to(x.dtype)


def bgmv_apply_plain(x, y, a_stack, b_stack, ids):
    """Plain PyTorch version of :func:`bgmv_apply`: the composition
    ``where(ids > 0, y + bgmv_plain(x, ...).to(y.dtype), y)``, so id-0 rows
    are ``y`` bitwise and an id ``>= N`` adds a zero delta."""
    ids = torch.as_tensor(ids, device=x.device)
    delta = bgmv_plain(x, a_stack, b_stack, ids)
    return torch.where((ids > 0)[:, None], y + delta.to(y.dtype), y)


def _check_bgmv(name, x, a_stack, b_stack, ids, y=None):
    """Shapes on any device; on a CUDA device also what the kernel takes:
    bf16 operands, int32 ids, contiguous on x's device, ``r <= 64``.
    Returns the int32 ids on x's device."""
    s_slots, d_in = x.shape
    n_adapters, d_in_a, rank = a_stack.shape
    d_out = b_stack.shape[2]
    if d_in_a != d_in or tuple(b_stack.shape[:2]) != (n_adapters, rank):
        raise ValueError(f"{name}: x {tuple(x.shape)}, a_stack {tuple(a_stack.shape)} and "
                         f"b_stack {tuple(b_stack.shape)} do not fit together")
    if y is not None and tuple(y.shape) != (s_slots, d_out):
        raise ValueError(f"{name}: y of shape {tuple(y.shape)} for {s_slots} rows of "
                         f"{d_out} columns")
    ids = torch.as_tensor(ids, device=x.device).to(torch.int32)
    if tuple(ids.shape) != (s_slots,):
        raise ValueError(f"{name}: ids of shape {tuple(ids.shape)} for {s_slots} rows")
    if x.device.type == "cpu":
        return ids
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    tensors = (("x", x), ("a_stack", a_stack), ("b_stack", b_stack), ("ids", ids)) + (
        (("y", y),) if y is not None else ())
    for label, t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name}: {label} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        if label != "ids" and t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {label} must be torch.bfloat16 for the CUDA kernel, "
                            f"got {t.dtype}")
    if rank > BGMV_MAX_RANK:
        raise ValueError(f"{name}: the CUDA kernel takes rank <= {BGMV_MAX_RANK}, got {rank}")
    return ids


def _launch(name, cname, x, a_stack, b_stack, ids, y=None):
    s_slots, d_in = x.shape
    n_adapters, _, rank = a_stack.shape
    d_out = b_stack.shape[2]
    out = torch.empty(s_slots, d_out, dtype=x.dtype, device=x.device)
    err = getattr(_lib(), cname)(
        x.device.index or 0, x.data_ptr(), *([] if y is None else [y.data_ptr()]),
        a_stack.data_ptr(), b_stack.data_ptr(), ids.data_ptr(), out.data_ptr(), s_slots, d_in,
        rank, d_out, n_adapters, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        msg = _lib().lora_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA kernel launch failed: {msg} ({err})")
    _WRAPPERS[name].launches += 1
    return out


def bgmv(x, a_stack, b_stack, ids):
    """Kernel #10's delta (JAX ``bgmv`` / ``_bgmv_kernel``): the per-slot
    adapter delta ``(x[s] @ a_stack[ids[s]]) @ b_stack[ids[s]]``,
    f32-accumulated, in ``x.dtype``.

    ``x``: ``[S, d_in]``; stacks ``[N, d_in, r]`` / ``[N, r, d_out]``;
    ``ids``: ``[S]`` int32.  CUDA tensors launch ``bgmv_bf16``
    (``csrc/lora.cu``, bf16 operands, ``r <= 64``) on the current stream,
    reading only each row's own factors; an id outside ``[1, N)`` gives a
    zero row (the engine checks ids against the pool on the host).  CPU
    tensors run :func:`bgmv_plain`."""
    ids = _check_bgmv("bgmv", x, a_stack, b_stack, ids)
    if x.device.type == "cpu":
        return bgmv_plain(x, a_stack, b_stack, ids)
    return _launch("bgmv", "bgmv_bf16", x, a_stack, b_stack, ids)


bgmv.launches = 0


def bgmv_apply(x, y, a_stack, b_stack, ids):
    """Kernel #10 with :func:`lora_apply`'s select folded in:
    ``where(ids > 0, y + bgmv(x, ...), y)`` in one launch.  ``y``: the base
    output ``[S, d_out]``, a new tensor returned (id-0 rows bitwise ``y``).
    CUDA tensors launch ``bgmv_apply_bf16`` (``csrc/lora.cu``: one block
    per row and 256 output columns) on the current stream; CPU tensors run
    :func:`bgmv_apply_plain`."""
    ids = _check_bgmv("bgmv_apply", x, a_stack, b_stack, ids, y=y)
    if x.device.type == "cpu":
        return bgmv_apply_plain(x, y, a_stack, b_stack, ids)
    return _launch("bgmv_apply", "bgmv_apply_bf16", x, a_stack, b_stack, ids, y=y)


bgmv_apply.launches = 0

# the wrappers' counters, bound here so that a stand-in routed in under a
# wrapper's module name neither takes nor hides a launch
_WRAPPERS = {"bgmv": bgmv, "bgmv_apply": bgmv_apply}


def reset_launch_counts() -> None:
    """Zero kernel #10's launch counters (both entry points)."""
    for wrapper in _WRAPPERS.values():
        wrapper.launches = 0


# ---------------------------------------------------------------------------
# Adapter parameter plumbing (spec, pool, single-adapter init)
# ---------------------------------------------------------------------------

DEFAULT_LORA_TARGETS = ("q_proj", "v_proj")


def lora_spec(model, targets=DEFAULT_LORA_TARGETS) -> dict[str, tuple[int, int]]:
    """Every LoRA-targeted module of ``model`` -> its ``(d_in, d_out)``
    (JAX ``lora_spec``).  A module takes part when the last component of
    its name is in ``targets`` and it is one of the model's adapter-capable
    linears (``QuantizableDense``, ``LMHead``: they carry ``lora_key``).
    Keys are the port's module names, the keys of pools and adapters."""
    targets = tuple(targets)
    spec: dict[str, tuple[int, int]] = {}
    for name, mod in model.named_modules():
        if getattr(mod, "lora_key", None) is not None and name.rsplit(".", 1)[-1] in targets:
            spec[name] = (int(mod.in_features), int(mod.out_features))
    if not spec:
        raise ValueError(
            f"no LoRA target modules found for targets={targets} — module "
            "names must end in a target and name a linear layer of the model"
        )
    return spec


def init_lora_pool(spec: dict, pool_slots: int, rank: int, dtype=torch.bfloat16,
                   device=None) -> dict:
    """The device-resident adapter pool: per target, zeroed ``a``/``b``
    stacks with leading dim ``pool_slots + 1`` — slot 0 is the null
    adapter (all zeros, never written), so id 0 means the base model."""
    if pool_slots < 1:
        raise ValueError(f"pool_slots must be >= 1, got {pool_slots}")
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    return {
        path: {"a": torch.zeros(pool_slots + 1, d_in, rank, dtype=dtype, device=device),
               "b": torch.zeros(pool_slots + 1, rank, d_out, dtype=dtype, device=device)}
        for path, (d_in, d_out) in spec.items()
    }


def init_adapter_params(generator: torch.Generator, spec: dict, rank: int, *,
                        alpha: float = 16.0, dtype=torch.bfloat16,
                        init_b: str = "zeros") -> dict:
    """One tenant's adapter ``{path: {"a": [d_in, r], "b": [r, d_out]}}``
    on the CPU (JAX ``init_adapter_params``, drawn from a
    :class:`torch.Generator` in sorted path order, so the numbers are not
    JAX's).  ``a ~ N(0, 1/d_in)``; ``b`` zeros (a fresh adapter is an exact
    no-op) or, with ``init_b="normal"``, ``N(0, 1/r)``.  ``alpha / rank`` is
    folded into ``b`` once."""
    if init_b not in ("zeros", "normal"):
        raise ValueError(f"init_b must be 'zeros' or 'normal', got {init_b!r}")
    scaling = alpha / rank
    out = {}
    for path, (d_in, d_out) in sorted(spec.items()):
        a = torch.randn(d_in, rank, generator=generator) / math.sqrt(d_in)
        if init_b == "zeros":
            b = torch.zeros(rank, d_out)
        else:
            b = torch.randn(rank, d_out, generator=generator) / math.sqrt(rank)
        out[path] = {"a": a.to(dtype), "b": (b * scaling).to(dtype)}
    return out


def adapter_param_count(spec: dict, rank: int) -> int:
    """Trainable params per adapter: ``sum_t r * (d_in + d_out)``."""
    return sum(rank * (d_in + d_out) for d_in, d_out in spec.values())


def adapter_state_accounting(spec: dict, rank: int, n_adapters: int, *,
                             optimizer: str = "lion-sr8", dtype_bytes: int = 2) -> dict:
    """Predicted host-memory ladder for per-adapter optimizer state (JAX
    ``adapter_state_accounting``, the same fields and numbers)."""
    from .streaming import HOST_BYTES_PER_PARAM

    n_params = adapter_param_count(spec, rank)
    host_b_per_param = HOST_BYTES_PER_PARAM.get(optimizer, 16.0)
    per_adapter_state = int(n_params * host_b_per_param)
    per_adapter_weights = n_params * dtype_bytes
    gib = lambda b: round(b / 2**30, 6)
    return {
        "optimizer": optimizer,
        "rank": rank,
        "params_per_adapter": n_params,
        "weight_bytes_per_adapter": per_adapter_weights,
        "state_bytes_per_adapter": per_adapter_state,
        "n_adapters": n_adapters,
        "total_weight_gib": gib(per_adapter_weights * n_adapters),
        "total_state_gib": gib(per_adapter_state * n_adapters),
        "adapters_per_host": {
            "64GiB": int(64 * 2**30 // max(per_adapter_state + per_adapter_weights, 1)),
            "256GiB": int(256 * 2**30 // max(per_adapter_state + per_adapter_weights, 1)),
        },
        "kind": "predicted",
    }
