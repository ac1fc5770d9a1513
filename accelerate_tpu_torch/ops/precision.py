"""Mixed-precision policies, dynamic loss scaling and fp8 matmuls (mirrors
``accelerate_tpu/ops/precision.py``: ``Policy`` :41, ``fp8_hardware_supported``
:62, ``get_policy`` :89, ``DynamicLossScale`` :111, ``all_finite`` :161,
``Fp8Meta`` :178, ``quantize_fp8`` :204, ``fp8_dot`` :245,
``fp8_current_scaled_dot`` :265, ``fp8_autocast`` :289, ``fp8_enabled``
:298, ``layerwise_casting`` :308).

A :class:`Policy` is the param / compute / output dtype triple the train
step applies at its boundary (``"no"``, ``"bf16"``, ``"fp16"``, and
``"fp8"``, whose activations stay bf16).  :class:`DynamicLossScale` is the
GradScaler of fp16 training.  The fp8 matmuls quantize both operands to
e4m3 with per-tensor scales and multiply them in one fp8 product
(:func:`fp8_mm`): on the card ``torch._scaled_mm``, cuBLASLt's fp8 GEMM
(the JAX package computes this product as an XLA ``dot``, not in a Pallas
kernel); on the CPU the plain version, which widens the codes to f32 and
multiplies, as XLA's CPU dot does.  :func:`layerwise_casting` stores
weights in a narrow dtype and computes in a wide one.
"""

from __future__ import annotations

import contextlib
import re
import threading
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class Policy:
    """Param / compute / output dtypes (the autocast analog)."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, params: dict) -> dict:
        return {k: v.to(self.compute_dtype) if v.is_floating_point() else v
                for k, v in params.items()}

    @property
    def needs_loss_scaling(self) -> bool:
        return self.compute_dtype == torch.float16


def fp8_hardware_supported() -> bool:
    """Whether the card has fp8 tensor cores (JAX :62): compute capability
    8.9 (Ada) or later, as ``torch.cuda.get_device_capability`` reports it;
    False without a CUDA device."""
    if not torch.cuda.is_available():
        return False
    return _capability_has_fp8(torch.cuda.get_device_capability())


def _capability_has_fp8(capability) -> bool:
    return tuple(capability) >= (8, 9)


def get_policy(mixed_precision: str) -> Policy:
    """``"no"`` -> all f32; ``"bf16"`` and ``"fp8"`` (whose activations
    ride bf16; the fp8 applies per matmul) -> f32 params, bf16 compute,
    f32 outputs; ``"fp16"`` -> f32 params, f16 compute, f32 outputs, with
    loss scaling (JAX :89)."""
    mp = str(mixed_precision)
    if mp == "no":
        return Policy()
    if mp in ("bf16", "fp8"):
        return Policy(param_dtype=torch.float32, compute_dtype=torch.bfloat16,
                      output_dtype=torch.float32)
    if mp == "fp16":
        return Policy(param_dtype=torch.float32, compute_dtype=torch.float16,
                      output_dtype=torch.float32)
    raise ValueError(f"unsupported mixed precision {mixed_precision!r}")


class DynamicLossScale:
    """The fp16 GradScaler (JAX :111, torch.cuda.amp semantics): the loss
    is multiplied by ``scale`` (f32 0-d tensor, initially 2^16); a step
    whose unscaled gradients are all finite counts toward
    ``growth_interval`` consecutive finite steps, after which the scale
    doubles (the counter restarting); a non-finite step halves the scale,
    resets the counter and skips the update.  ``update`` returns a new
    instance, as in JAX."""

    def __init__(self, scale=None, growth_factor: float = 2.0, backoff_factor: float = 0.5,
                 growth_interval: int = 2000, counter=None, device=None):
        self.scale = (torch.tensor(2.0 ** 16, dtype=torch.float32, device=device)
                      if scale is None else scale)
        self.growth_factor = growth_factor
        self.backoff_factor = backoff_factor
        self.growth_interval = growth_interval
        self.counter = (torch.zeros((), dtype=torch.int32, device=self.scale.device)
                        if counter is None else counter)

    def scale_loss(self, loss):
        return loss * self.scale

    def unscale(self, grads):
        """Each gradient times ``1 / scale`` (f32), in its own dtype."""
        inv = _over(1.0, self.scale)
        return [(g * inv).to(g.dtype) for g in grads]

    def update(self, grads_finite) -> "DynamicLossScale":
        finite = torch.as_tensor(grads_finite, device=self.scale.device)
        counter = torch.where(finite, self.counter + 1, 0).to(torch.int32)
        grow = counter >= self.growth_interval
        scale = torch.where(finite, torch.where(grow, self.scale * self.growth_factor,
                                                self.scale),
                            self.scale * self.backoff_factor)
        counter = torch.where(grow, 0, counter).to(torch.int32)
        return DynamicLossScale(scale, self.growth_factor, self.backoff_factor,
                                self.growth_interval, counter)

    def __repr__(self):
        return (f"DynamicLossScale(scale={float(self.scale)}, counter={int(self.counter)}, "
                f"growth_interval={self.growth_interval})")


def all_finite(tensors) -> torch.Tensor:
    """True (0-d bool tensor) iff every element of every tensor is finite."""
    tensors = list(tensors.values()) if isinstance(tensors, dict) else list(tensors)
    if not tensors:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(t).all() for t in tensors]).all()


# ---------------------------------------------------------------------------
# fp8 matmuls with per-tensor scaling
# ---------------------------------------------------------------------------

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


class Fp8Meta:
    """A tensor's amax history and the scale derived from it (JAX :178, TE
    ``DelayedScaling``): ``amax_history`` ``[history_len]`` f32, ``scale``
    f32 0-d."""

    def __init__(self, amax_history: torch.Tensor, scale: torch.Tensor):
        self.amax_history = amax_history
        self.scale = scale

    @classmethod
    def init(cls, history_len: int = 16, device=None) -> "Fp8Meta":
        return cls(torch.zeros(history_len, dtype=torch.float32, device=device),
                   torch.tensor(1.0, dtype=torch.float32, device=device))

    def updated(self, amax: torch.Tensor, fp8_max: float, margin: int = 0) -> "Fp8Meta":
        """The history rolled by one with ``amax`` in front, and the scale
        ``fp8_max / (max(history) * 2^margin)`` (1 while the history is
        all zero)."""
        hist = torch.roll(self.amax_history, 1)
        hist[0] = amax.to(torch.float32)
        amax_ref = hist.max()
        scale = torch.where(amax_ref > 0, _over(fp8_max, amax_ref * (2.0 ** margin)), 1.0)
        return Fp8Meta(hist, scale.to(torch.float32))

    def __repr__(self):
        return f"Fp8Meta(amax_history={self.amax_history.tolist()}, scale={float(self.scale)})"


def _over(c: float, t: torch.Tensor) -> torch.Tensor:
    """``c / t`` in ``t``'s dtype as one correctly rounded division (a
    Python number over a tensor is ``t.reciprocal() * c`` in torch, which
    rounds twice)."""
    return torch.full_like(t, c) / t


def _amax(x: torch.Tensor) -> torch.Tensor:
    """``max |x|`` in f32: one reduction over ``x`` in its own width (the
    largest magnitude is exact in any float type), no f32 copy."""
    return torch.linalg.vector_norm(x.detach(), float("inf")).float()


def saturate_cast(t: torch.Tensor, scale, fp8_max: float, dtype) -> torch.Tensor:
    """``clip(t * scale, -fp8_max, fp8_max)`` in f32, rounded to ``dtype``
    (JAX ``_saturate_cast``); the output keeps ``t``'s layout.  The scale
    as a 1-element f32 tensor makes the product f32 without an f32 copy of
    ``t`` (a 0-d one would leave a bf16 product)."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=t.device).reshape(1)
    return torch.mul(t, scale).clamp_(-fp8_max, fp8_max).to(dtype)


def quantize_fp8(x: torch.Tensor, meta: Fp8Meta, dtype=torch.float8_e4m3fn,
                 fp8_max: float = E4M3_MAX):
    """Scale and saturate-cast ``x`` to fp8 with the meta updated by its
    amax (JAX :204).  Returns ``(q, new_meta)``."""
    new_meta = meta.updated(_amax(x), fp8_max)
    return saturate_cast(x, new_meta.scale, fp8_max, dtype), new_meta


def _col_major(b: torch.Tensor) -> torch.Tensor:
    """``b`` with column-major strides (a copy unless it has them)."""
    if b.stride(0) == 1 and b.stride(1) == b.shape[0]:
        return b
    return b.t().contiguous().t()


def fp8_mm(a: torch.Tensor, b: torch.Tensor, descale: torch.Tensor, out_dtype) -> torch.Tensor:
    """``(a @ b) / descale`` for fp8 ``a [M, K]`` and ``b [K, N]`` (e4m3 or
    e5m2, not both e5m2), accumulated in f32 and rounded to ``out_dtype``.
    On a CUDA tensor: one ``torch._scaled_mm`` (cuBLASLt's fp8 GEMM; ``a``
    row-major and ``b`` column-major, copied into those layouts where they
    are not, the descale folded into its f32 scale), counted in
    ``fp8_mm.launches``.  On the CPU: the plain version, the codes widened
    to f32 (:func:`fp8_mm_plain`)."""
    if a.device.type == "cpu":
        return fp8_mm_plain(a, b, descale, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"fp8_mm: unsupported device {a.device}")
    inv = _over(1.0, descale.float()).reshape(()).to(a.device)
    one = torch.ones((), dtype=torch.float32, device=a.device)
    out = torch._scaled_mm(a.contiguous(), _col_major(b), scale_a=inv, scale_b=one,
                           out_dtype=out_dtype)
    fp8_mm.launches += 1
    return out[0] if isinstance(out, tuple) else out


fp8_mm.launches = 0


def fp8_mm_plain(a, b, descale, out_dtype) -> torch.Tensor:
    """Plain version of :func:`fp8_mm`: f32 codes, an f32 product, the
    f32 division by ``descale`` (JAX's ``dot_general`` with
    ``preferred_element_type=float32``, then ``/ (x_scale * w_scale)``)."""
    return ((a.float() @ b.float()) / descale.float()).to(out_dtype)


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1])


class _Fp8Matmul(torch.autograd.Function):
    """Scaled-e4m3 product with the bf16 straight-through backward (JAX
    ``_fp8_matmul``): ``x [..., K] @ w [K, N]`` quantized with the given
    scales; the gradients are plain products in ``preferred`` of the
    unquantized operands."""

    @staticmethod
    def forward(ctx, x, w, x_scale, w_scale, preferred):
        qx = saturate_cast(_flat(x), x_scale, E4M3_MAX, torch.float8_e4m3fn)
        qw = saturate_cast(w, w_scale, E4M3_MAX, torch.float8_e4m3fn)
        out = fp8_mm(qx, qw, x_scale * w_scale, preferred)
        ctx.save_for_backward(x, w)
        ctx.preferred = preferred
        return out.reshape(*x.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        pet = ctx.preferred
        g2 = _flat(g.to(pet))
        dx = (g2 @ w.to(pet).t()).to(x.dtype).reshape(x.shape)
        dw = (_flat(x).to(pet).t() @ g2).to(w.dtype)
        return dx, dw, None, None, None


def fp8_dot(x, w, x_meta: Fp8Meta, w_meta: Fp8Meta, preferred_element_type=torch.bfloat16):
    """fp8 product with TE-style delayed scaling (JAX :245): both metas
    updated by their operand's amax, both operands quantized to e4m3 with
    the updated scales.  ``w`` is ``[K, N]`` (a weight ``[N, K]``'s
    ``.t()``).  Returns ``(out, (new_x_meta, new_w_meta))``."""
    new_x = x_meta.updated(_amax(x), E4M3_MAX)
    new_w = w_meta.updated(_amax(w), E4M3_MAX)
    out = _Fp8Matmul.apply(x, w, new_x.scale, new_w.scale, preferred_element_type)
    return out, (new_x, new_w)


def fp8_current_scaled_dot(x, w, preferred_element_type=torch.bfloat16):
    """Stateless fp8 product with current-step scaling (JAX :265): each
    operand's scale is ``448 / max(|t|, 1e-12)`` (the global tensor's amax
    under :func:`fp8_amax_over`); the backward is the bf16
    straight-through one.  ``w`` is ``[K, N]``."""
    x_scale = _over(E4M3_MAX, torch.clamp_min(global_amax(x), 1e-12))
    w_scale = _over(E4M3_MAX, torch.clamp_min(global_amax(w), 1e-12))
    return _Fp8Matmul.apply(x, w, x_scale, w_scale, preferred_element_type)


# the fp8 region flag and the delayed-scaling metas the region delivers to
# the dense layers (JAX's "fp8" collection; ops/fp8.merge_fp8_collection)
_FP8_STATE = threading.local()


@contextlib.contextmanager
def fp8_autocast(enabled: bool = True):
    """Inside, ``QuantizableDense`` and ``LMHead`` compute their products
    in fp8 (JAX :289; the train step enters it under
    ``mixed_precision="fp8"``)."""
    prev = getattr(_FP8_STATE, "enabled", False)
    _FP8_STATE.enabled = enabled
    try:
        yield
    finally:
        _FP8_STATE.enabled = prev


def fp8_enabled() -> bool:
    return getattr(_FP8_STATE, "enabled", False)


@contextlib.contextmanager
def fp8_amax_over(mesh, axes):
    """Inside, every amax fp8 takes (an activation's, a gradient's, a
    weight's fake quantization) is the global tensor's: this rank's part's
    amax maxed over the mesh ``axes`` (the train step under a sharding plan:
    JAX takes every amax of a global array under GSPMD).  No axes, no
    change."""
    prev = getattr(_FP8_STATE, "amax_axes", None)
    _FP8_STATE.amax_axes = (mesh, tuple(axes)) if axes else None
    try:
        yield
    finally:
        _FP8_STATE.amax_axes = prev


def amax_axes():
    """``(mesh, axes)`` of the enclosing :func:`fp8_amax_over`, or None."""
    return getattr(_FP8_STATE, "amax_axes", None)


def global_amax(x: torch.Tensor) -> torch.Tensor:
    """The amax of the global tensor whose part this rank holds as ``x``
    (:func:`_amax` of ``x`` itself outside :func:`fp8_amax_over`)."""
    a = _amax(x)
    over = amax_axes()
    if over is None:
        return a
    from ..parallel import collectives

    return collectives.pmax(a, over[1], over[0])


def layerwise_casting(params, storage_dtype=torch.float8_e4m3fn, compute_dtype=torch.bfloat16,
                      skip_patterns: tuple = ("norm", "embed", "bias", "scale")):
    """Store matching floating weights in ``storage_dtype`` (fp8: half
    bf16's bytes) and compute in ``compute_dtype`` (JAX :308, reference
    big_modeling.py:654).  A weight matches when its lower-cased name
    matches none of ``skip_patterns``; the cast rounds to nearest even
    (fp8: the bits of JAX's ``astype(float8_e4m3fn)``).

    ``params`` a name -> tensor mapping: returns ``(cast mapping,
    apply_wrapper)``, where ``apply_wrapper(apply_fn)`` upcasts the stored
    tensors of the mapping it is called with.  ``params`` a module: its
    matching parameters are replaced by stored ones, each module owning
    one gets a :class:`~accelerate_tpu_torch.hooks.LayerwiseCastingHook`
    that upcasts them for its call; returns ``(module, apply_wrapper)``."""

    def matches(name: str, t) -> bool:
        return (isinstance(t, torch.Tensor) and t.is_floating_point()
                and not any(re.search(p, name.lower()) for p in skip_patterns))

    def apply_wrapper(apply_fn):
        def wrapped(p, *args, **kwargs):
            upcast = {k: v.to(compute_dtype) if isinstance(v, torch.Tensor)
                      and v.dtype == storage_dtype else v for k, v in p.items()}
            return apply_fn(upcast, *args, **kwargs)

        return wrapped

    if isinstance(params, torch.nn.Module):
        from ..big_modeling import _aliases, _get_tensor, _set_tensor
        from ..hooks import LayerwiseCastingHook, add_hook_to_module

        owners: dict[int, torch.nn.Module] = {}
        for name, holders in _aliases(params).items():
            t = _get_tensor(holders)
            if holders[0][2] and matches(name, t):
                _set_tensor(holders, torch.nn.Parameter(t.detach().to(storage_dtype),
                                                        requires_grad=False))
                owners.update((id(mod), mod) for mod, _, _ in holders)
        for mod in owners.values():
            add_hook_to_module(mod, LayerwiseCastingHook(storage_dtype, compute_dtype),
                               append=True)
        return params, apply_wrapper
    cast = {k: v.to(storage_dtype) if matches(k, v) else v for k, v in params.items()}
    return cast, apply_wrapper
