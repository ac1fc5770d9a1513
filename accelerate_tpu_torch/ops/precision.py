"""Mixed-precision policies (mirrors ``accelerate_tpu/ops/precision.py``:
``Policy`` :41, ``get_policy`` :89, ``all_finite`` :161,
``layerwise_casting`` :308).

A :class:`Policy` is the param / compute / output dtype triple the train
step applies at its boundary.  ``"no"`` and ``"bf16"`` are ported; fp16
loss scaling and fp8 matmuls are later slices.  :func:`layerwise_casting`
stores weights in a narrow dtype and computes in a wide one.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

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


def get_policy(mixed_precision: str) -> Policy:
    """``"no"`` -> all f32; ``"bf16"`` -> f32 params, bf16 compute, f32
    outputs.  ``"fp16"`` and ``"fp8"`` raise ``NotImplementedError``."""
    mp = str(mixed_precision)
    if mp == "no":
        return Policy()
    if mp == "bf16":
        return Policy(param_dtype=torch.float32, compute_dtype=torch.bfloat16,
                      output_dtype=torch.float32)
    if mp == "fp16":
        raise NotImplementedError(
            "mixed_precision='fp16' needs dynamic loss scaling (DynamicLossScale), "
            "ROADMAP item A12 (slice 5)"
        )
    if mp == "fp8":
        raise NotImplementedError(
            "mixed_precision='fp8' is ops/fp8.py's delayed-scaling matmul, ROADMAP item "
            "A12 (slice 5)"
        )
    raise ValueError(f"unsupported mixed precision {mixed_precision!r}")


def all_finite(tensors) -> torch.Tensor:
    """True (0-d bool tensor) iff every element of every tensor is finite."""
    tensors = list(tensors.values()) if isinstance(tensors, dict) else list(tensors)
    if not tensors:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(t).all() for t in tensors]).all()


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
