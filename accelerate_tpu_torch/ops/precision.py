"""Mixed-precision policies (mirrors ``accelerate_tpu/ops/precision.py``:
``Policy`` :41, ``get_policy`` :89, ``all_finite`` :161).

A :class:`Policy` is the param / compute / output dtype triple the train
step applies at its boundary.  ``"no"`` and ``"bf16"`` are ported; fp16
loss scaling and fp8 matmuls are later slices.
"""

from __future__ import annotations

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
