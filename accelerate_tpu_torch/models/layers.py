"""Shared model layers (mirrors ``accelerate_tpu/models/layers.py``).

:class:`QuantizableDense` is the JAX package's ``nn.Dense`` stand-in, here
on its full-precision path only: the weight is stored ``[out, in]`` in the
compute dtype and the product runs in that dtype with f32 accumulation
(cuBLAS for bf16).  The JAX module keeps an f32 parameter and casts it to
bf16 on every call, which gives the same numbers.  The int8/NF4 weight
path (``ops/quantized_matmul.py``, kernels #11/#12) and the LoRA, fp8 and
collective-matmul routes belong to later slices.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class QuantizableDense(nn.Module):
    """Bias-free linear layer, ``y = x @ W.T``, in the compute dtype."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.weight.dtype), self.weight)
