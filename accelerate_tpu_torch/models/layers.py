"""Shared model layers (mirrors ``accelerate_tpu/models/layers.py``).

:class:`QuantizableDense` is the JAX package's ``nn.Dense`` stand-in.  Full
precision: the weight is stored ``[out, in]`` in the compute dtype and the
product runs in that dtype with f32 accumulation (cuBLAS for bf16); the JAX
module keeps an f32 parameter and casts it to bf16 on every call, which
gives the same numbers.

Quantized (JAX :68-73): after :meth:`QuantizableDense.set_quantized` (what
``utils.quantization.quantize_model_`` and ``models.convert.load_converted_state``
call) the layer holds the codes and scales of a
:class:`~accelerate_tpu_torch.utils.quantization.QuantizedTensor` as buffers
in place of its weight, in the JAX kernel orientation ``[in, out]``, and
runs ``quantized_matmul(x.to(dtype), qt, out_dtype=dtype)``: the W8A16
kernels #11 / #12 on the card for int8, the dequantize fallback for nf4.

LoRA (JAX :118-127): given per-row ``adapter_ids`` and the adapter pool
``lora`` (``{module name: {"a", "b"}}``, what
:class:`~accelerate_tpu_torch.serving.adapters.AdapterStore` holds), a layer
whose ``lora_key`` names a pool entry adds
:func:`~accelerate_tpu_torch.ops.lora.lora_apply` after its base product,
on the bf16 and the int8 route alike.  ``lora_key`` is the layer's module
name, set by the model that owns it.

fp8 (JAX :78-95): inside ``ops.precision.fp8_autocast`` (the train step
under ``mixed_precision="fp8"``) a full-precision layer multiplies in fp8:
with the delayed-scaling meta its module name keys
(``ops.fp8.merge_fp8_collection``), :func:`~..ops.fp8.fp8_delayed_dot`
(e4m3 forward, e5m2 backward); without, the stateless
:func:`~..ops.precision.fp8_current_scaled_dot`.

Tensor parallelism (JAX :63-64, :84-113): ``tp_mode`` (``None`` |
``"column"`` | ``"row"``) is the layer's Megatron role, set by the owning
model.  Given a :class:`DenseRoute` (the axis JAX passes as ``tp_axis``,
chosen per call: ``sp`` at the Ulysses boundary, else ``tp``) the layer
multiplies by its shard of the weight: the stored tensor when
the plan sharded it over the axis (``[out/p, in]`` for a column dense,
``[out, in/p]`` for a row dense), else this rank's slice of the whole one
(the Ulysses boundary rings over ``sp``, whose ranks hold whole weights).
Mode ``off``: a column dense's output is feature-sharded, a row dense's
partial sums meet in a ``psum`` over the axis.  Modes ``ring`` /
``bidir``: the activations between denses are sequence-sharded over the
axis, a column dense runs the ring all-gather -> matmul and a row dense
the ring matmul -> reduce-scatter (``ops/collective_matmul.py``).  In
fp8 (:func:`tp_linear`): the rank's slices through the fp8 product at the
global scales with the ring off, operands fake-quantized through e4m3 into
the ring with it on (JAX :80-91).

Quantized and LoRA denses on a route (mode ``off``; a forward that holds
either runs its denses so): the codes and scales stay whole on every rank,
as JAX's plan leaves them (its tp rules end in ``kernel$``, a quantized
leaf's paths in ``kernel/0`` / ``kernel/1``).  A column dense runs the
whole product (#11 / #12, the one-process call) and keeps the rank's
columns; a row dense multiplies the rank's input features by the rank's
rows of the codes and the matching columns of the k2d scales (a row range
of ``[H, F]`` and a column range of ``[F / block, H]``: the quantization
blocks run along F, so the slice is exact) and its partial sum rides the
``psum``.  Where that slice would leave a kernel route the whole call takes
(an ``H / p`` below one 128-row tile) or the codes are not k2d, the row
dense gathers its input over the axis and runs the whole call instead, no
``psum``: no route falls back to a dequantize the one-process call would
not take.  The adapter pool is whole on every rank (JAX's ``lora``
collection is outside the plan): a column dense adds the delta through
the rank's columns of ``b``, a row dense through the rank's rows of ``a``,
its partial delta added before the ``psum``; id-0 rows stay the rank's
base output bitwise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fp8 import fp8_delayed_dot, fp8_fake_quantize, fp8_meta
from ..ops.lora import lora_apply
from ..ops.precision import fp8_current_scaled_dot, fp8_enabled
from ..ops.quantized_matmul import _route, quantized_matmul
from ..utils.quantization import QuantizedTensor


@dataclass(frozen=True)
class DenseRoute:
    """How a tensor-parallel forward runs its denses: over ``axis`` of
    ``mesh``, in collective-matmul ``mode`` (``off``: activations
    replicated over the axis; ``ring`` / ``bidir``: sequence-sharded)."""

    mesh: object
    axis: str
    mode: str


def tp_linear(x, weight, kind: str, route: DenseRoute, in_features: int, out_features: int,
              out_dtype: Optional[torch.dtype] = None, fp8: bool = False, meta=None,
              reduce: bool = True):
    """This rank's product of a ``kind`` ("column" / "row") dense whose
    whole weight is ``[out_features, in_features]`` under ``route``;
    ``weight`` is the rank's shard or the whole tensor (sliced here).
    ``fp8`` (inside ``fp8_autocast``; ``meta`` the layer's delayed-scaling
    meta, or None for current scaling): with the ring off, the fp8 product
    of the rank's slices at the global tensors' scales; with the ring on,
    both operands rounded through e4m3 at their global amax
    (``fp8_fake_quantize``) and handed to the ring, as JAX's dense does
    (JAX :80-91).  ``reduce=False`` (mode ``off``) leaves a row dense's
    partial sum for the caller's ``psum``."""
    from ..ops.collective_matmul import dense_collective_matmul, linear, make_collective_dense
    from ..parallel import collectives as C

    p = C.axis_size(route.axis, route.mesh)
    i = C.axis_index(route.axis, route.mesh)
    if kind == "column" and weight.shape[0] == out_features:
        n = out_features // p
        weight = weight[i * n:(i + 1) * n]
    elif kind == "row" and weight.shape[1] == in_features:
        k = in_features // p
        weight = weight[:, i * k:(i + 1) * k]
    if fp8 and route.mode != "off":
        x, weight = fp8_fake_quantize(x), fp8_fake_quantize(weight)
    if route.mode == "off":
        y = _fp8_linear(x, weight, meta, out_dtype) if fp8 else linear(x, weight, out_dtype)
        return C.psum(y, route.axis, route.mesh) if kind == "row" and reduce else y
    y = dense_collective_matmul(x, weight, kind, axis_name=route.axis, out_dtype=out_dtype)
    if y is None:
        # the model lays activations out for the ring only where they fit
        # it; the monolithic body keeps that layout
        y = make_collective_dense(route.mesh, route.axis, kind, "monolithic",
                                  out_dtype)(x, weight)
    return y


def _fp8_linear(x, weight, meta, out_dtype):
    """``x @ weight.T`` in fp8: delayed scaling with ``meta``, current
    scaling without."""
    pet = out_dtype or x.dtype
    if meta is not None:
        return fp8_delayed_dot(x, weight.t(), meta, preferred_element_type=pet)
    return fp8_current_scaled_dot(x, weight.t(), preferred_element_type=pet)


class QuantizableDense(nn.Module):
    """Bias-free linear layer, ``y = x @ W.T``, in the compute dtype, or
    through the quantized matmul once :meth:`set_quantized` ran."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.in_features = in_features
        self.out_features = out_features
        self.lora_key: Optional[str] = None   # the module name, set by the owning model
        self.weight: Optional[nn.Parameter] = nn.Parameter(
            torch.empty(out_features, in_features, dtype=dtype))
        self._qmeta: Optional[tuple] = None   # (shape, dtype, scheme, block_size, layout)
        self.tp_mode: Optional[str] = None    # None | "column" | "row", set by the owning model
        # a row dense's rank rows of its codes by (ranks, rank): (codes, slice)
        self._rank_rows: dict = {}

    def set_quantized(self, qt: QuantizedTensor) -> None:
        """Hold ``qt`` (``[in, out]``) in place of the weight, which is
        freed.  Its codes and scales become the buffers ``qcodes`` /
        ``qscales`` on their own device."""
        want = (self.weight.shape[1], self.weight.shape[0]) if self.weight is not None \
            else self.quantized.shape
        if tuple(qt.shape) != tuple(want):
            raise ValueError(f"quantized weight of shape {qt.shape}, the layer takes {want}")
        self.weight = None
        self.register_buffer("qcodes", qt.data)
        self.register_buffer("qscales", qt.scale)
        self._qmeta = (tuple(qt.shape), qt.dtype, qt.scheme, qt.block_size, qt.layout)

    @property
    def quantized(self) -> Optional[QuantizedTensor]:
        """The layer's :class:`QuantizedTensor` over its current buffers,
        or None at full precision."""
        if self._qmeta is None:
            return None
        return QuantizedTensor(self.qcodes, self.qscales, *self._qmeta)

    def forward(self, x: torch.Tensor, adapter_ids=None, lora: Optional[dict] = None,
                route: Optional[DenseRoute] = None) -> torch.Tensor:
        qt = self.quantized
        entry = lora.get(self.lora_key) if (adapter_ids is not None and lora) else None
        if route is not None and self.tp_mode is not None:
            if qt is None and entry is None:
                fp8 = fp8_enabled()
                return tp_linear(x.to(self.weight.dtype), self.weight, self.tp_mode, route,
                                 self.in_features, self.out_features, fp8=fp8,
                                 meta=fp8_meta(self.lora_key) if fp8 else None)
            return self._tp_forward(x, qt, entry, adapter_ids, route)
        if qt is not None:
            y = quantized_matmul(x.to(self.dtype), qt, out_dtype=self.dtype)
        elif fp8_enabled():
            x_c, w_c = x.to(self.weight.dtype), self.weight.t()
            meta = fp8_meta(self.lora_key)
            if meta is not None:
                y = fp8_delayed_dot(x_c, w_c, meta, preferred_element_type=x_c.dtype)
            else:
                y = fp8_current_scaled_dot(x_c, w_c, preferred_element_type=x_c.dtype)
        else:
            y = F.linear(x.to(self.weight.dtype), self.weight)
        if entry is not None:
            y = lora_apply(x.to(self.dtype), y, entry["a"], entry["b"], adapter_ids)
        return y

    def _tp_forward(self, x, qt, entry, adapter_ids, route: DenseRoute):
        """This rank's output of a quantized or LoRA dense on ``route``
        (the module doc): the column dense's rank columns, the row dense's
        sum over the axis."""
        from ..parallel import collectives as C

        if route.mode != "off":
            raise NotImplementedError(
                "a quantized or LoRA dense inside a collective-matmul ring is not ported "
                "(the forward runs such denses with the ring off; ROADMAP item A13h.7)")
        p = C.axis_size(route.axis, route.mesh)
        i = C.axis_index(route.axis, route.mesh)
        column = self.tp_mode == "column"
        n, k = self.out_features // p, self.in_features // p
        whole_input = False
        if qt is None:
            fp8 = fp8_enabled()
            y = tp_linear(x.to(self.weight.dtype), self.weight, self.tp_mode, route,
                          self.in_features, self.out_features, fp8=fp8,
                          meta=fp8_meta(self.lora_key) if fp8 else None, reduce=False)
        elif column:
            y = quantized_matmul(x.to(self.dtype), qt, out_dtype=self.dtype)
            y = y[..., i * n:(i + 1) * n].contiguous()
        else:
            m = x.numel() // x.shape[-1]
            local = self._rows_of_rank(qt, p, i)
            if local is None or (_route(m, local, None) == "fallback"
                                 and _route(m, qt, None) != "fallback"):
                # the slice would leave the whole call's kernel route: every
                # rank runs the whole call on the gathered input
                x = C.all_gather(x.contiguous(), route.axis, axis=x.dim() - 1, mesh=route.mesh)
                whole_input = True
                local = qt
            y = quantized_matmul(x.to(self.dtype), local, out_dtype=self.dtype)
        if entry is not None:
            a, b = entry["a"], entry["b"]
            if column:
                b = b[..., i * n:(i + 1) * n].contiguous()
            elif not whole_input:
                a = a[:, i * k:(i + 1) * k].contiguous()
            y = lora_apply(x.to(self.dtype), y, a, b, adapter_ids)
        if not column and not whole_input:
            y = C.psum(y, route.axis, route.mesh)
        return y

    def _rows_of_rank(self, qt: QuantizedTensor, ways: int, index: int):
        """:func:`row_slice` of the layer's codes, made once a rank."""
        hit = self._rank_rows.get((ways, index))
        if hit is None or hit[0] is not self.qcodes:
            hit = self._rank_rows[ways, index] = (self.qcodes, row_slice(qt, ways, index))
        return hit[1]


def row_slice(qt: QuantizedTensor, ways: int, index: int) -> Optional[QuantizedTensor]:
    """Rank ``index``'s rows of an ``[H, F]`` k2d :class:`QuantizedTensor`
    over ``ways`` ranks (a row range of the codes, the matching column range
    of the ``[F / block, H]`` scales), or None where the codes are not k2d
    or ``ways`` does not divide H."""
    h, f = qt.shape
    if qt.layout != "k2d" or h % ways:
        return None
    rows = h // ways
    return QuantizedTensor(qt.data[index * rows:(index + 1) * rows],
                           qt.scale[:, index * rows:(index + 1) * rows].contiguous(),
                           (rows, f), qt.dtype, qt.scheme, qt.block_size, qt.layout)
