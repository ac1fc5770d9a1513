"""Weight-only quantization (mirrors ``accelerate_tpu/utils/quantization.py``).

Schemes, as in the JAX package:

- ``int8``: blockwise absmax, ``w ~ scale * q`` with ``q`` in ``[-127, 127]``;
- ``nf4``: 4-bit NormalFloat (the QLoRA codebook), blockwise absmax scaling
  to ``[-1, 1]``, nearest code, two codes packed per byte.

A :class:`QuantizedTensor` holds torch tensors in the JAX package's layouts,
so codes and scales are **bitwise** equal to JAX's for the same f32 weights:

- ``"k2d"`` (2-D int8 whose minor dim the block divides): ``data`` int8
  ``[H, F]`` and ``scale`` f32 ``[F / block, H]``: the operand layouts of
  the W8A16 kernels (``ops/quantized_matmul.py``);
- ``"flat"``: ``data`` ``[n_blocks, block]`` (int8, or uint8 packed nf4)
  and ``scale`` f32 ``[n_blocks, 1]`` over the row-major flattened array,
  zero-padded to whole blocks.

A quantized dense weight is held in the JAX kernel orientation ``[in,
out]`` = ``[H, F]``, the transpose of a torch ``Linear`` weight:
:func:`quantize_params` and :func:`quantize_model_` quantize ``weight.T``.

``quantize`` runs on the tensor's own device.
:func:`load_and_quantize_model` (JAX :331) streams a checkpoint into a
model and quantizes each weight it takes on the card as it arrives;
:func:`quantized_apply` (JAX :286) runs a quantized model, or a function
of a quantized name -> tensor mapping, on dense weights.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any, Callable, Optional

import numpy as np
import torch

# QLoRA NF4 codebook: the 16 quantiles of a standard normal, normalized to
# [-1, 1] (public constants from the QLoRA paper)
NF4_CODE = np.array(
    [
        -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
        -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
        0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
        0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
        0.7229568362236023, 1.0,
    ],
    np.float32,
)


@dataclasses.dataclass(frozen=True)
class QuantizationConfig:
    """The JAX package's ``QuantizationConfig``: the same fields, defaults,
    ``skip_patterns`` and ``should_quantize`` rule."""

    load_in_8bit: bool = False
    load_in_4bit: bool = False
    # the W8A16 kernels need block_size % 128 == 0; other sizes take the
    # dequantize fallback (ops/quantized_matmul.py)
    block_size: int = 128
    compute_dtype: Any = torch.bfloat16
    # leaves whose path matches any pattern stay unquantized
    skip_patterns: tuple = ("embed", "norm", "bias", "scale", "lm_head")
    # only quantize matrices at least this big
    min_size: int = 4096

    def __post_init__(self):
        if self.load_in_8bit and self.load_in_4bit:
            raise ValueError("pick one of load_in_8bit / load_in_4bit")
        if not (self.load_in_8bit or self.load_in_4bit):
            raise ValueError("one of load_in_8bit / load_in_4bit must be set")

    @property
    def scheme(self) -> str:
        return "int8" if self.load_in_8bit else "nf4"

    def should_quantize(self, path: str, arr) -> bool:
        """Floating-point leaves of at least two dims and ``min_size``
        elements whose lower-cased path matches no ``skip_patterns``."""
        ndim = getattr(arr, "ndim", 0)
        size = arr.numel() if isinstance(arr, torch.Tensor) else getattr(arr, "size", 0)
        if ndim < 2 or size < self.min_size:
            return False
        dtype = getattr(arr, "dtype", None)
        if isinstance(dtype, torch.dtype):
            if not dtype.is_floating_point:
                return False
        elif dtype is None or not np.issubdtype(np.dtype(dtype), np.floating):
            return False
        low = path.lower()
        return not any(re.search(p, low) for p in self.skip_patterns)


class QuantizedTensor:
    """Packed codes + blockwise scales (torch tensors) in the JAX layouts
    (module docstring).  ``shape`` / ``dtype`` are the dequantized
    array's."""

    def __init__(self, data, scale, shape, dtype, scheme: str, block_size: int,
                 layout: str = "flat"):
        self.data = data
        self.scale = scale
        self.shape = tuple(shape)
        self.dtype = dtype
        self.scheme = scheme
        self.block_size = block_size
        self.layout = layout

    @property
    def size(self):
        return int(np.prod(self.shape)) if self.shape else 1

    def __repr__(self):
        return f"QuantizedTensor({self.scheme}, shape={self.shape}, block={self.block_size})"


def is_quantized(x) -> bool:
    return isinstance(x, QuantizedTensor)


def _k2d_eligible(shape, block: int) -> bool:
    return len(shape) == 2 and shape[1] % block == 0


def _blocks(a: torch.Tensor, block: int, k2d: bool) -> torch.Tensor:
    """``a`` in f32 as ``[H, F / block, block]`` (k2d) or ``[n_blocks,
    block]`` over the flat array, zero-padded to whole blocks."""
    if k2d:
        h, f = a.shape
        return a.float().contiguous().reshape(h, f // block, block)
    flat = a.float().reshape(-1)
    pad = -flat.shape[0] % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, block)


def _int8_blockwise(a: torch.Tensor, block: int, k2d: bool):
    """JAX ``_int8_blockwise``: absmax per block (1 where it is 0), scale =
    absmax / 127 in f32, codes = clip(round(blocks / scale), -127, 127)
    (round half to even, as ``np.round``)."""
    blocks = _blocks(a, block, k2d)
    absmax = blocks.abs().amax(dim=-1, keepdim=True)
    absmax = torch.where(absmax == 0, 1.0, absmax)
    scale = absmax / 127.0
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    if k2d:
        h, f = a.shape
        return q.reshape(h, f), scale[..., 0].t().contiguous()   # [H, F], [F/block, H]
    return q, scale


def quantize(arr, config: QuantizationConfig) -> QuantizedTensor:
    """Quantize ``arr`` (a tensor, or anything ``torch.as_tensor`` takes)
    under ``config.scheme``, on its own device."""
    t = arr if isinstance(arr, torch.Tensor) else torch.as_tensor(np.asarray(arr))
    block = config.block_size
    if config.scheme == "int8":
        k2d = _k2d_eligible(t.shape, block)
        q, scale = _int8_blockwise(t, block, k2d)
        return QuantizedTensor(q, scale, t.shape, t.dtype, "int8", block,
                               layout="k2d" if k2d else "flat")
    blocks = _blocks(t, block, False)
    absmax = blocks.abs().amax(dim=1, keepdim=True)
    absmax = torch.where(absmax == 0, 1.0, absmax)
    norm = blocks / absmax
    code = torch.as_tensor(NF4_CODE, device=t.device)
    # nearest codebook entry, first index on ties (np.argmin's rule)
    codes = (norm[..., None] - code).abs().argmin(dim=-1).to(torch.uint8)
    packed = (codes[:, 1::2] << 4) | codes[:, 0::2]
    return QuantizedTensor(packed, absmax, t.shape, t.dtype, "nf4", block)


def dequantize(qt, dtype=None):
    """The dense tensor of ``qt`` in ``dtype`` (default: its own); any
    other value comes back as it is."""
    if not is_quantized(qt):
        return qt
    out_dtype = dtype or qt.dtype
    n = qt.size
    if qt.layout == "k2d":
        h, f = qt.shape
        blocks = qt.data.float().reshape(h, f // qt.block_size, qt.block_size)
        return (blocks * qt.scale.t()[:, :, None]).reshape(h, f).to(out_dtype)
    if qt.scheme == "int8":
        vals = qt.data.float() * qt.scale
    else:
        code = torch.as_tensor(NF4_CODE, device=qt.data.device)
        lo = code[(qt.data & 0x0F).long()]
        hi = code[(qt.data >> 4).long()]
        # block positions 0, 2, 4 ... were lo, 1, 3, 5 ... hi
        vals = torch.stack([lo, hi], dim=-1).reshape(qt.data.shape[0], -1) * qt.scale
    return vals.reshape(-1)[:n].reshape(qt.shape).to(out_dtype)


def dequantize_tree(params: dict, dtype=None) -> dict:
    """Every :class:`QuantizedTensor` of a name -> value dict dequantized."""
    return {k: dequantize(v, dtype) if is_quantized(v) else v for k, v in params.items()}


def _is_linear_weight(name: str, value) -> bool:
    return name.endswith(".weight") and getattr(value, "ndim", 0) == 2


def quantize_params(params: dict, config: QuantizationConfig) -> dict:
    """Quantize the eligible entries of a ``state_dict``-style name ->
    tensor dict (JAX ``quantize_params`` over a param tree).

    2-D ``.weight`` entries are torch ``Linear`` weights ``[out, in]``;
    each is quantized as its ``[in, out]`` transpose, the JAX kernel
    layout, so the codes and scales equal JAX's for the same weights.  The
    same leaves are quantized as in JAX: the HF names carry the same
    ``embed`` / ``norm`` / ``lm_head`` tokens as the flax paths."""
    out = {}
    for name, value in params.items():
        if config.should_quantize(name, value):
            out[name] = quantize(value.t() if _is_linear_weight(name, value) else value,
                                 config)
        else:
            out[name] = value
    return out


def quantize_model_(model: torch.nn.Module, config: QuantizationConfig) -> torch.nn.Module:
    """Quantize, in place on the model's device, the weight of every
    :class:`~accelerate_tpu_torch.models.layers.QuantizableDense` that
    ``config.should_quantize`` takes (the rule :func:`quantize_params`
    applies to ``<module>.weight``).  Each such layer then holds codes and
    scales in place of its weight and runs through
    :func:`~accelerate_tpu_torch.ops.quantized_matmul.quantized_matmul`.
    Returns ``model``."""
    from ..models.layers import QuantizableDense

    for name, module in model.named_modules():
        if isinstance(module, QuantizableDense) and module.weight is not None:
            path = f"{name}.weight"
            if config.should_quantize(path, module.weight):
                with torch.no_grad():
                    module.set_quantized(quantize(module.weight.detach().t(), config))
    return model


def quantized_nbytes(params) -> int:
    """Bytes of a name -> tensor dict, or of a module's ``state_dict`` (a
    quantized layer's codes and scales included), a
    :class:`QuantizedTensor` counting its codes and its f32 scales (JAX
    ``quantized_nbytes``)."""
    values = (params.state_dict() if isinstance(params, torch.nn.Module) else params).values()
    total = 0
    for v in values:
        if is_quantized(v):
            total += v.data.numel() * v.data.element_size() + v.scale.numel() * 4
        elif isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
        else:
            total += np.asarray(v).nbytes
    return total


@contextlib.contextmanager
def _dequantized(model: torch.nn.Module, dtype=None):
    """Every quantized ``QuantizableDense`` of ``model`` holding a dense
    weight (``[out, in]``, in ``dtype`` or its compute dtype) while the
    block runs; its codes and scales again after."""
    from ..models.layers import QuantizableDense

    saved = []
    for module in model.modules():
        if isinstance(module, QuantizableDense) and module._qmeta is not None:
            qt = module.quantized
            saved.append((module, module._qmeta))
            module.weight = torch.nn.Parameter(dequantize(qt, dtype or module.dtype).t(),
                                               requires_grad=False)
            module._qmeta = None
    try:
        yield model
    finally:
        for module, qmeta in saved:
            module.weight = None
            module._qmeta = qmeta


def quantized_apply(apply_fn: Callable, dtype=None) -> Callable:
    """Run on dequantized weights (JAX :286): for a module, the returned
    callable runs it with each quantized layer's weight expanded to
    ``dtype`` (default: the layer's compute dtype) for that one forward;
    for ``apply_fn(params, *args)`` over a name -> tensor mapping, every
    :class:`QuantizedTensor` of ``params`` is dequantized first."""
    if isinstance(apply_fn, torch.nn.Module):
        model = apply_fn

        def run(*args, **kwargs):
            with _dequantized(model, dtype):
                return model(*args, **kwargs)

        return run

    def wrapped(params, *args, **kwargs):
        return apply_fn(dequantize_tree(params, dtype), *args, **kwargs)

    return wrapped


def load_and_quantize_model(model: torch.nn.Module, checkpoint, config: QuantizationConfig, *,
                            device=None, stats: Optional[dict] = None) -> torch.nn.Module:
    """Stream ``checkpoint`` into ``model`` (built under
    ``big_modeling.init_empty_weights``, or not) and quantize each weight
    ``config.should_quantize`` takes as it arrives (JAX :331, reference
    utils/bnb.py): the weight is cast on the host, copied to the card and
    quantized there into its ``QuantizableDense``'s codes and scales
    (``[in, out]``, as :func:`quantize_model_` does), so the card never
    holds more than the int8 model and one full-precision weight with its
    quantizer temporaries.  The other tensors land on the card in the
    model's dtypes.  Codes and scales are :func:`quantize_model_`'s,
    bitwise, for the same weights.  ``checkpoint`` and ``stats`` as
    ``big_modeling.load_checkpoint_in_model``'s (``stats`` also receives
    ``quantize_s``).  Returns ``model``."""
    from ..big_modeling import _stream_into

    model, _ = _stream_into(model, checkpoint, device=device, quantization_config=config,
                            stats=stats)
    return model
