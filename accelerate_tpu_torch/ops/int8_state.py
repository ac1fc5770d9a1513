"""Int8 optimizer state with stochastic-rounding requantization (mirrors
``accelerate_tpu/ops/int8_state.py``).

Each moment is stored as **int8 codes + per-block f32 scales** (the
bitsandbytes block-wise 8-bit state contract) and requantized every step
with a **stochastic** round, so the expected state stays exact while a
nearest round would freeze increments below one code.  The signed linear
map (``scale = absmax / 127``) holds lion's and adam's first moments; the
log-spaced uint8 map (``x = absmax * 2^((code - 255) * 24 / 255)``) holds
adam's second moment, which spans orders of magnitude within a block and
sits under a square root.

The noise is the JAX package's hash (:func:`~.stochastic_rounding.sr_noise_bits`)
of the value bits, a salt and an entropy channel, so for the same inputs
and salts the codes, the scales and the bf16 params are the JAX package's
bit for bit.  Codes keep the param's shape (``int8``, or ``uint8`` for the
second moment); scales are f32 ``[ceil(size / block)]`` over the
row-major flat leaf, the last block padded with the leaf's own values
times zero as in JAX.

The -sr8 recipes (:func:`lion_int8_sr`, :func:`adamw_int8_sr`) are the
-sr recipes with int8 moments: bf16 params written back by the hashed
stochastic round, per-leaf independent (so the chunked host update can
split them into leaf groups, each salted by its group-relative index).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .stochastic_rounding import (
    GradientTransformation,
    _base_salt,
    _bias_correction,
    _f32,
    _hyper,
    _leaf_salt,
    sr_noise_bits,
    stochastic_round_to_bf16_hashed,
)

DEFAULT_BLOCK_SIZE = 128

# Dynamic range of the log-spaced uint8 map: code 0 decodes to
# absmax * 2^-24, 24 / 255 of an octave per code (JAX :62)
LOG_RANGE_BITS = 24.0

# the JAX package's traced f32 constants (``_float_consts``), as f32 values
_F32 = {
    "tiny": 1e-30,
    "inv2_16": 1.0 / 65536.0,
    "slog": 255.0 / LOG_RANGE_BITS,
    "inv_slog": LOG_RANGE_BITS / 255.0,
    "log_floor": 2.0 ** -30,
    "ln2": 0.6931471805599453,
    "inv_ln2": 1.4426950408889634,
}
# salt separators of the moment requants from the param write (JAX :102-103)
MU8_SALT = 0x94D049BB
NU8_SALT = 0xBF58476D


def int8_state_consts(seed: int) -> dict:
    """The -sr8 recipes' key material: the hash seed and the two moment
    salt separators (the f32 constants are the module's ``_F32``; torch
    has no host-region rule that would make them state)."""
    return {"seed": seed, "mu8_salt": MU8_SALT, "nu8_salt": NU8_SALT}


def int8_scale_shape(shape, block: int = DEFAULT_BLOCK_SIZE) -> tuple:
    """Shape of the per-block scale vector of a leaf of ``shape``: one
    block spanning a leaf smaller than ``block``, else ``ceil(size /
    block)`` blocks."""
    size = math.prod(shape) if shape else 1
    eff = max(1, min(block, size))
    return (-(-size // eff),)


def _effective_block(size: int, block: int) -> int:
    return max(1, min(block, size))


def _blockify(flat: torch.Tensor, size: int, eff: int) -> torch.Tensor:
    """``[size]`` -> ``[n_blocks, eff]``, the tail block padded with
    ``flat[:pad] * 0`` as in JAX (``pad < eff <= size``)."""
    n = -(-size // eff)
    pad = n * eff - size
    if pad:
        flat = torch.cat([flat, flat[:pad] * 0.0])
    return flat.reshape(n, eff)


def _hash_noise01(x: torch.Tensor, salt: int, entropy: Optional[torch.Tensor] = None):
    """Pseudo-uniform noise in ``[0, 1)``: the shared SR noise bits over
    ``2^16`` (exact in f32)."""
    return sr_noise_bits(x, salt, entropy).float() * _F32["inv2_16"]


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def quantize_int8_blockwise(x: torch.Tensor, block: int = DEFAULT_BLOCK_SIZE, *,
                            signed: bool = True, salt: Optional[int] = None,
                            entropy: Optional[torch.Tensor] = None):
    """Blockwise absmax quantization, ``x ~ codes * scale[block]`` (JAX
    :151).  ``signed``: int8 codes in [-127, 127], ``scale = absmax /
    127``; else uint8 in [0, 255], ``scale = absmax / 255``.  ``salt=None``
    rounds to nearest (``floor(q + 0.5)``); with a salt, ``floor(q + u)``
    with ``u`` hashed from ``q``'s bits, the salt and ``entropy``.
    Returns ``(codes, scales)``."""
    shape = tuple(x.shape)
    size = math.prod(shape) if shape else 1
    eff = _effective_block(size, block)
    xb = _blockify(x.float().reshape(-1), size, eff)
    absmax = xb.abs().amax(dim=-1, keepdim=True)
    qmax = 127.0 if signed else 255.0
    scale = torch.clamp_min(absmax, _F32["tiny"]) / _const(qmax, xb)
    q = xb / scale
    if salt is None:
        q = torch.floor(q + 0.5)
    else:
        eb = (_blockify(entropy.float().reshape(-1), size, eff)
              if entropy is not None else None)
        q = torch.floor(q + _hash_noise01(q, salt, eb))
    q = torch.clamp(q, -qmax if signed else 0.0, qmax)
    codes = q.to(torch.int8 if signed else torch.uint8).reshape(-1)[:size].reshape(shape)
    return codes, scale[:, 0]


def dequantize_int8_blockwise(codes: torch.Tensor, scales: torch.Tensor,
                              block: int = DEFAULT_BLOCK_SIZE, *, dtype=torch.float32):
    """``codes * scale[block]`` at ``codes.shape`` (JAX :203); int8 or
    uint8 codes."""
    shape = tuple(codes.shape)
    size = math.prod(shape) if shape else 1
    eff = _effective_block(size, block)
    vals = _blockify(codes.float().reshape(-1), size, eff) * scales.float()[:, None]
    return vals.reshape(-1)[:size].reshape(shape).to(dtype)


def quantize_u8_log_blockwise(x: torch.Tensor, block: int = DEFAULT_BLOCK_SIZE, *,
                              salt: Optional[int] = None,
                              entropy: Optional[torch.Tensor] = None):
    """Log-spaced uint8 quantization of non-negative ``x`` (JAX :222):
    ``code = 255 + (255 / 24) * log2(x / absmax)``, floored at ``2^-30``
    relative (zeros encode as 0), rounded to nearest or stochastically in
    log space.  Returns ``(codes, scales)``, the scales the block
    absmaxes."""
    shape = tuple(x.shape)
    size = math.prod(shape) if shape else 1
    eff = _effective_block(size, block)
    xb = _blockify(x.float().reshape(-1), size, eff)
    scale = torch.clamp_min(xb.amax(dim=-1, keepdim=True), _F32["tiny"])
    r = torch.clamp_min(xb / scale, _F32["log_floor"])
    q = _const(255.0, xb) + _const(_F32["slog"], xb) * torch.log(r) * _const(_F32["inv_ln2"], xb)
    if salt is None:
        q = torch.floor(q + 0.5)
    else:
        eb = (_blockify(entropy.float().reshape(-1), size, eff)
              if entropy is not None else None)
        q = torch.floor(q + _hash_noise01(q, salt, eb))
    q = torch.clamp(q, 0.0, 255.0)
    codes = q.to(torch.uint8).reshape(-1)[:size].reshape(shape)
    return codes, scale[:, 0]


def dequantize_u8_log_blockwise(codes: torch.Tensor, scales: torch.Tensor,
                                block: int = DEFAULT_BLOCK_SIZE, *, dtype=torch.float32):
    """``scale * 2^((code - 255) * 24 / 255)`` (JAX :272): code 0 decodes
    to ``scale * 2^-24``, never a hard zero."""
    shape = tuple(codes.shape)
    size = math.prod(shape) if shape else 1
    eff = _effective_block(size, block)
    qb = _blockify(codes.float().reshape(-1), size, eff)
    vals = torch.exp((qb - 255.0) * _const(_F32["inv_slog"], qb) * _const(_F32["ln2"], qb)) \
        * scales.float()[:, None]
    return vals.reshape(-1)[:size].reshape(shape).to(dtype)


# ---------------------------------------------------------------------------
# The -sr8 optimizers: bf16 SR params + int8 SR moment state
# ---------------------------------------------------------------------------

# A large leaf updates in slices of about this many elements, whole scale
# blocks each: on the host the temporaries stay in cache instead of paging
# in fresh memory per op (2.2x faster on an 8-core host); on the card the
# update's ~10 f32 temporaries span one slice, not the leaf (a scanned
# stack's [24, 5504, 2048] leaf would hold ~1 GiB each).  Every op is
# elementwise or per block and the salt is the whole leaf's, so the result
# is bitwise the one-piece update's.
HOST_SLICE = 1 << 18
DEVICE_SLICE = 1 << 24


def _by_slices(leaf, block: int, *tensors):
    """``leaf(*tensors)`` -> (new params, then codes / scales pairs), on a
    leaf larger than :data:`HOST_SLICE` (on the card :data:`DEVICE_SLICE`)
    slice by slice over the flat leaf (tensors param-shaped, scales per
    block), written into whole outputs.  The first tensor is the gradient,
    the second the param."""
    g, p = tensors[0], tensors[1]
    n = p.numel()
    limit = HOST_SLICE if p.device.type == "cpu" else DEVICE_SLICE
    step = max(1, limit // block) * block
    if n <= step:
        return leaf(*tensors)
    flat = [t.reshape(-1) for t in tensors]
    outs = None
    for k in range(0, n, step):
        stop = min(n, k + step)
        args = [t[k // block:-(-stop // block)] if t.numel() != n else t[k:stop]
                for t in flat]
        got = leaf(*args)
        if outs is None:
            outs = [torch.empty((n,) if x.numel() == stop - k else int8_scale_shape((n,), block),
                                dtype=x.dtype, device=p.device) for x in got]
        for o, x in zip(outs, got):
            if o.numel() == n:
                o[k:stop] = x
            else:
                o[k // block:k // block + x.numel()] = x
        del got, args
    return [o.reshape(p.shape) if o.numel() == n else o for o in outs]


class LionSR8State(NamedTuple):
    count: int        # step counter; folds into the per-leaf SR salt
    mu: list          # int8 momentum codes, param-shaped
    mu_scale: list    # f32 per-block scales
    hyperparams: dict  # f32 0-d tensors and the hash seed


class AdamWSR8State(NamedTuple):
    count: int
    mu: list          # int8 first-moment codes (linear map)
    mu_scale: list
    nu: list          # uint8 second-moment codes (log map)
    nu_scale: list
    hyperparams: dict


def lion_int8_sr(learning_rate: float = 1e-4, b1: float = 0.9, b2: float = 0.99,
                 weight_decay: float = 0.0, seed: int = 0,
                 block_size: int = DEFAULT_BLOCK_SIZE) -> GradientTransformation:
    """Lion with bf16 SR params and int8 SR momentum (JAX ``lion_int8_sr``
    :309): direction ``sign(b1 m + (1 - b1) g)``, the weight written back
    by the hashed stochastic round, the momentum ``b2 m + (1 - b2) g``
    requantized with its own salt (``salt ^ mu8_salt``), the gradient as
    entropy."""

    def init(params):
        return LionSR8State(
            count=0,
            mu=[torch.zeros(p.shape, dtype=torch.int8, device=p.device) for p in params],
            mu_scale=[torch.ones(int8_scale_shape(p.shape, block_size), dtype=torch.float32,
                                 device=p.device) for p in params],
            hyperparams={**_hyper(params, seed, lr=learning_rate, b1=b1, b2=b2,
                                  wd=weight_decay), **int8_state_consts(seed)})

    def update(grads, state, params=None, numels=None):
        if params is None:
            raise ValueError("lion_int8_sr is a weight update: pass params")
        hp = state.hyperparams
        count = state.count + 1
        base = _base_salt(count, hp["seed"])
        new_p, new_m, new_s = [], [], []
        for i, (g, p, mc, ms) in enumerate(zip(grads, params, state.mu, state.mu_scale)):
            salt = _leaf_salt(base, i, p.numel() if numels is None else numels[i])

            def leaf(g, p, mc, ms):
                g32, p32 = g.float(), p.float()
                m32 = dequantize_int8_blockwise(mc, ms, block_size)
                direction = torch.sign(hp["b1"] * m32 + hp["1-b1"] * g32)
                # with no decay the term is +-0, which leaves every bit as it is
                step = hp["lr"] * (direction + hp["wd"] * p32 if weight_decay else direction)
                codes, scale = quantize_int8_blockwise(
                    hp["b2"] * m32 + hp["1-b2"] * g32, block_size, signed=True,
                    salt=salt ^ hp["mu8_salt"], entropy=g32)
                return stochastic_round_to_bf16_hashed(p32 - step, salt, entropy=g32), codes, scale

            np_, codes, scale = _by_slices(leaf, block_size, g, p, mc, ms)
            new_p.append(np_)
            new_m.append(codes)
            new_s.append(scale)
        return new_p, LionSR8State(count, new_m, new_s, hp)

    return GradientTransformation(init, update)


def adamw_int8_sr(learning_rate: float = 1e-4, b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8, weight_decay: float = 0.0, seed: int = 0,
                  block_size: int = DEFAULT_BLOCK_SIZE) -> GradientTransformation:
    """AdamW with bf16 SR params, the first moment on the linear int8 map
    and the second on the log uint8 map (JAX ``adamw_int8_sr`` :401), both
    requantized stochastically (``salt ^ mu8_salt`` with the gradient as
    entropy, ``salt ^ nu8_salt`` with its square).  The f32 bias
    corrections are correctly rounded, as the -sr recipe's
    (``_bias_correction``)."""

    def init(params):
        def ones(p):
            return torch.ones(int8_scale_shape(p.shape, block_size), dtype=torch.float32,
                              device=p.device)

        return AdamWSR8State(
            count=0,
            mu=[torch.zeros(p.shape, dtype=torch.int8, device=p.device) for p in params],
            mu_scale=[ones(p) for p in params],
            nu=[torch.zeros(p.shape, dtype=torch.uint8, device=p.device) for p in params],
            nu_scale=[ones(p) for p in params],
            hyperparams={**_hyper(params, seed, lr=learning_rate, b1=b1, b2=b2, eps=eps,
                                  wd=weight_decay), **int8_state_consts(seed)})

    def update(grads, state, params=None, numels=None):
        if params is None:
            raise ValueError("adamw_int8_sr is a weight update: pass params")
        hp = state.hyperparams
        count = state.count + 1
        bc1 = _f32(_bias_correction(b1, count), hp["b1"].device)
        bc2 = _f32(_bias_correction(b2, count), hp["b2"].device)
        base = _base_salt(count, hp["seed"])
        new_p, new_m, new_ms, new_v, new_vs = [], [], [], [], []
        for i, (g, p, mc, ms, vc, vs) in enumerate(zip(grads, params, state.mu, state.mu_scale,
                                                       state.nu, state.nu_scale)):
            salt = _leaf_salt(base, i, p.numel() if numels is None else numels[i])

            def leaf(g, p, mc, ms, vc, vs):
                g32, p32 = g.float(), p.float()
                m32 = hp["b1"] * dequantize_int8_blockwise(mc, ms, block_size) + hp["1-b1"] * g32
                v32 = (hp["b2"] * dequantize_u8_log_blockwise(vc, vs, block_size)
                       + hp["1-b2"] * g32 * g32)
                step = hp["lr"] * ((m32 / bc1) / (torch.sqrt(v32 / bc2) + hp["eps"])
                                   + hp["wd"] * p32)
                m_codes, m_scale = quantize_int8_blockwise(
                    m32, block_size, signed=True, salt=salt ^ hp["mu8_salt"], entropy=g32)
                v_codes, v_scale = quantize_u8_log_blockwise(
                    v32, block_size, salt=salt ^ hp["nu8_salt"], entropy=g32 * g32)
                return (stochastic_round_to_bf16_hashed(p32 - step, salt, entropy=g32),
                        m_codes, m_scale, v_codes, v_scale)

            outs = _by_slices(leaf, block_size, g, p, mc, ms, vc, vs)
            for dst, x in zip((new_p, new_m, new_ms, new_v, new_vs), outs):
                dst.append(x)
        return new_p, AdamWSR8State(count, new_m, new_ms, new_v, new_vs, hp)

    return GradientTransformation(init, update)
