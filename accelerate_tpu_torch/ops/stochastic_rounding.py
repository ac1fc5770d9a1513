"""Stochastic rounding and the bf16-master lion and adamw optimizers (mirrors
``accelerate_tpu/ops/stochastic_rounding.py``).

Parameters stay bf16 (no f32 master copy); each update runs in f32 per leaf
and writes the new weight back with a **stochastic** round, so updates
smaller than half a bf16 ulp survive in expectation.  The noise is the JAX
package's deterministic hash of the value bits, a per-(step, leaf) salt and
the gradient, so the port draws the very same bits: equal f32 inputs give
bitwise-equal bf16 outputs in both frameworks.

The hash is uint32 arithmetic.  PyTorch has no uint32 multiply, so it runs
on the same 32 bits as int32: two's-complement addition and multiplication
give the uint32 results' low 32 bits, xor and and are the same bits, and
the logical right shifts are arithmetic shifts with the sign copies masked
off.  (An int64 form, masked to 32 bits, costs twice the bytes and three
multiplies per product; on the card the update spent most of its time
there.)  Salts are Python ints (host side, no device sync).  The leaf index in the salt is the leaf's place in flax's
flatten order (sorted keys: ``layers_10`` before ``layers_2``):
:func:`flax_leaf_order` gives that order for the port's parameter names,
and the optimizers take their leaves as ordered lists.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.hf_interop import hf_llama_key_map

_M32 = 0xFFFFFFFF
_HASH = {"m1": 0x9E3779B1, "m2": 0x85EBCA77, "nu_salt": 0x27D4EB2F}


def flax_leaf_order(names) -> list[str]:
    """``names`` (the port's HF-style parameter names) in the order
    ``jax.tree_util`` flattens the JAX package's param tree: sorted by the
    path's keys, compared as strings."""
    return sorted(names, key=lambda n: tuple((hf_llama_key_map(n) or n).split(".")))


def _i32(value: int) -> int:
    """A uint32 constant as the int32 with the same bits."""
    value &= _M32
    return value - 2**32 if value >= 2**31 else value


def _bits(x: torch.Tensor) -> torch.Tensor:
    """The f32 bit pattern of ``x`` as int32."""
    return x.float().contiguous().view(torch.int32)


def sr_noise_bits(x: torch.Tensor, salt: int, entropy: Optional[torch.Tensor] = None):
    """16 noise bits per element (int32 in ``[0, 2^16)``), hashed
    murmur-style from ``x``'s f32 bits, ``salt`` and the optional
    ``entropy`` channel (JAX ``sr_noise_bits``)."""
    h = _bits(x) ^ _i32(salt)
    if entropy is not None:
        h = h ^ (_bits(entropy) * _i32(_HASH["m2"]))
    h = h * _i32(_HASH["m1"])
    h = h ^ ((h >> 16) & 0xFFFF)
    h = h * _i32(_HASH["m2"])
    h = h ^ ((h >> 13) & 0x7FFFF)
    return h & 0xFFFF


def stochastic_round_to_bf16(x: torch.Tensor, generator: Optional[torch.Generator] = None
                             ) -> torch.Tensor:
    """Round f32 ``x`` to bf16 up or down with probability given by its
    position between the two neighbours, unbiased (JAX
    ``stochastic_round_to_bf16`` :28): add 16 uniform noise bits to the
    low half of the f32 pattern, then truncate it.  JAX draws the bits from
    ``jax.random``; the port from ``generator`` (its device's default when
    None), so the two agree in distribution, not bit for bit."""
    noise = torch.randint(0, 1 << 16, x.shape, generator=generator, dtype=torch.int32,
                          device=x.device)
    bumped = (_bits(x) + noise) & _i32(0xFFFF0000)
    return bumped.view(torch.float32).to(torch.bfloat16)


def stochastic_round_to_bf16_hashed(x: torch.Tensor, salt: int,
                                    entropy: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Round f32 ``x`` to bf16 up or down with probability given by its
    position between the two neighbours: add the hashed noise to the low 16
    bits, then truncate them (JAX ``stochastic_round_to_bf16_hashed``)."""
    bumped = (_bits(x) + sr_noise_bits(x, salt, entropy)) & _i32(0xFFFF0000)
    return bumped.view(torch.float32).to(torch.bfloat16)


def _base_salt(count: int, seed: int) -> int:
    """Per-step salt: ``((count + 1) * m1) ^ seed`` in uint32."""
    return (((count + 1) * _HASH["m1"]) & _M32) ^ (seed & _M32)


def _leaf_salt(base_salt: int, i: int, size: int) -> int:
    """Leaf-distinct salt from the leaf's flatten index and size."""
    return base_salt ^ ((i * 2654435761 + size) & _M32)


def _f32(value: float, device) -> torch.Tensor:
    """A hyperparameter as an f32 0-d tensor, so the math around it runs in
    f32 as JAX's traced f32 scalars do (``1 - b1`` included)."""
    return torch.tensor(value, dtype=torch.float32, device=device)


class GradientTransformation(NamedTuple):
    """An ``(init, update)`` pair over ordered lists of tensors:
    ``init(params) -> state``; ``update(grads, state, params) ->
    (new_params, new_state)``.  Where optax returns updates for
    ``optax.apply_updates`` to add, ``update`` returns the new leaves
    themselves, which the caller copies into the params: the stock recipes
    in the params' dtypes (what ``apply_updates`` gives), the -sr recipes
    as their stochastically rounded bf16 weights.  The -sr / -sr8
    recipes' ``update`` also takes ``numels``, each leaf's whole size where
    ``params`` holds ranges of the leaves (a sharded train state): the
    salts key on it, so a range updates as its whole leaf would."""

    init: object
    update: object


class LionSRState(NamedTuple):
    count: int        # step counter; folds into the per-leaf SR salt
    mu: list          # bf16 momentum
    hyperparams: dict  # f32 0-d tensors and the hash seed


class AdamWSRState(NamedTuple):
    count: int
    mu: list          # bf16 first moment (nearest rounding)
    nu: list          # bf16 second moment (stochastic rounding)
    hyperparams: dict


def _hyper(params, seed, **values) -> dict:
    """The hyperparameters as f32 0-d tensors on the params' device, with
    ``1 - b1`` / ``1 - b2`` formed once in f32, and the hash seed."""
    dev = params[0].device if params else "cpu"
    hp = {k: _f32(v, dev) for k, v in values.items()}
    hp["1-b1"], hp["1-b2"] = 1.0 - hp["b1"], 1.0 - hp["b2"]
    hp["seed"] = seed
    return hp


def lion_bf16_sr(learning_rate: float = 1e-4, b1: float = 0.9, b2: float = 0.99,
                 weight_decay: float = 0.0, seed: int = 0) -> GradientTransformation:
    """Lion whose parameters themselves stay bf16 (JAX ``lion_bf16_sr``):
    the new weight ``p - lr (sign(b1 m + (1 - b1) g) + wd p)`` is written
    back with stochastic rounding; the momentum ``b2 m + (1 - b2) g`` is
    kept in bf16."""

    def init(params):
        return LionSRState(count=0,
                           mu=[torch.zeros_like(p, dtype=torch.bfloat16) for p in params],
                           hyperparams=_hyper(params, seed, lr=learning_rate, b1=b1, b2=b2,
                                              wd=weight_decay))

    def update(grads, state, params=None, numels=None):
        if params is None:
            raise ValueError("lion_bf16_sr is a weight update: pass params")
        hp = state.hyperparams
        count = state.count + 1
        base = _base_salt(count, hp["seed"])
        new_p, new_m = [], []
        for i, (g, p, m) in enumerate(zip(grads, params, state.mu)):
            g32, m32, p32 = g.float(), m.float(), p.float()
            direction = torch.sign(hp["b1"] * m32 + hp["1-b1"] * g32)
            # with no decay the term is +-0, which leaves every bit as it is
            step = hp["lr"] * (direction + hp["wd"] * p32 if weight_decay else direction)
            salt = _leaf_salt(base, i, p.numel() if numels is None else numels[i])
            new_p.append(stochastic_round_to_bf16_hashed(p32 - step, salt, entropy=g32))
            new_m.append((hp["b2"] * m32 + hp["1-b2"] * g32).to(torch.bfloat16))
        return new_p, LionSRState(count, new_m, hp)

    return GradientTransformation(init, update)


def _bias_correction(b: float, count: int) -> float:
    """``1 - exp(count * log(b))`` as the JAX optimizer computes it on
    traced f32 scalars: each step taken in f64 and rounded to f32, which
    gives the correctly rounded f32 results XLA's ``log``/``exp`` give here
    (numpy's own f32 ``log``/``exp`` are an ulp off at some counts)."""
    f = np.float32
    log_b = f(math.log(float(f(b))))
    y = f(float(f(count)) * float(log_b))
    return float(f(1.0 - float(f(math.exp(float(y))))))


def adamw_bf16_sr(learning_rate: float = 1e-4, b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8, weight_decay: float = 0.0,
                  seed: int = 0) -> GradientTransformation:
    """AdamW with bf16 parameters and moments (JAX ``adamw_bf16_sr``):
    params and ``nu`` written back with stochastic rounding (their
    increments are below half a bf16 ulp), ``mu`` with nearest rounding."""

    def init(params):
        zeros = [torch.zeros_like(p, dtype=torch.bfloat16) for p in params]
        return AdamWSRState(count=0, mu=zeros,
                            nu=[torch.zeros_like(p, dtype=torch.bfloat16) for p in params],
                            hyperparams=_hyper(params, seed, lr=learning_rate, b1=b1, b2=b2,
                                               eps=eps, wd=weight_decay))

    def update(grads, state, params=None, numels=None):
        if params is None:
            raise ValueError("adamw_bf16_sr is a weight update: pass params")
        hp = state.hyperparams
        count = state.count + 1
        bc1 = _f32(_bias_correction(b1, count), hp["b1"].device)
        bc2 = _f32(_bias_correction(b2, count), hp["b2"].device)
        base = _base_salt(count, hp["seed"])
        new_p, new_m, new_v = [], [], []
        for i, (g, p, m, v) in enumerate(zip(grads, params, state.mu, state.nu)):
            g32 = g.float()
            m32 = hp["b1"] * m.float() + hp["1-b1"] * g32
            v32 = hp["b2"] * v.float() + hp["1-b2"] * g32 * g32
            p32 = p.float()
            step = hp["lr"] * ((m32 / bc1) / (torch.sqrt(v32 / bc2) + hp["eps"])
                               + hp["wd"] * p32)
            salt = _leaf_salt(base, i, p.numel() if numels is None else numels[i])
            new_p.append(stochastic_round_to_bf16_hashed(p32 - step, salt, entropy=g32))
            new_m.append(m32.to(torch.bfloat16))
            new_v.append(stochastic_round_to_bf16_hashed(v32, salt ^ _HASH["nu_salt"],
                                                         entropy=g32 * g32))
        return new_p, AdamWSRState(count, new_m, new_v, hp)

    return GradientTransformation(init, update)
