"""Named optimizer recipes and the optimizer wrapper (mirrors
``accelerate_tpu/optimizer.py``).

An optimizer here is a :class:`GradientTransformation` over ordered lists
of tensors (``init(params) -> state``, ``update(grads, state, params) ->
(new_params, state)``, the new leaves in the params' dtypes, which the
train step copies into the params), so the train step owns the update as
the JAX step does.  The stock recipes are optax's math written out in
PyTorch, ``optax.apply_updates`` included.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from .ops.stochastic_rounding import GradientTransformation, adamw_bf16_sr, lion_bf16_sr

OPTIMIZER_RECIPES: dict[str, str] = {
    "lion": "optax.lion, fp32 masters + bf16 momentum",
    "adamw": "optax.adamw, fp32 masters + bf16 first moment",
    "lion-sr": "bf16 SR params + bf16 momentum (16 -> 10 host-B/param)",
    "adamw-sr": "bf16 SR params + bf16 m/v (28 -> 14 host-B/param)",
    "lion-sr8": "bf16 SR params + int8 momentum (10 -> ~8 host-B/param)",
    "adamw-sr8": "bf16 SR params + int8 m + uint8 v (14 -> ~10 host-B/param)",
}


def reference_recipe(name: str) -> str:
    """The f32-master recipe an -sr/-sr8 recipe is validated against."""
    return name.split("-", 1)[0]


class LionState(NamedTuple):
    count: int
    mu: list


class AdamState(NamedTuple):
    count: int
    mu: list
    nu: list


def lion(learning_rate: float, b1: float = 0.9, b2: float = 0.99, weight_decay: float = 0.0,
         mu_dtype: Optional[torch.dtype] = None) -> GradientTransformation:
    """``optax.lion``: ``-lr (sign((1 - b1) g + b1 m) + wd p)``, momentum
    ``(1 - b2) g + b2 m`` stored in ``mu_dtype``."""

    def init(params):
        return LionState(0, [torch.zeros_like(p, dtype=mu_dtype or p.dtype) for p in params])

    def update(grads, state, params):
        new_p, mu = [], []
        for g, m, p in zip(grads, state.mu, params):
            u = torch.sign((1.0 - b1) * g + b1 * m)
            if weight_decay:
                u = u + weight_decay * p
            new_p.append((p + -learning_rate * u.float()).to(p.dtype))
            mu.append(((1.0 - b2) * g + b2 * m).to(mu_dtype or g.dtype))
        return new_p, LionState(state.count + 1, mu)

    return GradientTransformation(init, update)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0,
          mu_dtype: Optional[torch.dtype] = None) -> GradientTransformation:
    """``optax.adamw``: bias-corrected ``m / (sqrt(v) + eps) + wd p``
    scaled by ``-lr``; ``m`` stored in ``mu_dtype``, ``v`` in the param's
    dtype."""

    def init(params):
        return AdamState(0, [torch.zeros_like(p, dtype=mu_dtype or p.dtype) for p in params],
                         [torch.zeros_like(p) for p in params])

    def update(grads, state, params):
        count = state.count + 1
        new_p, mu, nu = [], [], []
        for g, m, v, p in zip(grads, state.mu, state.nu, params):
            m_new = (1.0 - b1) * g + b1 * m
            v_new = (1.0 - b2) * g * g + b2 * v
            u = (m_new / (1.0 - b1 ** count)) / (torch.sqrt(v_new / (1.0 - b2 ** count)) + eps)
            if weight_decay:
                u = u + weight_decay * p
            new_p.append((p + -learning_rate * u.float()).to(p.dtype))
            mu.append(m_new.to(mu_dtype or m_new.dtype))
            nu.append(v_new.to(v.dtype))
        return new_p, AdamState(count, mu, nu)

    return GradientTransformation(init, update)


def make_optimizer(name: str, learning_rate: Optional[float] = None, *,
                   weight_decay: float = 0.0, seed: int = 0) -> GradientTransformation:
    """A named recipe at its benchmarked hyperparameters (JAX
    ``make_optimizer``): ``learning_rate`` defaults to 1e-4 for the lion
    family and 3e-4 for the adam family; ``weight_decay`` is passed to every
    recipe; ``seed`` keys the -sr recipes' deterministic rounding."""
    if name not in OPTIMIZER_RECIPES:
        raise ValueError(
            f"unknown optimizer recipe {name!r}; options: {sorted(OPTIMIZER_RECIPES)}"
        )
    if name.endswith("-sr8"):
        raise NotImplementedError(
            f"{name!r} keeps int8 optimizer state (ops/int8_state.py), ROADMAP item A12 "
            "(slice 5)"
        )
    lion_family = reference_recipe(name) == "lion"
    lr = learning_rate if learning_rate is not None else (1e-4 if lion_family else 3e-4)
    if name == "lion":
        return lion(lr, b1=0.9, b2=0.99, weight_decay=weight_decay, mu_dtype=torch.bfloat16)
    if name == "adamw":
        return adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=weight_decay,
                     mu_dtype=torch.bfloat16)
    if name == "lion-sr":
        return lion_bf16_sr(lr, b1=0.9, b2=0.99, weight_decay=weight_decay, seed=seed)
    return adamw_bf16_sr(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=weight_decay, seed=seed)


class AcceleratedOptimizer:
    """Wraps a :class:`GradientTransformation` (JAX ``AcceleratedOptimizer``).
    The update runs inside the prepared train step; ``step``/``zero_grad``
    raise with the way to the train step, as in the JAX package."""

    def __init__(self, tx: GradientTransformation, learning_rate: Optional[Any] = None):
        if not isinstance(tx, GradientTransformation):
            raise TypeError(
                f"AcceleratedOptimizer expects a GradientTransformation, got {type(tx)}. "
                "Hand over the optimizer construction (e.g. make_optimizer('adamw')), "
                "not a stepped torch.optim object."
            )
        self.tx = tx
        self.learning_rate = learning_rate

    def init(self, params):
        return self.tx.init(params)

    def update(self, grads, opt_state, params):
        return self.tx.update(grads, opt_state, params)

    def step(self, closure=None):
        raise RuntimeError(
            "The optimizer update runs inside the prepared train step. Use "
            "`state, metrics = step(state, batch)` with the function returned by "
            "`accelerator.prepare_train_step(loss_fn)` instead of calling optimizer.step()."
        )

    def zero_grad(self, set_to_none: Optional[bool] = None):
        raise RuntimeError(
            "Gradients are values returned by the prepared train step; there is nothing "
            "to zero. Remove optimizer.zero_grad() from the loop."
        )

    def state_dict(self):
        raise RuntimeError(
            "Optimizer state lives in the TrainState (its opt_state field); checkpointing "
            "is ROADMAP item A7."
        )

    def __repr__(self):
        return f"AcceleratedOptimizer(tx={self.tx}, learning_rate={self.learning_rate})"
