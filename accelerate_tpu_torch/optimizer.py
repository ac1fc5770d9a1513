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

from .ops.int8_state import DEFAULT_BLOCK_SIZE, adamw_int8_sr, lion_int8_sr
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
                   weight_decay: float = 0.0, block_size: Optional[int] = None,
                   seed: int = 0) -> GradientTransformation:
    """A named recipe at its benchmarked hyperparameters (JAX
    ``make_optimizer``): ``learning_rate`` defaults to 1e-4 for the lion
    family and 3e-4 for the adam family; ``weight_decay`` is passed to every
    recipe; ``block_size`` (the -sr8 recipes only, default 128) is the
    per-block scale granularity of the int8 state; ``seed`` keys the -sr /
    -sr8 recipes' deterministic rounding."""
    if name not in OPTIMIZER_RECIPES:
        raise ValueError(
            f"unknown optimizer recipe {name!r}; options: {sorted(OPTIMIZER_RECIPES)}"
        )
    if block_size is not None:
        if not name.endswith("-sr8"):
            raise ValueError(
                f"block_size only applies to the -sr8 int8-state recipes, got {name!r}"
            )
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
    lion_family = reference_recipe(name) == "lion"
    lr = learning_rate if learning_rate is not None else (1e-4 if lion_family else 3e-4)
    block = DEFAULT_BLOCK_SIZE if block_size is None else block_size
    if name == "lion":
        return lion(lr, b1=0.9, b2=0.99, weight_decay=weight_decay, mu_dtype=torch.bfloat16)
    if name == "adamw":
        return adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=weight_decay,
                     mu_dtype=torch.bfloat16)
    if name == "lion-sr":
        return lion_bf16_sr(lr, b1=0.9, b2=0.99, weight_decay=weight_decay, seed=seed)
    if name == "adamw-sr":
        return adamw_bf16_sr(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=weight_decay,
                             seed=seed)
    if name == "lion-sr8":
        return lion_int8_sr(lr, b1=0.9, b2=0.99, weight_decay=weight_decay, seed=seed,
                            block_size=block)
    return adamw_int8_sr(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=weight_decay,
                         seed=seed, block_size=block)


def flatten_opt_state(opt_state) -> tuple[list, dict]:
    """An optimizer state (a NamedTuple of host ints, lists of tensors and
    the hyperparameter dict) as ``(tensors, meta)``: its tensors in field
    order (their flatten index is their place in the list) and ``meta``:
    ``type`` (the NamedTuple's name), ``fields`` (the host ints, ``count``)
    and ``hyperparams`` (the dict as it is, f32 0-d tensors and the hash
    seed)."""
    tensors, fields, hyper = [], {}, {}
    for field, value in zip(type(opt_state)._fields, opt_state):
        if isinstance(value, torch.Tensor):
            tensors.append(value)
        elif isinstance(value, (list, tuple)):
            tensors.extend(value)
        elif isinstance(value, dict):
            hyper = dict(value)
        else:
            fields[field] = value
    return tensors, {"type": type(opt_state).__name__, "fields": fields, "hyperparams": hyper}


def unflatten_opt_state(template, tensors: list, fields: dict, hyperparams: dict):
    """:func:`flatten_opt_state`'s inverse over ``template`` (a state of the
    same recipe and params): each tensor is checked against the template's
    leaf (dtype and element count), reshaped to it and moved to its device;
    host ints come from ``fields``; hyperparameter tensors are rebuilt from
    the values in ``hyperparams`` (numbers) in the template's dtype and
    device."""
    tmpl_tensors, meta = flatten_opt_state(template)
    if len(tensors) != len(tmpl_tensors):
        raise ValueError(f"optimizer state has {len(tensors)} tensors, the template "
                         f"{len(tmpl_tensors)}")
    for i, (t, ref) in enumerate(zip(tensors, tmpl_tensors)):
        if t.dtype != ref.dtype or t.numel() != ref.numel():
            raise ValueError(f"optimizer state tensor {i}: {t.dtype} {tuple(t.shape)} does not "
                             f"match the template's {ref.dtype} {tuple(ref.shape)}")
    def place(t, ref):
        t = t.reshape(ref.shape)
        if ref.device.type == "cpu" and ref.is_pinned() and not t.is_pinned():
            return t.pin_memory()   # an offloaded state stays page-locked
        return t.to(ref.device, non_blocking=True)

    it = iter(place(t, ref) for t, ref in zip(tensors, tmpl_tensors))
    values = []
    for field, value in zip(type(template)._fields, template):
        if isinstance(value, torch.Tensor):
            values.append(next(it))
        elif isinstance(value, (list, tuple)):
            values.append(type(value)(next(it) for _ in value))
        elif isinstance(value, dict):
            values.append({k: (torch.tensor(float(hyperparams[k]), dtype=v.dtype, device=v.device)
                               if isinstance(v, torch.Tensor) else hyperparams[k])
                           for k, v in value.items()})
        else:
            values.append(type(value)(fields[field]))
    return type(template)(*values)


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

    def state_dict(self, opt_state) -> dict:
        """The optimizer state of a train state (``state.opt_state``; the
        state lives in the train state, not here) as a dict: ``type``,
        ``fields`` (``count``), ``hyperparams`` (numbers) and ``tensors``
        (flatten index -> tensor, the live tensors)."""
        tensors, meta = flatten_opt_state(opt_state)
        hyper = {k: (v.item() if isinstance(v, torch.Tensor) else v)
                 for k, v in meta["hyperparams"].items()}
        return {"type": meta["type"], "fields": meta["fields"], "hyperparams": hyper,
                "tensors": {str(i): t for i, t in enumerate(tensors)}}

    def load_state_dict(self, state_dict: dict, opt_state):
        """The optimizer state ``state_dict`` describes, built over
        ``opt_state`` (a state of the same recipe and params) and
        returned."""
        if state_dict["type"] != type(opt_state).__name__:
            raise ValueError(f"optimizer state {state_dict['type']} does not match "
                             f"{type(opt_state).__name__}")
        tensors = [state_dict["tensors"][str(i)] for i in range(len(state_dict["tensors"]))]
        return unflatten_opt_state(opt_state, tensors, state_dict["fields"],
                                   state_dict["hyperparams"])

    def __repr__(self):
        return f"AcceleratedOptimizer(tx={self.tx}, learning_rate={self.learning_rate})"
