"""fp8 delayed scaling riding the train state, and the HYBRID (e4m3
forward, e5m2 backward) product (mirrors ``accelerate_tpu/ops/fp8.py``).

1. **State that rides the train state.**  :func:`init_fp8_state` gives
   each dense layer of the model (a ``QuantizableDense`` or the head: every
   2-D ``<module>.weight`` but the embedding's) an
   :class:`~.precision.Fp8Meta`, keyed by the layer's module name
   (``model.layers.0.self_attn.q_proj``) where the JAX package keys by the
   module path of its ``kernel``.  ``create_train_state`` builds it
   under ``mixed_precision="fp8"``; the train step rolls each history with
   the post-update weight's amax (:func:`update_fp8_state`), so the scale
   used at step t + 1 comes from amaxes observed through step t (TE's
   ``DelayedScaling``); checkpoints carry it.
2. **Delivery.**  :func:`merge_fp8_collection` makes the metas visible to
   the layers for the duration of a forward, as JAX merges its ``"fp8"``
   collection into the variables; a layer inside ``fp8_autocast`` with a
   meta runs :func:`fp8_delayed_dot`, one without runs the stateless
   current-scaled product.
3. **HYBRID backward.**  :func:`fp8_delayed_dot`: the weight quantized with
   its delayed scale, the activation with its current one (e4m3 both), the
   incoming gradient current-scaled to e5m2, and both gradient products in
   fp8 (``precision.fp8_mm``: ``torch._scaled_mm`` on the card, e5m2 x
   e4m3).

Env knobs, read when a recipe is built: ``ACCELERATE_FP8_AMAX_HISTORY_LEN``
(default 16), ``ACCELERATE_FP8_MARGIN`` (default 0) and
``ACCELERATE_FP8_DELAYED`` (default on; off keeps every layer on current
scaling).
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

from .precision import (
    _FP8_STATE,
    E4M3_MAX,
    E5M2_MAX,
    Fp8Meta,
    _amax,
    _flat,
    _over,
    amax_axes,
    fp8_mm,
    global_amax,
    saturate_cast,
)

DEFAULT_AMAX_HISTORY_LEN = 16


def _env_flag(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() not in ("0", "false", "off", "no", "")


def fp8_delayed_enabled() -> bool:
    """Whether the delayed-scaling recipe is armed (``ACCELERATE_FP8_DELAYED``,
    default on)."""
    return _env_flag("ACCELERATE_FP8_DELAYED", True)


def amax_history_len() -> int:
    return int(os.environ.get("ACCELERATE_FP8_AMAX_HISTORY_LEN", DEFAULT_AMAX_HISTORY_LEN))


def fp8_margin() -> int:
    return int(os.environ.get("ACCELERATE_FP8_MARGIN", 0))


# ---------------------------------------------------------------------------
# Delayed-scaling state (rides TrainState.fp8_state)
# ---------------------------------------------------------------------------


def fp8_dense_names(params: dict) -> list[str]:
    """The module names of the dense layers among ``params`` (a name ->
    tensor mapping): every 2-D floating ``<module>.weight`` but an
    embedding's — the port's counterpart of JAX's ``kernel`` leaves."""
    return [n[: -len(".weight")] for n, t in params.items()
            if n.endswith(".weight") and t.dim() == 2 and t.is_floating_point()
            and "embed" not in n]


def _weight_amaxes(params: dict, names: list, plan=None) -> list:
    """Each dense's whole-weight amax (f32 0-d): under a sharding ``plan``
    (``parallel/fsdp.py``: a rank holds a range or a tp slice) the ranks'
    amaxes maxed over every mesh axis at once, so the metas are the same on
    every rank (JAX's amax of the global kernel).  Padding lanes are zero
    and never raise an amax."""
    amaxes = [_amax(params[n + ".weight"]) for n in names]
    if plan is None or not plan.all_axes or not amaxes:
        return amaxes
    return list(plan.pmax(torch.stack(amaxes)).unbind(0))


def init_fp8_state(params: dict, history_len: Optional[int] = None,
                   margin: Optional[int] = None, plan=None) -> Optional[dict]:
    """``{module name: Fp8Meta}`` over the dense layers of ``params``, each
    history seeded with the weight's current amax, so step 0 quantizes
    with the current-scaling scale (JAX :113).  Under a sharding ``plan``
    the amax is the whole weight's, though ``params`` hold this rank's
    parts.  None when there is no dense layer."""
    history_len = amax_history_len() if history_len is None else history_len
    margin = fp8_margin() if margin is None else margin
    if plan is not None:
        names = [n[: -len(".weight")] for n, lay in plan.layouts.items()
                 if n.endswith(".weight") and len(lay.whole_shape) == 2
                 and params[n].is_floating_point() and "embed" not in n]
    else:
        names = fp8_dense_names(params)
    state = {}
    for name, amax in zip(names, _weight_amaxes(params, names, plan)):
        w = params[name + ".weight"]
        state[name] = Fp8Meta.init(history_len, device=w.device).updated(amax, E4M3_MAX, margin)
    return state or None


def update_fp8_state(fp8_state: Optional[dict], params: dict,
                     margin: Optional[int] = None, plan=None) -> Optional[dict]:
    """One delayed-scaling tick against the post-update weights (JAX
    :147): each history rolled with its weight's amax (the whole weight's
    under a ``plan``), the scale re-derived."""
    if fp8_state is None:
        return None
    margin = fp8_margin() if margin is None else margin
    names = list(fp8_state)
    amaxes = _weight_amaxes(params, names, plan)
    return {name: fp8_state[name].updated(amax.to(fp8_state[name].amax_history.device),
                                          E4M3_MAX, margin)
            for name, amax in zip(names, amaxes)}


@contextlib.contextmanager
def merge_fp8_collection(fp8_state: Optional[dict]):
    """Deliver the (detached) metas to the dense layers while the block
    runs (JAX :170 merges them into the variables as the ``"fp8"``
    collection); no state, no change."""
    prev = getattr(_FP8_STATE, "metas", None)
    if fp8_state is not None:
        _FP8_STATE.metas = {k: Fp8Meta(m.amax_history.detach(), m.scale.detach())
                            for k, m in fp8_state.items()}
    try:
        yield
    finally:
        _FP8_STATE.metas = prev


def fp8_meta(name: Optional[str]) -> Optional[Fp8Meta]:
    """The delivered meta of the layer ``name``, or None."""
    metas = getattr(_FP8_STATE, "metas", None)
    return None if metas is None or name is None else metas.get(name)


# ---------------------------------------------------------------------------
# HYBRID matmul: e4m3 forward, e5m2 current-scaled backward
# ---------------------------------------------------------------------------


class _Fp8HybridMatmul(torch.autograd.Function):
    """JAX ``_fp8_hybrid_matmul`` (:189-243): ``x [..., K] @ w [K, N]``
    with both operands e4m3 at the given scales; the backward quantizes
    the incoming gradient to e5m2 at its current scale and forms ``dx = g
    w^T`` and ``dw = x^T g`` as fp8 products, from the saved e4m3
    operands."""

    @staticmethod
    def forward(ctx, x, w, x_scale, w_scale, preferred, over=None):
        qx, qw, out = _hybrid_forward(x, w, x_scale, w_scale, preferred)
        ctx.save_for_backward(qx, qw, x_scale, w_scale)
        ctx.x_shape, ctx.x_dtype, ctx.w_dtype, ctx.over = x.shape, x.dtype, w.dtype, over
        return out

    @staticmethod
    def backward(ctx, g):
        qx, qw, x_scale, w_scale = ctx.saved_tensors
        g2 = _flat(g)
        amax = _amax(g2)
        if ctx.over is not None:
            # the global gradient's amax (a gang's collective in the backward,
            # issued in the same order on every rank)
            from ..parallel import collectives

            amax = collectives.pmax(amax, ctx.over[1], ctx.over[0])
        g_scale = _over(E5M2_MAX, torch.clamp_min(amax, 1e-12))
        dx, dw = _hybrid_backward(g2, qx, qw, x_scale, w_scale, g_scale, ctx.x_shape,
                                  ctx.x_dtype, ctx.w_dtype)
        return dx, dw, None, None, None, None


def _hybrid_forward(x, w, x_scale, w_scale, preferred):
    qx = saturate_cast(_flat(x), x_scale, E4M3_MAX, torch.float8_e4m3fn)
    qw = saturate_cast(w, w_scale, E4M3_MAX, torch.float8_e4m3fn)
    out = fp8_mm(qx, qw, x_scale * w_scale, preferred)
    return qx, qw, out.reshape(*x.shape[:-1], w.shape[1])


def _hybrid_backward(g2, qx, qw, x_scale, w_scale, g_scale, x_shape, x_dtype, w_dtype):
    qg = saturate_cast(g2, g_scale, E5M2_MAX, torch.float8_e5m2)
    dx = fp8_mm(qg, qw.t(), g_scale * w_scale, x_dtype).reshape(x_shape)
    # dw^T = g^T x as [N, K] row-major, so the weight's gradient (the
    # transpose of this [K, N] operand's) comes out contiguous
    dw = fp8_mm(qg.t(), qx, x_scale * g_scale, w_dtype).t()
    return dx, dw


class _RanksHybridMatmul(torch.autograd.Function):
    """:class:`_Fp8HybridMatmul` of every rank of a virtual group at once
    (``parallel/virtual.py``): the activations' amax and, in the backward
    (which a virtual world runs once for every rank), the gradients' amax
    maxed over the group's ranks in their order."""

    @staticmethod
    def forward(ctx, preferred, *args):
        xs, ws, w_scales = args[0::3], args[1::3], args[2::3]
        amax = _amax(xs[0])
        for x in xs[1:]:
            amax = torch.maximum(amax, _amax(x))
        x_scale = _over(E4M3_MAX, torch.clamp_min(amax, 1e-12))
        outs, saved = [], []
        for x, w, w_scale in zip(xs, ws, w_scales):
            qx, qw, out = _hybrid_forward(x, w, x_scale, w_scale, preferred)
            outs.append(out)
            saved += [qx, qw, w_scale]
        ctx.save_for_backward(x_scale, *saved)
        ctx.meta = [(x.shape, x.dtype, w.dtype) for x, w in zip(xs, ws)]
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        x_scale, *saved = ctx.saved_tensors
        g2s = [_flat(g) for g in gs]
        amax = _amax(g2s[0])
        for g2 in g2s[1:]:
            amax = torch.maximum(amax, _amax(g2))
        g_scale = _over(E5M2_MAX, torch.clamp_min(amax, 1e-12))
        grads = [None]
        for i, (g2, (x_shape, x_dtype, w_dtype)) in enumerate(zip(g2s, ctx.meta)):
            qx, qw, w_scale = saved[3 * i:3 * i + 3]
            dx, dw = _hybrid_backward(g2, qx, qw, x_scale, w_scale, g_scale, x_shape, x_dtype,
                                      w_dtype)
            grads += [dx, dw, None]
        return tuple(grads)


def _ranks_hybrid(members: list) -> list:
    """The ``call`` exchange of :func:`fp8_delayed_dot` on a virtual mesh:
    each member's ``(x, w, w_scale, preferred)``."""
    preferred = members[0][3]
    args = [t for x, w, w_scale, _ in members for t in (x, w, w_scale)]
    return list(_RanksHybridMatmul.apply(preferred, *args))


def fp8_delayed_dot(x, w, w_meta: Fp8Meta, *, preferred_element_type=None):
    """The delayed-scaling product (JAX :245): the weight ``w [K, N]`` at
    its history-derived scale, the activation current-scaled, the
    backward HYBRID e5m2.  Under ``precision.fp8_amax_over`` (the train
    step under a sharding plan) the activation's and the gradient's amax
    are the global tensors'; on a virtual mesh every rank's product runs
    as one (:class:`_RanksHybridMatmul`)."""
    pet = preferred_element_type or x.dtype
    w_scale = w_meta.scale.float()
    over = amax_axes()
    if over is not None and getattr(over[0], "is_virtual", False):
        return over[0].collective("call", (x, w, w_scale, pet), over[1], fn=_ranks_hybrid)
    x_scale = _over(E4M3_MAX, torch.clamp_min(global_amax(x), 1e-12))
    return _Fp8HybridMatmul.apply(x, w, x_scale, w_scale, pet, over)


class _StraightThrough(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, rounded):
        return rounded

    @staticmethod
    def backward(ctx, g):
        return g, None


def fp8_fake_quantize(t: torch.Tensor, fp8_max: float = E4M3_MAX) -> torch.Tensor:
    """Quantize-dequantize through e4m3 in ``t``'s dtype (JAX :258), at the
    global tensor's amax under ``precision.fp8_amax_over``; the gradient
    passes straight through, as JAX's casts do."""
    t32 = t.detach().float()
    amax = t32.abs().amax()
    over = amax_axes()
    if over is not None:
        # the global tensor's (a tp slice, a sequence shard of the ring)
        from ..parallel import collectives

        amax = collectives.pmax(amax, over[1], over[0])
    scale = _over(fp8_max, torch.clamp_min(amax, 1e-12))
    q = torch.clamp(t32 * scale, -fp8_max, fp8_max).to(torch.float8_e4m3fn)
    return _StraightThrough.apply(t, (q.float() / scale).to(t.dtype))
