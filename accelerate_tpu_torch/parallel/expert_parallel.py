"""Expert parallelism (MoE) over the ``ep`` mesh dimension (mirrors
``accelerate_tpu/parallel/expert_parallel.py``).

Routing is the JAX package's, integer for integer: top-k softmax gating
(Switch / Mixtral), the k-th choices of every token queued behind all
(k-1)-th choices (the cumsum over ``[K * S, E]``), a per-expert capacity
rounded up to a multiple of 8 (it decides which tokens drop), the Switch
load-balancing loss and the router z-loss.  Dispatch and combine are the
dense GShard einsums over ``[S, E, C]``: on the card cuBLAS products, as
the JAX package computes them outside any Pallas kernel.

Two ways to split the experts over ``ep``:

- the model's (``models/mixtral.py``): each ep rank holds ``E / ep``
  experts and computes the same routing; it runs its experts' slice of
  ``[E, C, D]`` and combines its partial output, and the partials meet in
  a ``psum`` over ``ep``.  The tokens and the gating weights enter the
  experts through ``pbroadcast``, so their gradients are summed over the
  ranks; the router losses are each rank's own, whole (the column / row
  pattern of tensor parallelism; JAX lets GSPMD insert the all_to_alls).
- :func:`expert_parallel_apply`: the explicit exchange (JAX ``_ep_body``):
  grouped tokens capacity-sharded over ``ep`` go expert-sharded through
  one ``all_to_all`` and back through another, for expert bodies that are
  not one einsum.

:data:`MOE_EP_RULES` shards each expert leaf's dimension 0 over ``ep``
(the port's expert leaves keep the JAX layout, ``[E, d, f]`` /
``[E, f, d]``; the rules match the JAX paths the port's names map to).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..parallelism_config import PartitionSpec as P
from . import collectives as C


class RoutingResult(NamedTuple):
    """Dense dispatch / combine tensors and the router's losses.

    dispatch: ``[S, E, C]`` bool: token s goes to expert e at slot c.
    combine:  ``[S, E, C]`` f32: the gating weight of that slot.
    aux_loss: scalar: Switch load balancing (1.0 when uniform).
    z_loss:   scalar: the router logits' magnitude."""

    dispatch: torch.Tensor
    combine: torch.Tensor
    aux_loss: torch.Tensor
    z_loss: torch.Tensor


def expert_capacity(num_tokens: int, num_experts: int, top_k: int, capacity_factor: float) -> int:
    """Per-expert capacity ``C = ceil(S * k / E * factor)``, rounded up to a
    multiple of 8, never below 8 (JAX :61)."""
    raw = int(math.ceil(num_tokens * top_k / num_experts * capacity_factor))
    return max(8, int(math.ceil(raw / 8)) * 8)


def top_k_choices(probs: torch.Tensor, top_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last dimension: the k largest values in
    descending order, ties to the lower index (a stable sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :top_k], idx[..., :top_k]


def router_losses(router_logits: torch.Tensor, first_choice: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(aux, z): the Switch loss ``E * sum_e f_e * p_e`` (``f_e`` the share
    of tokens whose first choice is e, ``p_e`` the mean router
    probability) and ``mean(logsumexp(logits)^2)``."""
    logits = router_logits.float()
    e = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    f = torch.nn.functional.one_hot(first_choice, e).float().mean(dim=0)
    aux = e * torch.sum(f * probs.mean(dim=0))
    z = torch.square(torch.logsumexp(logits, dim=-1)).mean()
    return aux, z


def top_k_routing(router_logits: torch.Tensor, top_k: int, capacity: int, *,
                  normalize_weights: bool = True, rows=None,
                  loss_logits=None) -> RoutingResult:
    """Capacity-constrained top-k routing of ``router_logits`` ``[S, E]``
    (JAX :68): tokens beyond an expert's capacity are dropped (zero
    combine weight: the residual carries them).  The queue positions are
    the whole ``S``'s; ``rows`` (a slice of ``S``) keeps the dispatch and
    combine of those tokens alone (a data-parallel rank's rows of a routing
    gathered over the batch).  The losses are the whole ``S``'s, computed
    on ``loss_logits`` where given (the same values: under ep the logits
    before their ``pbroadcast``, so each rank's losses stay its own)."""
    s, e = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    gate_vals, gate_idx = top_k_choices(probs, top_k)                    # [S, K]
    if normalize_weights:
        gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    # slot-major priority: every token's first choice before any second
    assign = torch.nn.functional.one_hot(gate_idx.t(), e).to(torch.int32)  # [K, S, E]
    flat = assign.reshape(top_k * s, e)
    position = torch.cumsum(flat, dim=0, dtype=torch.int32) - flat
    position = (position * flat).sum(dim=-1).reshape(top_k, s).t()       # [S, K]
    aux, z = router_losses(router_logits if loss_logits is None else loss_logits,
                           gate_idx[:, 0])
    if rows is not None:
        gate_vals, gate_idx, position = gate_vals[rows], gate_idx[rows], position[rows]
    # a dropped choice's slot is one past the last, cut off below; a
    # token's k choices are k different experts, so no two share an entry
    slot = torch.clamp(position, max=capacity).long()
    n = gate_idx.shape[0]
    token = torch.arange(n, device=gate_idx.device)[:, None].expand(n, top_k)
    index = (token, gate_idx, slot)
    dispatch = torch.zeros(n, e, capacity + 1, dtype=torch.bool, device=gate_idx.device)
    dispatch = dispatch.index_put(index, torch.ones((), dtype=torch.bool,
                                                    device=gate_idx.device))
    combine = torch.zeros(n, e, capacity + 1, dtype=gate_vals.dtype, device=gate_vals.device)
    combine = combine.index_put(index, gate_vals)
    return RoutingResult(dispatch[..., :capacity], combine[..., :capacity], aux, z)


def moe_dispatch(x: torch.Tensor, routing: RoutingResult) -> torch.Tensor:
    """Tokens into per-expert batches: ``[S, D]`` -> ``[E, C, D]``."""
    return torch.einsum("sec,sd->ecd", routing.dispatch.to(x.dtype), x)


def moe_combine(expert_out: torch.Tensor, routing: RoutingResult) -> torch.Tensor:
    """The weighted scatter back: ``[E, C, D]`` -> ``[S, D]``."""
    return torch.einsum("sec,ecd->sd", routing.combine.to(expert_out.dtype), expert_out)


# ---------------------------------------------------------------------------
# the explicit exchange
# ---------------------------------------------------------------------------


def expert_parallel_apply(mesh, expert_fn: Callable, x_grouped: torch.Tensor, *,
                          axis_name: str = "ep") -> torch.Tensor:
    """Per-expert compute on grouped tokens with explicit all_to_alls (JAX
    :146).  ``x_grouped``: this rank's block ``[E, C / ep, D]`` of the
    capacity-sharded ``[E, C, D]``; ``expert_fn(global expert indices [E /
    ep], batch [E / ep, C, D]) -> [E / ep, C, D]``.  Returns this rank's
    block of the output, laid out as the input.  Differentiable (each
    exchange's backward is the inverse one)."""
    mesh = C._mesh(mesh)
    if C.axis_size(axis_name, mesh) == 1:
        return expert_fn(torch.arange(x_grouped.shape[0], device=x_grouped.device), x_grouped)
    local = C.all_to_all(x_grouped, axis_name, split_axis=0, concat_axis=1, mesh=mesh)
    e_local = local.shape[0]
    first = C.axis_index(axis_name, mesh) * e_local
    out = expert_fn(torch.arange(first, first + e_local, device=local.device), local)
    return C.all_to_all(out, axis_name, split_axis=1, concat_axis=0, mesh=mesh)


# ---------------------------------------------------------------------------
# the expert leaves' sharding rules
# ---------------------------------------------------------------------------

# expert leaves carry a leading expert dimension -> "ep"; their feature
# dimension follows Megatron's column / row layout (JAX :182)
MOE_EP_RULES: list = [
    (r"experts/(gate_proj|up_proj)$", P("ep", None, "tp")),
    (r"experts/down_proj$", P("ep", "tp", None)),
    (r"router/kernel$", P()),   # the router stays whole: it is tiny
]


def get_moe_rules() -> list:
    """The EP + TP rule table of MoE blocks: :data:`MOE_EP_RULES` ahead of
    the dense transformer table, so the expert patterns win (JAX :189)."""
    from .sharding import TRANSFORMER_TP_RULES

    return MOE_EP_RULES + TRANSFORMER_TP_RULES
