"""Mixtral-class sparse-MoE decoder (mirrors ``accelerate_tpu/models/
mixtral.py``): the Llama skeleton (``models/llama.py``: embedding, rotary
attention, norms, the causal-LM head, the dense and paged caches, the
scanned stack) with each block's MLP replaced by a top-k routed mixture of
SwiGLU experts.

- The router (``block_sparse_moe.gate``, HF's name, ``[E, D]``) is f32 and
  runs on the f32 tokens, as JAX's f32 ``Dense``; routing, dispatch and
  combine are ``parallel/expert_parallel.py``'s (GShard's dense einsums).
- The experts (``block_sparse_moe.experts.{gate,up,down}_proj``) are
  stacked ``[E, D, F]`` / ``[E, D, F]`` / ``[E, F, D]``, the JAX layout.
  They are stored in the config's dtype, as every weight of the port's
  Llama (JAX stores them f32 and casts them to the compute dtype at use:
  the products read the same bf16 values).
- Under ``ep`` (a train state whose expert leaves hold ``E / ep`` experts
  a rank: ``parallel/sharding.py``'s ``MOE_EP_RULES``) each rank runs its
  experts' slice and the partial outputs meet in a ``psum`` over ``ep``
  (``parallel/expert_parallel.py``'s module doc).
- Under an ambient mesh whose batch axes (``dcn``, ``dp_replicate``,
  ``dp_shard``) have several ranks, each rank holds its rows of the global
  batch, and routing is the global batch's, as JAX's GSPMD routing is: the
  router logits are gathered over those axes (their gradient
  reduce-scattered back), every rank routes all tokens alike (the
  capacity and the queue order of the whole batch) and dispatches its own
  rows.  Mixtral under tp, cp or sp, and its cached decoding under such a
  mesh, are not ported (ROADMAP A13h.5).

JAX ``sow``s each layer's router losses into the ``intermediates``
collection; here :func:`collect_router_losses` opens a collector for the
calling thread (a virtual rank is a thread) that each MoE layer appends
its ``(aux, z)`` to, and :func:`make_mixtral_loss_fn` adds their means
over the layers, weighted by the config's coefficients.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional

import torch
from torch import nn

from ..parallel import collectives as C
from ..parallel.expert_parallel import (
    expert_capacity,
    moe_combine,
    moe_dispatch,
    top_k_routing,
)
from .llama import (
    LlamaAttention,
    LlamaConfig,
    LlamaForCausalLM,
    ParallelForward,
    RMSNorm,
    _apply,
    causal_lm_loss,
)


@dataclasses.dataclass(frozen=True)
class MixtralConfig(LlamaConfig):
    num_local_experts: int = 8
    num_experts_per_tok: int = 2
    capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.02
    router_z_loss_coef: float = 1e-3

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=128, num_local_experts=4, num_experts_per_tok=2,
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def mixtral_8x7b(cls, **kw):
        defaults = dict(
            vocab_size=32000, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
            max_position_embeddings=32768, rope_theta=1e6,
            num_local_experts=8, num_experts_per_tok=2,
        )
        defaults.update(kw)
        return cls(**defaults)


# -- the router losses' collector (JAX's sow channel) --------------------------

_SOWN = threading.local()


@contextlib.contextmanager
def collect_router_losses():
    """A dict ``{"router_aux_loss": [...], "router_z_loss": [...]}`` every
    MoE layer run by this thread inside the block appends its losses to,
    in layer order; an enclosing collector receives them too."""
    saved = getattr(_SOWN, "sink", None)
    sink = {"router_aux_loss": [], "router_z_loss": []}
    _SOWN.sink = sink
    try:
        yield sink
    finally:
        _SOWN.sink = saved
        if saved is not None:
            for key, values in sink.items():
                saved[key].extend(values)


def _sow(routing_aux, routing_z) -> None:
    sink = getattr(_SOWN, "sink", None)
    if sink is not None:
        sink["router_aux_loss"].append(routing_aux)
        sink["router_z_loss"].append(routing_z)


class MixtralExperts(nn.Module):
    """Stacked SwiGLU experts, ``[E, D, F]`` / ``[E, F, D]`` (a rank's
    ``E / ep`` of them under ``ep``); a batch ``[E, C, D]`` through each
    expert's weights (batched cuBLAS products on the card)."""

    def __init__(self, config: MixtralConfig):
        super().__init__()
        cfg = config
        e, d, f = cfg.num_local_experts, cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Parameter(torch.empty(e, d, f, dtype=cfg.dtype))
        self.up_proj = nn.Parameter(torch.empty(e, d, f, dtype=cfg.dtype))
        self.down_proj = nn.Parameter(torch.empty(e, f, d, dtype=cfg.dtype))

    def forward(self, grouped):
        dt = grouped.dtype
        gate = torch.bmm(grouped, self.gate_proj.to(dt))
        up = torch.bmm(grouped, self.up_proj.to(dt))
        return torch.bmm(torch.nn.functional.silu(gate) * up, self.down_proj.to(dt))


class MixtralSparseMoE(nn.Module):
    """Top-k routed expert MLP (JAX :67): the f32 router on the f32
    tokens, capacity routing, the dense dispatch, the experts, the
    combine."""

    def __init__(self, config: MixtralConfig):
        super().__init__()
        self.config = config
        self.gate = nn.Linear(config.hidden_size, config.num_local_experts, bias=False,
                              dtype=torch.float32)
        self.experts = MixtralExperts(config)

    def forward(self, x):
        from ..state import ambient_mesh

        cfg = self.config
        b, t, d = x.shape
        tokens = x.reshape(b * t, d)
        logits = torch.nn.functional.linear(tokens.float(), self.gate.weight.float())
        mesh = ambient_mesh()[0]
        dp = batch_axes(mesh)
        rows = None
        if dp:
            # the global batch's queue: every rank's logits, in row order;
            # the dispatch and combine are this rank's rows alone
            n = tokens.shape[0]
            rows = slice(C.axis_index(dp, mesh) * n, (C.axis_index(dp, mesh) + 1) * n)
            logits = C.all_gather(logits.contiguous(), dp, axis=0, mesh=mesh)
        capacity = expert_capacity(logits.shape[0], cfg.num_local_experts,
                                   cfg.num_experts_per_tok, cfg.capacity_factor)
        e_local = self.experts.gate_proj.shape[0]
        split = e_local != cfg.num_local_experts
        if split and (mesh is None or C.axis_size("ep", mesh) * e_local != cfg.num_local_experts):
            raise ValueError(f"{e_local} of {cfg.num_local_experts} experts a rank needs an "
                             f"ambient mesh whose ep axis has "
                             f"{cfg.num_local_experts // max(e_local, 1)} ranks")
        # under ep the gating weights and the tokens are read by every ep
        # rank (their gradients summed over ep); the router losses are this
        # rank's, whole
        routing = top_k_routing(C.pbroadcast(logits, "ep", mesh) if split else logits,
                                cfg.num_experts_per_tok, capacity, rows=rows,
                                loss_logits=logits)
        _sow(routing.aux_loss, routing.z_loss)
        local = routing
        if split:
            tokens = C.pbroadcast(tokens, "ep", mesh)
            lo = C.axis_index("ep", mesh) * e_local
            local = routing._replace(dispatch=routing.dispatch[:, lo:lo + e_local],
                                     combine=routing.combine[:, lo:lo + e_local])
        grouped = moe_dispatch(tokens, local).to(cfg.dtype)              # [E, C, D]
        out = self.experts(grouped)
        if not split:
            y = moe_combine(out, local)
        else:
            # the partial outputs in f32, summed over ep and rounded once: a
            # token's (at most k) products add exactly as in the one-rank
            # combine, so the layer's output is the unsharded one's
            weights = local.combine.to(out.dtype).float()
            y = C.psum(moe_combine(out.float(), local._replace(combine=weights)), "ep", mesh)
        return y.reshape(b, t, d).to(cfg.dtype)


def is_expert_leaf(name: str) -> bool:
    """Whether parameter ``name`` is a stacked expert leaf (its dimension 0
    the experts: split over ``ep``)."""
    return ".experts." in name


def batch_axes(mesh) -> tuple:
    """The batch axes of ``mesh`` with more than one rank (none without a
    mesh)."""
    if mesh is None:
        return ()
    sizes = C.mesh_sizes(mesh)
    return tuple(a for a in ("dcn", "dp_replicate", "dp_shard") if sizes.get(a, 1) > 1)


class MixtralBlock(nn.Module):
    """The Llama attention (cache arguments included) with the sparse-MoE
    MLP (JAX :114)."""

    def __init__(self, config: MixtralConfig):
        super().__init__()
        cfg = config
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype)
        self.self_attn = LlamaAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype)
        self.block_sparse_moe = MixtralSparseMoE(cfg)

    def forward(self, x, positions, cos, sin, cache=None, cache_write_mask=None,
                paged_write=None, attn_implementation=None, segment_ids=None,
                adapter_ids=None, lora=None, par: Optional[ParallelForward] = None):
        if adapter_ids is not None:
            raise ValueError("the Mixtral block takes no adapters (multi-tenant LoRA is the "
                             "Llama block's)")
        attn = self.self_attn(self.input_layernorm(x, par), positions, cos, sin, cache,
                              cache_write_mask, paged_write, attn_implementation,
                              segment_ids, par=par)
        new_cache = None
        if cache is not None:
            attn, new_cache = attn
        h = x + attn
        out = h + self.block_sparse_moe(self.post_attention_layernorm(h, par))
        return (out, new_cache) if cache is not None else out


class MixtralForCausalLM(LlamaForCausalLM):
    """The MoE decoder LM (JAX :135): the Llama skeleton with
    :class:`MixtralBlock` layers.  ``forward`` is the Llama's; the router
    losses go to the collector of :func:`collect_router_losses`."""

    block_cls = MixtralBlock

    def _init_std(self, name: str, p: torch.Tensor) -> float:
        """The Llama's rule; a stacked expert ``[E, in, out]`` has fan-in
        ``in``, and its ``down_proj`` writes into the residual stream."""
        if not is_expert_leaf(name):
            return super()._init_std(name, p)
        std = 1.0 / math.sqrt(p.shape[-2])
        if name.endswith("down_proj"):
            std *= 1.0 / (2 * self.config.num_hidden_layers)
        return std

    def parallel_forward(self, t_local: int, impl: str, cached: bool = False,
                         adapter_ids=None) -> Optional[ParallelForward]:
        from ..state import ambient_mesh

        if cached:
            # cached decoding runs on whole weights (forward refuses it
            # over data-parallel ranks)
            return None
        mesh = ambient_mesh()[0]
        sizes = C.mesh_sizes(mesh) if mesh is not None else {}
        split = [a for a in ("tp", "cp", "sp") if sizes.get(a, 1) > 1]
        if split:
            raise NotImplementedError(f"Mixtral under {' / '.join(split)} is not ported yet "
                                      "(ROADMAP item A13h.5)")
        return super().parallel_forward(t_local, impl, adapter_ids=adapter_ids)

    def forward(self, input_ids, *args, cache=None, **kwargs):
        from ..state import ambient_mesh

        if cache is not None and batch_axes(ambient_mesh()[0]):
            raise NotImplementedError("cached Mixtral decoding over several data-parallel "
                                      "ranks is not ported yet (ROADMAP item A13h.5)")
        return super().forward(input_ids, *args, cache=cache, **kwargs)


def make_mixtral_loss_fn(model: MixtralForCausalLM):
    """``loss_fn(params, batch)``: the causal-LM loss plus the router
    losses, each averaged over the layers and weighted by its coefficient
    (JAX :145).  ``batch`` as :func:`~.llama.make_llama_loss_fn`'s
    unfused one."""
    cfg = model.config

    def loss_fn(params, batch):
        with collect_router_losses() as sown:
            logits = _apply(model, params, batch["input_ids"],
                            segment_ids=batch.get("segment_ids"))
        if "shift_labels" in batch:
            loss = causal_lm_loss(logits, batch["shift_labels"], shifted=True)
        else:
            loss = causal_lm_loss(logits, batch["labels"])
        if sown["router_aux_loss"]:
            loss = loss + cfg.router_aux_loss_coef * torch.stack(sown["router_aux_loss"]).mean()
        if sown["router_z_loss"]:
            loss = loss + cfg.router_z_loss_coef * torch.stack(sown["router_z_loss"]).mean()
        return loss

    loss_fn.fsdp_units = model.fsdp_units
    return loss_fn


def count_active_params(cfg: MixtralConfig) -> int:
    """Parameters a token touches (its top-k experts): the MFU count (JAX
    :182)."""
    dense = (
        cfg.vocab_size * cfg.hidden_size * (1 if cfg.tie_word_embeddings else 2)
        + cfg.num_hidden_layers * (
            cfg.hidden_size * cfg.head_dim * (cfg.num_attention_heads
                                              + 2 * cfg.num_key_value_heads)
            + cfg.num_attention_heads * cfg.head_dim * cfg.hidden_size
            + 2 * cfg.hidden_size
            + cfg.hidden_size * cfg.num_local_experts
        )
        + cfg.hidden_size
    )
    expert = (cfg.num_hidden_layers * cfg.num_experts_per_tok * 3 * cfg.hidden_size
              * cfg.intermediate_size)
    return dense + expert


__all__ = ["MixtralConfig", "MixtralExperts", "MixtralSparseMoE", "MixtralBlock",
           "MixtralForCausalLM", "collect_router_losses", "make_mixtral_loss_fn",
           "count_active_params", "is_expert_leaf"]
