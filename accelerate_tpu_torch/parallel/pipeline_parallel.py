"""Pipeline parallelism: the GPipe microbatch schedule over a ``pp`` mesh
dimension (mirrors ``accelerate_tpu/parallel/pipeline_parallel.py``).

The model's homogeneous decoder layers are stacked on a leading layer
axis (:func:`stack_layer_params`) and split over ``pp``: stage ``s`` holds
layers ``[s * L / pp, (s + 1) * L / pp)`` (:func:`stage_slice`) and runs
them in turn.  The schedule (:func:`_gpipe`) runs ``num_microbatches + pp
- 1`` ticks on every stage: at tick ``t`` stage ``s`` works microbatch
``t - s``, then hands its output to stage ``s + 1`` in one ``ppermute``.
The last stage records the finished microbatches, and a masked ``psum``
replicates them to every stage, so the embedding and the head run outside
the pipeline on every stage (:class:`PipelinedModel`).

The bubble: a stage with no microbatch at a tick (``t - s`` outside
``[0, num_microbatches)``) runs no layer; it hands on its input
unchanged.  JAX computes its blocks on masked values there (an SPMD
program runs every tick's work everywhere); here those ticks launch
nothing, so a step runs each layer once per microbatch.

The backward is autograd through the schedule (JAX's grad of the
pipelined forward).  The collectives are differentiable
(``parallel/collectives.py``: ``ppermute`` permutes its gradient back, the
masked ``psum`` passes it through, the microbatches enter through
``pbroadcast``, whose backward sums the embedding's gradient over the
stages).  In a gang every rank must run the same exchanges in the same
order in the backward too, so every stage builds the same graph: each
tick's input is a select between the feed and the received buffer, and a
bubble tick's output is recorded through a select that keeps nothing,
as JAX's ``where``s do; autograd then reaches every tick's ``ppermute``
on every stage, in reverse tick order.  The last tick's hand-off, which
no stage reads, is not sent.

Bubble fraction ``(pp - 1) / (num_microbatches + pp - 1)``.
"""

from __future__ import annotations

import re
from typing import Callable, Optional

import torch

from . import collectives as C
from .virtual import module_replica


# ---------------------------------------------------------------------------
# stage-parameter surgery
# ---------------------------------------------------------------------------


def stack_layer_params(params: dict, num_layers: int,
                       prefix: str = "model.layers.") -> tuple[dict, dict]:
    """``(stacked, rest)``: the layers' tensors (``{prefix}{i}.<name>``)
    stacked on a new leading layer axis, keyed by ``<name>``, and the
    other tensors (JAX :52).  Raises unless there are ``num_layers``
    layers."""
    pattern = re.compile(re.escape(prefix) + r"(\d+)\.(.+)")
    layers: dict = {}
    rest = {}
    for name, t in params.items():
        m = pattern.fullmatch(name)
        if m:
            layers.setdefault(int(m.group(1)), {})[m.group(2)] = t
        else:
            rest[name] = t
    if len(layers) != num_layers:
        raise ValueError(f"expected {num_layers} '{prefix}*' layers, found {len(layers)}")
    keys = list(layers[0])
    stacked = {k: torch.stack([layers[i][k] for i in range(num_layers)]) for k in keys}
    return stacked, rest


def unstack_layer_params(stacked: dict, rest: dict, prefix: str = "model.layers.") -> dict:
    """The inverse of :func:`stack_layer_params` (checkpoint interchange,
    JAX :75)."""
    out = dict(rest)
    num_layers = next(iter(stacked.values())).shape[0]
    for i in range(num_layers):
        for k, t in stacked.items():
            out[f"{prefix}{i}.{k}"] = t[i]
    return out


def stage_slice(stacked: dict, pp: int, stage: int) -> dict:
    """Stage ``stage``'s layers of a stacked tree, ``[L / pp, ...]`` views
    (what JAX's ``stage_sharding``, :84, pins to each stage)."""
    num_layers = next(iter(stacked.values())).shape[0]
    if num_layers % pp:
        raise ValueError(f"num_layers {num_layers} not divisible by pp {pp}")
    per = num_layers // pp
    return {k: t[stage * per:(stage + 1) * per] for k, t in stacked.items()}


# ---------------------------------------------------------------------------
# the GPipe schedule
# ---------------------------------------------------------------------------


def _gpipe(stage_params: dict, x_mbs: torch.Tensor, block_fn: Callable, mesh, axis_name: str,
           remat: bool) -> torch.Tensor:
    """One stage's program (JAX ``_gpipe_body``, :94).  ``stage_params``:
    this stage's layers ``[L / pp, ...]``; ``x_mbs``: every microbatch
    ``[M, mb, T, H]`` (the first stage reads them).  Returns the finished
    microbatches ``[M, mb, T, H]`` on every stage."""
    pp = C.axis_size(axis_name, mesh)
    rank = C.axis_index(axis_name, mesh)
    num_mb = x_mbs.shape[0]
    layers = next(iter(stage_params.values())).shape[0] if stage_params else 0
    ticks = num_mb + pp - 1
    perm = [(i, i + 1) for i in range(pp - 1)]
    dev = x_mbs.device
    first = torch.tensor(rank == 0, device=dev)
    keep_none = torch.tensor(False, device=dev)

    def stage_forward(h):
        for i in range(layers):
            lp = {k: t[i] for k, t in stage_params.items()}
            if remat:
                from torch.utils.checkpoint import checkpoint

                names = list(lp)

                def call(h, *ws, names=names):
                    return block_fn(dict(zip(names, ws)), h)

                h = checkpoint(call, h, *lp.values(), use_reentrant=False)
            else:
                h = block_fn(lp, h)
        return h

    buf = torch.zeros_like(x_mbs[0])
    # sink: the bubble ticks' outputs through a select that keeps none of
    # them (zeros), so their hand-offs stay in the graph
    sink = torch.zeros_like(x_mbs[0])
    rec = []
    for t in range(ticks):
        m = t - rank
        x = torch.where(first, x_mbs[min(t, num_mb - 1)], buf)
        if 0 <= m < num_mb:
            y = stage_forward(x)
            rec.append(y)
        else:
            y = x
            sink = torch.where(keep_none, y, sink)
        if t < ticks - 1:
            buf = C.ppermute(y, axis_name, perm, mesh)
    rec[0] = rec[0] + sink
    outs = torch.stack(rec)
    last = torch.tensor(rank == pp - 1, device=dev)
    return C.psum(torch.where(last, outs, torch.zeros_like(outs)), axis_name, mesh)


def pipeline_blocks(stacked_params: dict, x: torch.Tensor, block_fn: Callable, mesh=None, *,
                    num_microbatches: int, axis_name: str = "pp",
                    remat: bool = False) -> torch.Tensor:
    """Run stacked layers as a ``pp``-stage GPipe pipeline (JAX :143).
    ``stacked_params``: ``{name: [L, ...]}`` (this rank runs its stage's
    slice); ``x``: ``[B, T, H]`` on every rank; ``block_fn(layer_params,
    h) -> h``.  Returns ``[B, T, H]`` on every rank.  Differentiable: the
    backward runs the schedule in reverse."""
    mesh = C._mesh(mesh)
    pp = C.axis_size(axis_name, mesh)
    num_layers = next(iter(stacked_params.values())).shape[0]
    if num_layers % pp:
        raise ValueError(f"num_layers {num_layers} not divisible by pp {pp}")
    return _pipeline(stage_slice(stacked_params, pp, C.axis_index(axis_name, mesh)), x,
                     block_fn, mesh, num_microbatches, axis_name, remat)


def _pipeline(stage_params, x, block_fn, mesh, num_microbatches, axis_name, remat):
    batch = x.shape[0]
    if batch % num_microbatches:
        raise ValueError(f"batch {batch} not divisible by num_microbatches {num_microbatches}")
    x_mbs = x.reshape(num_microbatches, batch // num_microbatches, *x.shape[1:])
    x_mbs = C.pbroadcast(x_mbs, axis_name, mesh)
    out = _gpipe(stage_params, x_mbs, block_fn, mesh, axis_name, remat)
    return out.reshape(batch, *x.shape[1:])


# ---------------------------------------------------------------------------
# prepare_pipeline: the one-call API
# ---------------------------------------------------------------------------


class PipelinedModel:
    """A causal LM run as a GPipe pipeline over ``pp`` (JAX :211):
    ``pmodel(input_ids) -> f32 logits [B, T, V]`` on every stage.  The
    embedding, final norm and head run outside the pipeline on every
    stage; each stage holds its own layers (``stacked``, leaves of their
    own: train them with any optimizer over ``parameters()``) and the rest
    (``rest``: the model's tensors).  The model's own layers stay as they
    were until :meth:`merged_model` (``Accelerator.unwrap_model``) copies
    the trained ones back.  Any model of the ``LlamaForCausalLM`` skeleton
    (its ``block_cls`` layers, unrolled)."""

    def __init__(self, model, params: Optional[dict] = None, mesh=None, *,
                 num_microbatches: int = 8, axis_name: str = "pp",
                 remat: Optional[bool] = None):
        cfg = model.config
        if getattr(cfg, "scan_layers", False):
            raise ValueError("prepare_pipeline needs the unrolled layer stack; convert with "
                             "unstack_layer_params and scan_layers=False")
        self.model = model
        self.config = cfg
        self.mesh = C._mesh(mesh)
        sizes = C.mesh_sizes(self.mesh)
        if any(sizes.get(a, 1) > 1 for a in ("tp", "cp", "sp")):
            raise NotImplementedError("pipeline parallelism composed with tp / cp / sp is not "
                                      "ported yet (ROADMAP item A13h.6)")
        self.axis_name = axis_name
        self.num_microbatches = num_microbatches
        # the config's activation checkpointing unless overridden: a
        # config that fitted un-pipelined keeps its remat
        self.remat = getattr(cfg, "remat", False) if remat is None else remat
        if params is None:
            params = dict(model.named_parameters())
        stacked, rest = stack_layer_params(params, cfg.num_hidden_layers)
        self.pp = C.axis_size(axis_name, self.mesh)
        self.stage = C.axis_index(axis_name, self.mesh)
        with torch.no_grad():
            self.stacked = {k: t.detach().clone().requires_grad_(t.is_floating_point())
                            for k, t in stage_slice(stacked, self.pp, self.stage).items()}
        del stacked
        self.rest = rest
        # modules of this pipeline's own (functional_call swaps a module's
        # tensors, and the ranks of a virtual world take turns mid-call)
        self._block = module_replica(model.model.layers[0])
        self._norm = module_replica(model.model.norm)
        self._head = module_replica(model.lm_head)

    def parameters(self) -> list:
        """This stage's layer tensors, then the rest."""
        return list(self.stacked.values()) + list(self.rest.values())

    def _block_fn(self, positions):
        block, cos, sin = self._block, self.model.rope_cos, self.model.rope_sin

        def fn(layer_params, h):
            return torch.func.functional_call(block, layer_params, (h, positions, cos, sin))

        return fn

    def forward(self, input_ids, stacked: Optional[dict] = None,
                rest: Optional[dict] = None) -> torch.Tensor:
        """f32 logits of ``input_ids`` ``[B, T]`` (with ``stacked`` / ``rest``
        in place of the held tensors, as a train step passes its leaves)."""
        cfg = self.config
        stacked = self.stacked if stacked is None else stacked
        rest = self.rest if rest is None else rest
        b, t = input_ids.shape
        if b % self.num_microbatches:
            raise ValueError(f"batch {b} not divisible by num_microbatches "
                             f"{self.num_microbatches}")
        positions = torch.arange(t, device=input_ids.device).expand(
            b // self.num_microbatches, t)
        emb = rest["model.embed_tokens.weight"]
        x = torch.nn.functional.embedding(input_ids, emb).to(cfg.dtype)
        x = _pipeline(stacked, x, self._block_fn(positions), self.mesh, self.num_microbatches,
                      self.axis_name, self.remat)
        x = torch.func.functional_call(self._norm, {"weight": rest["model.norm.weight"]}, (x,))
        head = emb if cfg.tie_word_embeddings else rest["lm_head.weight"]
        return torch.func.functional_call(self._head, {"weight": head}, (x,))

    __call__ = forward

    def merged_params(self) -> dict:
        """The whole, unstacked tensors (every stage's layers gathered over
        ``pp``; every rank calls this together)."""
        whole = {k: C.all_gather(t.detach().contiguous(), self.axis_name, axis=0, mesh=self.mesh)
                 for k, t in self.stacked.items()}
        return unstack_layer_params(whole, {k: v.detach() for k, v in self.rest.items()})

    def merged_model(self):
        """The model, its tensors set to this pipeline's (:meth:`merged_params`
        copied in: the stages' trained layers and the rest); every rank
        calls this together."""
        merged = self.merged_params()
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(merged[name])
        return self.model


def prepare_pipeline(model, params: Optional[dict] = None, mesh=None, *,
                     num_microbatches: int = 8, axis_name: str = "pp",
                     remat: Optional[bool] = None) -> PipelinedModel:
    """The one-call pipeline wrap (JAX :290); ``mesh`` defaults to the
    newest accelerator state's, ``params`` to the model's own."""
    return PipelinedModel(model, params, mesh, num_microbatches=num_microbatches,
                          axis_name=axis_name, remat=remat)


__all__ = ["PipelinedModel", "pipeline_blocks", "prepare_pipeline", "stack_layer_params",
           "stage_slice", "unstack_layer_params"]
