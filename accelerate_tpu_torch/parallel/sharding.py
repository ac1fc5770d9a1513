"""The parameter-sharding plan: FSDP / ZeRO / HSDP as a spec per leaf
(mirrors ``accelerate_tpu/parallel/sharding.py``).

The plan is the JAX package's, decision for decision: which mesh axes
shard the parameters under a strategy (:func:`param_fsdp_axes`, cp
excluded), which dimension of each leaf they split (:func:`_spec_for_leaf`:
the largest free dimension the shard count divides, never below the tile,
nothing under ``min_weight_size``), and the optimizer state's plan, whose
mirrors of a parameter take the joint ``(dp_shard, cp)`` entry
(:func:`make_opt_state_sharding_plan`).  Leaves are keyed by the port's
parameter names and decided on the JAX package's layout of each leaf: a
JAX kernel is ``[in, out]`` where the port's weight is ``[out, in]`` (a
scanned stack's ``[L, in, out]`` against ``[L, out, in]``), so the rule
runs on the JAX shape and the spec comes back with its last two entries
swapped (``models/hf_interop.py:hf_llama_tensor_map``).  Names the Llama
key map does not know (a user's own tree) keep their layout.

The train step lays each sharded leaf out as equal contiguous ranges of
its row-major flatten (:class:`LeafLayout`): the -sr8 scale blocks run
over that flatten and the stochastic-rounding salts take the whole leaf's
size, so a rank's range updates bitwise as the whole leaf would.  The plan
says how many ways a leaf splits and over which axes; a range holds the
elements of one shard (a leaf the plan splits on its first dimension gets
exactly that shard).

Under ``tp > 1`` the plan applies the Megatron rules
(``TRANSFORMER_TP_RULES``, JAX ``_params_plan``): q / k / v, gate / up,
the embedding and ``lm_head`` split on their port dimension 0, o_proj and
down_proj on dimension 1.  The tp split is a real one: a rank holds its
slice of the leaf as a tensor (:func:`tp_shard`), the forward runs on it,
and the data-parallel ranges above lie over that slice's flatten.  A tp
slice whose -sr8 blocks are not whole blocks of the leaf's flatten (a
dimension-1 slice narrower than a block, or a slice of fewer elements)
is updated as ranges of the whole leaf's flatten over ``tp`` instead
(``LeafLayout.relay``), so every update stays bitwise the whole leaf's.

Under ``ep > 1`` the plan applies the MoE table (``expert_parallel.
MOE_EP_RULES`` ahead of the transformer table): each stacked expert leaf
splits its dimension 0 (the experts) over ``ep``, a real split as tp's
(``LeafLayout.model_axis``): a rank holds ``E / ep`` whole experts, a
contiguous range of the leaf's flatten, so the -sr / -sr8 blocks update
in place under the whole leaf's salts.
"""

from __future__ import annotations

import logging
import math
import re
from dataclasses import dataclass
from typing import Optional, Sequence

from ..models.hf_interop import hf_llama_key_map
from ..parallelism_config import ParallelismConfig, PartitionSpec
from ..utils.dataclasses import FullyShardedDataParallelPlugin, ShardingStrategy
from .collectives import mesh_sizes

logger = logging.getLogger(__name__)


def path_str(name: str) -> str:
    """The JAX param path of a port parameter name, ``/``-joined
    (``model.layers.0.self_attn.q_proj.weight`` ->
    ``layers_0/self_attn/q_proj/kernel``); other names with ``.`` as
    ``/``."""
    path = hf_llama_key_map(name) or name
    if path.startswith("params."):
        path = path[len("params."):]
    return path.replace(".", "/")


def _transposed(path: str, ndim: int) -> bool:
    """Whether the port's layout of the leaf is the JAX one with the last
    two axes swapped (a dense kernel)."""
    return path.endswith("/kernel") and ndim in (2, 3)


def _swap(seq, path: str):
    seq = list(seq)
    if _transposed(path, len(seq)):
        seq[-1], seq[-2] = seq[-2], seq[-1]
    return seq


def _axis_size(sizes: dict, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= sizes[a]
    return size


def _spec_for_leaf(path: str, shape: tuple, sizes: dict, fsdp_axes: tuple,
                   min_weight_size: int, tp_rules: Sequence) -> list:
    """The JAX rule on the JAX layout's ``shape``: tp rules first, then the
    largest free dimension the fsdp shard count divides whose shard keeps
    a tile (128 on the last dimension, 8 elsewhere), for leaves of at least
    ``min_weight_size`` elements."""
    ndim = len(shape)
    spec: list = [None] * ndim
    offset = 1 if "layers_scan" in path else 0
    for pattern, rule_spec in tp_rules:
        if re.search(pattern, path):
            for d, entry in enumerate(rule_spec):
                d += offset
                if d >= ndim or entry is None:
                    continue
                size = _axis_size(sizes, entry)
                if size > 1 and shape[d] % size == 0:
                    spec[d] = entry
                elif size > 1:
                    logger.warning(
                        "TP rule %r wants to shard dim %d of %s %s but %d %% %d != 0; replicating",
                        pattern, d, path, shape, shape[d], size,
                    )
            break
    fsdp_size = _axis_size(sizes, fsdp_axes)
    if fsdp_size > 1 and math.prod(shape) >= min_weight_size:
        def _tile_ok(d: int) -> bool:
            return shape[d] // fsdp_size >= (128 if d == ndim - 1 else 8)

        candidates = sorted(
            (d for d in range(ndim)
             if spec[d] is None and shape[d] % fsdp_size == 0 and _tile_ok(d)),
            key=lambda d: shape[d], reverse=True)
        if candidates:
            spec[candidates[0]] = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
    return spec


def resolve_sharding_strategy(fsdp_plugin: Optional[FullyShardedDataParallelPlugin],
                              parallelism_config: Optional[ParallelismConfig]) -> ShardingStrategy:
    """An explicit plugin's strategy; else FULL_SHARD when ``dp_shard`` is
    non-trivial, NO_SHARD otherwise."""
    if fsdp_plugin is not None:
        return fsdp_plugin.sharding_strategy
    cfg = parallelism_config or ParallelismConfig()
    return ShardingStrategy.FULL_SHARD if cfg.dp_shard_size > 1 else ShardingStrategy.NO_SHARD


def param_fsdp_axes(mesh, cfg: ParallelismConfig, strategy: ShardingStrategy) -> tuple:
    """The mesh axes parameters shard over under ``strategy``: the fsdp
    axes under FULL / HYBRID shard, cp excluded (the JAX ring keeps
    parameters cp-replicated; the optimizer state takes the joint axes);
    none under NO_SHARD / SHARD_GRAD_OP.  ``mesh`` is a ``DeviceMesh`` or
    a ``(names, shape)`` layout."""
    if strategy not in (ShardingStrategy.FULL_SHARD, ShardingStrategy.HYBRID_SHARD):
        return ()
    sizes = mesh_sizes(mesh)
    fsdp_axes = cfg.fsdp_dim_names or (("dp_shard",) if sizes.get("dp_shard", 1) > 1 else ())
    return tuple(a for a in fsdp_axes if a != "cp" and sizes.get(a, 1) > 1)


def _shape(leaf) -> tuple:
    if isinstance(leaf, (tuple, list)):
        return tuple(int(x) for x in leaf)
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


def make_sharding_plan(params: dict, mesh, parallelism_config: Optional[ParallelismConfig] = None,
                       fsdp_plugin: Optional[FullyShardedDataParallelPlugin] = None,
                       tp_rules: Optional[Sequence] = None) -> dict:
    """``{name: PartitionSpec}`` in the port's layout for a name -> leaf
    dict (tensors, ``meta`` tensors or shapes: nothing is read but
    shapes)."""
    cfg = parallelism_config or ParallelismConfig()
    sizes = mesh_sizes(mesh)
    tp_rules = list(tp_rules or [])
    strategy = resolve_sharding_strategy(fsdp_plugin, cfg)
    min_size = fsdp_plugin.min_weight_size if fsdp_plugin is not None else 2**12
    fsdp_axes = tuple(param_fsdp_axes(mesh, cfg, strategy))
    plan = {}
    for name, leaf in params.items():
        shape = _shape(leaf)
        if not shape:
            plan[name] = PartitionSpec()
            continue
        path = path_str(name)
        spec = _spec_for_leaf(path, tuple(_swap(shape, path)), sizes, fsdp_axes, min_size,
                              tp_rules)
        plan[name] = PartitionSpec(*_swap(spec, path))
    return plan


def _opt_axes(cfg: ParallelismConfig, sizes: dict, plugin) -> tuple:
    shard_opt = plugin is None or plugin.sharding_strategy != ShardingStrategy.NO_SHARD
    if not shard_opt:
        return ()
    return cfg.fsdp_dim_names or (("dp_shard",) if sizes.get("dp_shard", 1) > 1 else ())


def _mirror_spec(path: str, jax_shape: tuple, jax_param_spec: list, sizes: dict,
                 fsdp_axes: tuple, min_size: int) -> list:
    """The JAX optimizer-state rule for a leaf mirroring a parameter, on
    the JAX layout: the parameter's spec with its fsdp entry upgraded to
    the joint axes where they divide, or, for an unsharded parameter, the
    leaf rule over the joint axes."""
    param_axes = tuple(a for a in fsdp_axes if a != "cp")
    param_entry = (param_axes if len(param_axes) > 1 else param_axes[0]) if param_axes else None
    joint_entry = (tuple(fsdp_axes) if len(fsdp_axes) > 1 else fsdp_axes[0]) if fsdp_axes else None
    joint_size = _axis_size(sizes, fsdp_axes)
    if jax_param_spec and any(s is not None for s in jax_param_spec):
        spec = list(jax_param_spec)
        if joint_entry is not None and joint_entry != param_entry:
            for d, entry in enumerate(spec):
                if entry == param_entry and jax_shape[d] % joint_size == 0:
                    spec[d] = joint_entry
        return spec
    return _spec_for_leaf(path, jax_shape, sizes, fsdp_axes, min_size, [])


def make_opt_state_sharding_plan(opt_state_shapes: dict, params_plan: dict, mesh,
                                 parallelism_config: Optional[ParallelismConfig] = None,
                                 fsdp_plugin: Optional[FullyShardedDataParallelPlugin] = None
                                 ) -> dict:
    """The optimizer state's plan (the ZeRO-1/2 axis): ``opt_state_shapes``
    maps ``"<field>/<param name>"`` (a leaf of a per-parameter field, as
    :func:`opt_state_shapes` names them) or ``"<field>"`` to a shape.  A
    leaf of a parameter's shape mirrors it (JAX: the parameter's path is a
    suffix and its spec fits); others take the leaf rule over the state
    axes; 0-d leaves replicate."""
    cfg = parallelism_config or ParallelismConfig()
    sizes = mesh_sizes(mesh)
    min_size = fsdp_plugin.min_weight_size if fsdp_plugin is not None else 2**12
    fsdp_axes = tuple(_opt_axes(cfg, sizes, fsdp_plugin))
    plan = {}
    for key, leaf in opt_state_shapes.items():
        shape = _shape(leaf)
        name = key.split("/", 1)[1] if "/" in key else None
        if not shape:
            plan[key] = PartitionSpec()
        elif name in params_plan and len(params_plan[name]) <= len(shape):
            path = path_str(name)
            spec = _mirror_spec(path, tuple(_swap(shape, path)), _swap(params_plan[name], path),
                                sizes, fsdp_axes, min_size)
            plan[key] = PartitionSpec(*_swap(spec, path))
        else:
            plan[key] = PartitionSpec(*_spec_for_leaf(key, shape, sizes, fsdp_axes, min_size, []))
    return plan


def opt_state_shapes(opt_state, names: Sequence[str]) -> dict:
    """``{"<field>/<name>": shape}`` of a NamedTuple optimizer state whose
    list fields hold one tensor per parameter (``names`` in the state's
    order), and ``{"<field>": ()}`` of its counters; its hyperparameters
    are not state the plan lays out."""
    out = {}
    for field, value in zip(opt_state._fields, opt_state):
        if isinstance(value, list) and len(value) == len(names):
            out.update({f"{field}/{n}": tuple(t.shape) for n, t in zip(names, value)})
        elif not isinstance(value, dict):
            out[field] = tuple(getattr(value, "shape", ()))
    return out


def spec_axes(spec) -> tuple:
    """The mesh axes a spec splits over, in order (one entry at most is
    set by the FSDP rule)."""
    axes: list = []
    for entry in spec:
        if entry is None:
            continue
        axes.extend((entry,) if isinstance(entry, str) else entry)
    return tuple(axes)


def plan_bytes_per_device(shapes_and_dtypes: dict, plan: dict, mesh) -> int:
    """Bytes one rank holds of a ``{name: (shape, dtype)}`` tree (or of
    tensors) under ``plan``: each leaf's bytes over its spec's shard count,
    rounded up."""
    import torch

    sizes = mesh_sizes(mesh)
    total = 0
    for name, leaf in shapes_and_dtypes.items():
        shape, dtype = (leaf if isinstance(leaf, tuple) else (tuple(leaf.shape), leaf.dtype))
        n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        div = 1
        for entry in plan[name]:
            if entry is not None:
                div *= _axis_size(sizes, entry)
        total += -(-n // div)
    return total


# The Megatron column / row layout of a transformer block, on the JAX
# layout's paths and dimensions (the JAX package's table, as data; a tp
# axis of more than one rank is ROADMAP item A13a, with the collective
# matmul)
TRANSFORMER_TP_RULES: list = [
    (r"(embed_tokens|embedding|wte|word_embeddings)/embedding$", PartitionSpec("tp", None)),
    (r"(q_proj|k_proj|v_proj|query|key|value|wq|wk|wv|in_proj|qkv)/kernel$", PartitionSpec(None, "tp")),
    (r"(o_proj|out_proj|wo|dense(?!_4h)|attn_out)/kernel$", PartitionSpec("tp", None)),
    (r"(gate_proj|up_proj|wi|wi_gate|wi_up|w1|w3|fc1|dense_h_to_4h|c_fc)/kernel$", PartitionSpec(None, "tp")),
    (r"(down_proj|wo_mlp|w2|fc2|dense_4h_to_h|c_proj)/kernel$", PartitionSpec("tp", None)),
    (r"(lm_head|output|score)/kernel$", PartitionSpec(None, "tp")),
]


def tp_rules_for(parallelism_config: Optional[ParallelismConfig], tp_config=None) -> list:
    """The rule table a train state's plan applies (JAX ``_params_plan``):
    the ``tp_config``'s plan, else the MoE table under ``ep > 1`` (the
    expert leaves split over ``ep``), else the transformer table under
    ``tp > 1``, else none."""
    if tp_config is not None:
        return list(get_tp_rules(tp_config.plan))
    if parallelism_config is not None and parallelism_config.ep_size > 1:
        return list(get_tp_rules("moe"))
    if parallelism_config is not None and parallelism_config.tp_size > 1:
        return list(get_tp_rules("auto"))
    return []


# the model axes: a leaf split over one is held as a slice by each rank
MODEL_AXES = ("tp", "ep")


def tp_split_dim(spec, axis: str = "tp") -> Optional[int]:
    """The dimension a spec splits over ``axis`` (``tp``), or None."""
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        if axis in axes:
            return d
    return None


def model_split(spec, sizes: dict) -> tuple[Optional[str], Optional[int]]:
    """``(axis, dimension)`` of the model axis (``tp`` or ``ep``, the
    first of more than one rank) a spec splits a leaf over, or ``(None,
    None)``.  A leaf split over both is not ported (ROADMAP A13h.5)."""
    found = [(a, tp_split_dim(spec, a)) for a in MODEL_AXES
             if sizes.get(a, 1) > 1 and tp_split_dim(spec, a) is not None]
    if len(found) > 1:
        raise NotImplementedError("a leaf split over both tp and ep is not ported yet "
                                  "(ROADMAP item A13h.5)")
    return found[0] if found else (None, None)


def tp_shard(t, dim: Optional[int], ways: int, index: int):
    """Rank ``index``'s slice of ``t`` along ``dim`` over ``ways`` ranks (a
    new tensor; ``t`` itself without a split)."""
    if dim is None or ways == 1:
        return t
    size = t.shape[dim] // ways
    return t.narrow(dim, index * size, size).contiguous()


def bind_tp_slices(model):
    """This rank's module for inference in a tp world (a gloo gang, or
    :meth:`~.virtual.VirtualMesh.run` on the card): JAX's
    ``make_sharding_plan(params, mesh, pcfg, tp_rules)`` followed by
    ``jax.device_put``, before ``generate(model, sharded, ...)`` or
    ``ServingEngine(model, sharded, ...)``.

    Call it on every rank, inside the world.  The plan is
    :func:`make_sharding_plan`'s over the model's state (parameters and the
    quantized denses' codes and scales) on the ambient mesh with
    :func:`tp_rules_for` its parallelism config; the returned module holds
    this rank's :func:`tp_shard` of each leaf the plan splits over ``tp``
    as its own tensor, so the whole ``model`` may be released.  The rest is
    as JAX's plan leaves it: the norms, and the quantized codes and scales
    (the tp rules end in ``kernel$``), whole on every rank, shared with
    ``model``; the data-parallel axes hold whole copies (the binding keeps
    no FSDP ranges: every call would gather them back).  The adapter pool
    of :class:`~..serving.adapters.AdapterStore` is outside the plan, whole
    on every rank.  The plan is kept as the module's ``tp_plan``:
    :func:`plan_bytes_per_device` of the state's whole shapes under it is
    what the rank holds (:func:`held_bytes`).  The module is for
    inference: its tensors take no gradient."""
    import copy

    import torch

    from ..state import ambient_mesh
    from .collectives import axis_index

    mesh, cfg = ambient_mesh()
    if mesh is None:
        raise ValueError("bind_tp_slices runs inside a world: build an Accelerator with a "
                         "parallelism_config, or call it inside VirtualMesh.run")
    cfg = cfg or ParallelismConfig()
    tp = mesh_sizes(mesh).get("tp", 1)
    state = model.state_dict(keep_vars=True)
    plan = make_sharding_plan(state, mesh, cfg, FullyShardedDataParallelPlugin(
        sharding_strategy=ShardingStrategy.NO_SHARD), tp_rules_for(cfg))
    index = axis_index("tp", mesh) if tp > 1 else 0
    memo = {}
    for name, t in state.items():
        dim = tp_split_dim(plan[name]) if tp > 1 else None
        held = tp_shard(t.detach(), dim, tp, index) if dim is not None else t.detach()
        memo[id(t)] = (torch.nn.Parameter(held, requires_grad=False)
                       if isinstance(t, torch.nn.Parameter) else held)
    # the rope tables and other non-persistent buffers are shared too
    for buf in model.buffers():
        memo.setdefault(id(buf), buf)
    bound = copy.deepcopy(model, memo)
    bound.tp_plan = plan
    return bound


def held_bytes(module) -> int:
    """Bytes of the tensors a module's state holds (each once)."""
    seen, total = set(), 0
    for t in module.state_dict(keep_vars=True).values():
        if id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


def get_tp_rules(plan: str = "auto"):
    if plan in ("auto", "transformer"):
        return TRANSFORMER_TP_RULES
    if plan in ("none", None):
        return []
    if plan in ("moe", "mixtral"):
        from .expert_parallel import get_moe_rules

        return get_moe_rules()
    raise ValueError(f"unknown tp plan {plan!r}")


# ---------------------------------------------------------------------------
# the train step's layout of a leaf
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LeafLayout:
    """How one leaf lies across the ranks in the train step.  The
    parameter is split over ``param_axes`` (empty: whole on every rank) and
    its optimizer state over ``opt_axes``, which extend ``param_axes`` (the
    joint cp entry, or ZeRO-2's dp_shard).  Both split the row-major
    flatten in ranges of ``chunk`` elements per optimizer shard (a multiple
    of ``align``, the -sr8 scale block), zero-padded past ``numel``; a
    parameter shard spans ``extra`` consecutive optimizer ranges."""

    shape: tuple
    numel: int
    param_axes: tuple
    opt_axes: tuple
    param_ways: int
    opt_ways: int
    chunk: int
    # the model split: the leaf's whole shape, the port dimension split
    # over ``model_axis`` (tp, or ep for an expert leaf; None: whole on
    # every rank of it) and its ways; ``shape`` / ``numel`` are then the
    # rank's slice's.  ``relay``: the optimizer's ranges lie over the whole
    # leaf's flatten, over the model axis (``opt_axes == (model_axis,)``)
    whole_shape: tuple = ()
    tp_dim: Optional[int] = None
    tp_ways: int = 1
    relay: bool = False
    model_axis: str = "tp"

    @property
    def extra(self) -> int:
        return self.opt_ways // self.param_ways

    @property
    def sharded(self) -> bool:
        return self.opt_ways > 1

    @property
    def whole_numel(self) -> int:
        return math.prod(self.whole_shape)


def _blocks_whole(shape: tuple, dim: int, ways: int, align: int) -> bool:
    """Whether a rank's tp slice along ``dim`` is made of whole ``align``
    blocks of the leaf's row-major flatten."""
    local = list(shape)
    local[dim] //= ways
    if dim == 0:
        return math.prod(local) % align == 0
    return math.prod(local[dim:]) % align == 0


def leaf_layouts(params: dict, mesh, parallelism_config: ParallelismConfig,
                 fsdp_plugin: Optional[FullyShardedDataParallelPlugin] = None,
                 align: int = 1, tp_rules: Optional[Sequence] = None) -> dict:
    """``{name: LeafLayout}`` from the parameter plan (with ``tp_rules``)
    and the optimizer state's plan for a mirror of each parameter."""
    sizes = mesh_sizes(mesh)
    plan = make_sharding_plan(params, mesh, parallelism_config, fsdp_plugin, tp_rules)
    mirrors = {f"mu/{n}": _shape(p) for n, p in params.items()}
    opt_plan = make_opt_state_sharding_plan(mirrors, plan, mesh, parallelism_config,
                                            fsdp_plugin)
    out = {}
    for name, leaf in params.items():
        whole = _shape(leaf)
        axis, tp_dim = model_split(plan[name], sizes) if whole else (None, None)
        axis = axis or "tp"
        tp_ways = sizes.get(axis, 1) if tp_dim is not None else 1
        shape = list(whole)
        if tp_dim is not None:
            shape[tp_dim] //= tp_ways
        shape = tuple(shape)
        p_axes = tuple(a for a in spec_axes(plan[name]) if a not in MODEL_AXES)
        o_axes = (tuple(a for a in spec_axes(opt_plan[f"mu/{name}"]) if a not in MODEL_AXES)
                  if whole else ())
        if o_axes[:len(p_axes)] != p_axes:
            raise ValueError(f"{name}: optimizer axes {o_axes} do not extend the parameter's "
                             f"{p_axes}")
        relay = tp_dim is not None and not _blocks_whole(whole, tp_dim, tp_ways, align)
        if relay:
            # the slice is not whole blocks: the update runs on ranges of
            # the whole leaf's flatten over the model axis, the slice stays
            # whole over dp
            p_axes, o_axes = (), (axis,)
            numel = math.prod(whole)
            o_ways = tp_ways
        else:
            numel = math.prod(shape)
            o_ways = _axis_size(sizes, o_axes) if o_axes else 1
        chunk = -(-numel // (o_ways * align)) * align if o_ways > 1 else numel
        out[name] = LeafLayout(shape=shape, numel=math.prod(shape), param_axes=p_axes,
                               opt_axes=o_axes,
                               param_ways=_axis_size(sizes, p_axes) if p_axes else 1,
                               opt_ways=o_ways, chunk=chunk, whole_shape=whole, tp_dim=tp_dim,
                               tp_ways=tp_ways, relay=relay, model_axis=axis)
    return out


# ---------------------------------------------------------------------------
# a rank's holding in global coordinates
# ---------------------------------------------------------------------------
#
# A rank's tensor of a leaf holds elements of the whole leaf's row-major
# flatten.  Its holding is a list of runs ``(global start, local start,
# length)``: ``length`` consecutive elements of the whole flatten at
# ``global start`` lie at ``local start`` of the rank's own flatten.
# Padding lanes belong to no run.  The sharded checkpoint writes and reads
# runs (``checkpointing.py``); a tp slice along a dimension past the first
# is one run per row of the dimensions before it.


def tp_runs(whole_shape: tuple, dim: Optional[int], ways: int, index: int):
    """The runs of rank ``index``'s slice of a leaf of ``whole_shape`` split
    ``ways`` ways along ``dim`` (the whole leaf: one run), as an int64
    ``[n, 3]`` array."""
    import numpy as np

    numel = math.prod(whole_shape)
    if dim is None or ways == 1:
        return np.asarray([[0, 0, numel]] if numel else [], dtype=np.int64).reshape(-1, 3)
    outer = math.prod(whole_shape[:dim])
    inner = math.prod(whole_shape[dim + 1:])
    run = whole_shape[dim] // ways * inner
    o = np.arange(outer, dtype=np.int64)
    return np.stack([o * whole_shape[dim] * inner + index * run, o * run,
                     np.full(outer, run, dtype=np.int64)], axis=1).reshape(-1, 3)


def clip_runs(runs, start: int, stop: int):
    """The part of ``runs`` whose local positions lie in ``[start, stop)``,
    local starts taken from ``start``."""
    import numpy as np

    runs = np.asarray(runs, dtype=np.int64).reshape(-1, 3)
    lo = np.maximum(runs[:, 1], start)
    hi = np.minimum(runs[:, 1] + runs[:, 2], stop)
    keep = lo < hi
    g, l, lo, hi = runs[keep, 0], runs[keep, 1], lo[keep], hi[keep]
    return np.stack([g + lo - l, lo - start, hi - lo], axis=1).reshape(-1, 3)


def block_runs(runs, block: int):
    """``runs`` of elements as runs of the ``block``-element scale blocks
    they cover (each run starts on a block boundary, in the whole flatten
    and locally; the last may end mid-block, at the leaf's end)."""
    import numpy as np

    runs = np.asarray(runs, dtype=np.int64).reshape(-1, 3)
    if ((runs[:, 0] % block) | (runs[:, 1] % block)).any():
        raise ValueError(f"runs {runs[:4].tolist()} do not start on {block}-element blocks")
    return np.stack([runs[:, 0] // block, runs[:, 1] // block, -(-runs[:, 2] // block)],
                    axis=1).reshape(-1, 3)


def pack_runs(runs) -> list:
    """Runs stored contiguously (local starts ascending, no gaps) as
    ``[[global start, length, count, stride], ...]``: ``count`` runs of
    ``length`` whose global starts step by ``stride`` (a tp slice's rows
    pack into one entry)."""
    out: list = []
    for g, _, n in runs.tolist():
        if out and out[-1][1] == n and (out[-1][2] == 1 or g - out[-1][0] - (out[-1][2] - 1)
                                        * out[-1][3] == out[-1][3]):
            last = out[-1]
            if last[2] == 1:
                last[3] = g - last[0]
            last[2] += 1
        else:
            out.append([g, n, 1, 0])
    return out


def unpack_runs(packed: list):
    """:func:`pack_runs`' inverse: runs with local starts laid end to end."""
    import numpy as np

    parts = []
    for g, n, count, stride in packed:
        k = np.arange(count, dtype=np.int64)
        parts.append(np.stack([g + k * stride, np.full(count, n, dtype=np.int64)], axis=1))
    if not parts:
        return np.zeros((0, 3), dtype=np.int64)
    gn = np.concatenate(parts)
    local = np.concatenate([[0], np.cumsum(gn[:-1, 1])]).astype(np.int64)
    return np.stack([gn[:, 0], local, gn[:, 1]], axis=1)
