"""The train step's data parallelism under a sharding plan: where the JAX
step lets GSPMD insert the collectives its shardings imply, the port runs
them by hand on plain local tensors.

- At rest each rank holds its shard of every sharded parameter and of its
  optimizer state (:class:`~.sharding.LeafLayout`: padded ranges of the
  row-major flatten), the whole of the others.
- :meth:`DataParallelPlan.gather_params`: the full parameters for the
  forward (``all_gather_into_tensor`` over the parameter's axes), the
  whole tree at once, but for the leaves the step gathers unit by unit:
  :class:`UnitGathers` (``reshard_after_forward``) gathers each unit's
  (an embedding, a decoder block, a scanned block's iteration, the head)
  as the model reaches it (:func:`unit_weights`) and reduces its gradient
  in the unit's backward with :meth:`DataParallelPlan.reduce_leaf`, the
  whole-tree step's op, width and order; under ``True`` the backward
  gathers the unit again (its saved weights are handles), under ``False``
  the saved tensors keep the gathered weights.  A scanned stack's
  iteration slices are gathered alone and their gradients reduced with
  the stack's, after the backward.  On a virtual world the backward's
  gathers and reductions run in memory over the ranks' exchanged tensors
  (``parallel/virtual.py``).
- :meth:`DataParallelPlan.reduce_grads`: each gradient summed over the
  data-parallel ranks (``dp_replicate`` x ``dp_shard`` x ``cp``):
  reduce-scattered over its optimizer axes and all-reduced over the rest,
  or all-reduced whole where the state is not sharded.
- the update runs on each rank's optimizer range, the -sr / -sr8 salts
  taking the whole leaf's size (:meth:`DataParallelPlan.numels`); a
  parameter whose state is split finer than itself (the joint cp entry,
  ZeRO-2's replicated parameters) is gathered back over the extra axes
  (:meth:`DataParallelPlan.write_back`).
- the global norm and the fp16 finiteness flag are reduced across ranks.

Under ``tp`` the plan's tp split is real (``sharding.tp_shard``): a rank
stores its slice of each tp leaf and the data-parallel ranges lie over
that slice; :meth:`gather_params` gathers over the data-parallel axes
only, so the forward runs on the slices (``models/llama.py``'s
``ParallelForward``).  The slices' gradients are summed over the
data-parallel axes and ``sp`` (whose ranks hold the sequence's slices),
not over ``tp``; the global norm sums a tp slice's squares over ``tp``
once and a replicated leaf's once.  A ``relay`` leaf (a slice that is not
whole -sr8 blocks) is updated on ranges of the whole leaf's flatten: its
gradient is gathered over ``tp`` before the update and the new values
after.  :meth:`whole_params` gathers whole leaves.

Under ``ep`` an expert leaf is split the same way over ``ep`` (its
dimension 0, ``LeafLayout.model_axis``): the rank holds its experts, their
gradients are its own, summed over the data-parallel axes, and the global
norm sums their squares over ``ep`` once; the replicated leaves'
gradients are whole on every ep rank (``models/mixtral.py``: ``psum`` /
``pbroadcast``) and are not summed over ``ep``.

A dimension of one rank runs no collective, so in a world of one process
every step is the single-process step's, bit for bit.  Every collective
here also runs on a :class:`~.virtual.VirtualMesh` (one thread a rank),
and a host tensor (an offloaded state's ranges) crosses an NCCL group
through the card.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Optional

import torch

from ..parallelism_config import ParallelismConfig
from . import collectives
from .sharding import LeafLayout, block_runs, clip_runs, leaf_layouts, tp_runs, tp_shard


def _size(axes, mesh) -> int:
    return collectives.axis_size(axes, mesh) if axes else 1


class DataParallelPlan:
    """The layouts of one train state's leaves over ``mesh`` and the
    collectives of its step."""

    def __init__(self, mesh, parallelism_config: ParallelismConfig, fsdp_plugin, params: dict,
                 align: int = 1, tp_rules=None):
        self.mesh = mesh
        self.align = align
        self.layouts: dict[str, LeafLayout] = leaf_layouts(params, mesh, parallelism_config,
                                                           fsdp_plugin, align, tp_rules)
        # the ranks whose gradients sum: every data-parallel axis, cp and sp
        names = parallelism_config.dp_cp_dim_names + ("sp",)
        self.dp_axes = tuple(a for a in names if collectives.axis_size(a, mesh) > 1)
        self.world = _size(self.dp_axes, mesh)
        self.tp = collectives.axis_size("tp", mesh)
        self.ep = collectives.axis_size("ep", mesh)
        # every rank of the step: where a flag must agree
        self.all_axes = self.dp_axes + tuple(a for a in ("tp", "ep")
                                             if collectives.axis_size(a, mesh) > 1)

    @property
    def any_sharded(self) -> bool:
        return any(lay.sharded or lay.tp_dim is not None for lay in self.layouts.values())

    @property
    def numels(self) -> list:
        """Each leaf's whole size (the -sr salts key on it)."""
        return [lay.whole_numel for lay in self.layouts.values()]

    # -- the coordinates of this rank ------------------------------------------

    def _coord(self, axes) -> int:
        return collectives.axis_index(axes, self.mesh) if axes else 0

    def _group(self, axes):
        return collectives.group(axes, self.mesh) if axes else None

    def _extra_axes(self, lay: LeafLayout) -> tuple:
        return lay.opt_axes[len(lay.param_axes):]

    @property
    def virtual(self) -> bool:
        return getattr(self.mesh, "is_virtual", False)

    def _wire(self, x: torch.Tensor, axes) -> Optional[torch.device]:
        """The card a host tensor crosses an NCCL group through (an
        offloaded state's ranges), or None."""
        if self.virtual or x.device.type != "cpu" or not torch.cuda.is_available():
            return None
        import torch.distributed as dist

        if dist.get_backend(self._group(axes)) != "nccl":
            return None
        return torch.device("cuda", torch.cuda.current_device())

    def _gather(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Every member's flat ``x`` in group order (``x`` flattened for no
        group)."""
        x = x.contiguous().reshape(-1)
        if _size(axes, self.mesh) == 1:
            return x
        if self.virtual:
            return self.mesh.collective("all_gather", x, tuple(axes), axis=0, tiled=True)
        card = self._wire(x, axes)
        if card is not None:
            return collectives.gather_flat(x.to(card), self._group(axes)).cpu()
        return collectives.gather_flat(x, self._group(axes))

    def _psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        card = self._wire(x, axes)
        if card is not None:
            return collectives.psum(x.to(card), axes, self.mesh).cpu()
        return collectives.psum(x, axes, self.mesh)

    def _reduce_scatter(self, flat: torch.Tensor, axes, chunk: int) -> torch.Tensor:
        """The members' ``flat`` summed, this rank's ``chunk`` of it."""
        if self.virtual:
            return self.mesh.collective("reduce_scatter", flat, tuple(axes), axis=0)
        import torch.distributed as dist

        out = torch.empty(chunk, dtype=flat.dtype, device=flat.device)
        dist.reduce_scatter_tensor(out, flat, group=self._group(axes))
        return out

    def _all_reduce(self, g: torch.Tensor, axes) -> torch.Tensor:
        """The members' ``g`` summed (in place on a gang)."""
        g = g.contiguous()
        if self.virtual:
            return self.mesh.collective("psum", g, tuple(axes))
        import torch.distributed as dist

        dist.all_reduce(g, group=self._group(axes))
        return g

    # -- the layout at rest --------------------------------------------------------

    def _flat_range(self, t: torch.Tensor, start: int, length: int) -> torch.Tensor:
        """``t``'s flatten from ``start``, ``length`` elements, zero-padded
        past its end (a new tensor)."""
        flat = t.reshape(-1)
        out = torch.zeros(length, dtype=t.dtype, device=t.device)
        stop = min(start + length, flat.numel())
        if stop > start:
            out[:stop - start] = flat[start:stop]
        return out

    def _tp_slice(self, t: torch.Tensor, lay: LeafLayout) -> torch.Tensor:
        if lay.tp_dim is None:
            return t
        return tp_shard(t, lay.tp_dim, lay.tp_ways, self._coord((lay.model_axis,)))

    def _tp_whole(self, t: torch.Tensor, lay: LeafLayout) -> torch.Tensor:
        """The whole leaf from every model-axis rank's slice ``t``."""
        if lay.tp_dim is None:
            return t
        return collectives.all_gather(t.detach().contiguous(), lay.model_axis,
                                      axis=lay.tp_dim, mesh=self.mesh)

    def shard_params(self, params: dict) -> dict:
        """Each rank's parameters at rest: its tp slice, and its range of
        each data-parallel-sharded parameter, the others as they are."""
        out = {}
        for name, p in params.items():
            lay = self.layouts[name]
            local = self._tp_slice(p.detach(), lay) if lay.tp_dim is not None else p
            if lay.param_ways > 1:
                span = lay.chunk * lay.extra
                out[name] = self._flat_range(local.detach(), self._coord(lay.param_axes) * span,
                                             span)
            else:
                out[name] = local
        return out

    def opt_params(self, params: dict) -> list:
        """The parameter ranges the optimizer updates, in leaf order: views
        into the stored shards where the state splits as the parameter
        does or finer, padded copies of a whole parameter's range
        (ZeRO-2)."""
        leaves = []
        for name, p in params.items():
            lay = self.layouts[name]
            if lay.relay:
                whole = self._tp_whole(p, lay)
                leaves.append(self._flat_range(whole, self._coord(lay.opt_axes) * lay.chunk,
                                               lay.chunk))
            elif not lay.sharded:
                leaves.append(p)
            elif lay.param_ways > 1:
                k = self._coord(self._extra_axes(lay))
                leaves.append(p[k * lay.chunk:(k + 1) * lay.chunk])
            else:
                leaves.append(self._flat_range(p, self._coord(lay.opt_axes) * lay.chunk,
                                               lay.chunk))
        return leaves

    # -- what this rank holds, in global coordinates -------------------------------

    def _slice_runs(self, lay: LeafLayout):
        """The runs of this rank's tp / ep slice of the leaf (the whole
        leaf without a model split)."""
        return tp_runs(lay.whole_shape, lay.tp_dim, lay.tp_ways,
                       self._coord((lay.model_axis,)) if lay.tp_dim is not None else 0)

    def param_runs(self, name: str):
        """The runs (``sharding.tp_runs``' rows: global start, local start,
        length) of this rank's stored parameter: its range of the slice
        under a parameter split, else the slice; padding in none."""
        lay = self.layouts[name]
        runs = self._slice_runs(lay)
        if lay.param_ways > 1:
            span = lay.chunk * lay.extra
            k = self._coord(lay.param_axes)
            runs = clip_runs(runs, k * span, (k + 1) * span)
        return runs

    def opt_runs(self, name: str, block: int = 1):
        """The runs of this rank's optimizer range of the leaf (``block`` >
        1: of a per-block tensor, in blocks): a range of the whole leaf
        for a ``relay`` leaf, a range of the slice where the state is
        sharded, else the stored parameter's."""
        lay = self.layouts[name]
        if lay.relay:
            k = self._coord(lay.opt_axes)
            runs = clip_runs(tp_runs(lay.whole_shape, None, 1, 0), k * lay.chunk,
                             (k + 1) * lay.chunk)
        elif lay.sharded:
            k = self._coord(lay.opt_axes)
            runs = clip_runs(self._slice_runs(lay), k * lay.chunk, (k + 1) * lay.chunk)
        else:
            runs = self._slice_runs(lay)
        return block_runs(runs, block) if block > 1 else runs

    def writes(self, name: str, opt: bool = False) -> bool:
        """Whether this rank writes the leaf's parameter (``opt``: its
        optimizer range) to a checkpoint: the first of the ranks holding
        the same elements, coordinate 0 on every mesh axis that does not
        split them."""
        lay = self.layouts[name]
        split = lay.opt_axes if opt else lay.param_axes
        if lay.tp_dim is not None and lay.model_axis not in split:
            split = split + (lay.model_axis,)
        sizes = collectives.mesh_sizes(self.mesh)
        return all(self._coord((a,)) == 0 for a, n in sizes.items()
                   if n > 1 and a not in split)

    # -- the step's collectives --------------------------------------------------

    def gather_params(self, params: dict, skip=()) -> dict:
        """The parameters the forward reads: gathered over the
        data-parallel axes (the stored tensors where whole, or where
        ``skip`` names them: the leaves the forward gathers unit by unit), a
        tp leaf as this rank's slice."""
        full = {}
        for name, p in params.items():
            lay = self.layouts[name]
            if lay.param_ways > 1 and name not in skip:
                flat = self._gather(p, lay.param_axes)
                full[name] = flat[:lay.numel].view(lay.shape)
            else:
                full[name] = p
        return full

    def whole_params(self, params: dict) -> dict:
        """Whole leaves (:meth:`gather_params`, then the tp slices
        gathered); every rank must call this together."""
        return {name: self._tp_whole(p, self.layouts[name])
                for name, p in self.gather_params(params).items()}

    def _rest_axes(self, lay: LeafLayout) -> tuple:
        return tuple(a for a in self.dp_axes if a not in lay.opt_axes)

    def reduce_leaf(self, g: torch.Tensor, lay: LeafLayout) -> torch.Tensor:
        """One gradient summed over the data-parallel ranks, as this rank's
        optimizer range (or whole): reduce-scattered over the leaf's
        optimizer axes, all-reduced over the other data-parallel axes."""
        if lay.relay:
            if self.world > 1:
                g = self._all_reduce(g, self.dp_axes)
            whole = self._tp_whole(g, lay)
            return self._flat_range(whole, self._coord(lay.opt_axes) * lay.chunk, lay.chunk)
        rest = self._rest_axes(lay)
        if lay.sharded:
            flat = self._flat_range(g, 0, lay.chunk * lay.opt_ways)
            g = self._reduce_scatter(flat, lay.opt_axes, lay.chunk)
        if _size(rest, self.mesh) > 1:
            g = self._all_reduce(g, rest)
        return g

    def reduce_grads(self, grads: list, done=None) -> list:
        """Each gradient summed over the data-parallel ranks, as this rank's
        optimizer range (or whole); a leaf ``done`` marks came reduced
        already (its unit's backward reduced it: :class:`UnitGathers`)."""
        return [g if done is not None and done[i] else self.reduce_leaf(g, lay)
                for i, (g, lay) in enumerate(zip(grads, self.layouts.values()))]

    def local_grads(self, grads: list) -> list:
        """Whole gradients already reduced (a codec step's, on replicated
        parameters) as this rank's optimizer ranges, or whole: what
        :meth:`reduce_grads` gives, without the reduction."""
        return [self._flat_range(g, self._coord(lay.opt_axes) * lay.chunk, lay.chunk)
                if lay.sharded else g for g, lay in zip(grads, self.layouts.values())]

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the data-parallel ranks (``x`` in a world of
        one)."""
        if self.world == 1:
            return x
        return collectives.psum(x, self.dp_axes, self.mesh)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` maxed over every rank of the step (``x`` without one)."""
        if not self.all_axes:
            return x
        card = self._wire(x, self.all_axes)
        if card is not None:
            return collectives.pmax(x.to(card), self.all_axes, self.mesh).cpu()
        return collectives.pmax(x, self.all_axes, self.mesh)

    def all_finite(self, flag: torch.Tensor) -> torch.Tensor:
        """A finiteness flag true on every rank or on none."""
        if not self.all_axes:
            return flag
        return collectives.pmin(flag.to(torch.int32), self.all_axes, self.mesh).bool()

    def global_norm(self, grads: list, local_norm) -> torch.Tensor:
        """``sqrt(sum ||g||^2)`` over the whole reduced gradients: the
        sharded ranges' squares summed over their optimizer axes.
        ``local_norm`` is the single-process norm, used as it is when no
        leaf is sharded."""
        if not self.any_sharded:
            return local_norm(grads)
        groups: dict = {}
        for g, lay in zip(grads, self.layouts.values()):
            sq = torch.linalg.vector_norm(g, dtype=torch.float32).square()
            axes = lay.opt_axes if lay.sharded else ()
            if lay.tp_dim is not None and lay.model_axis not in axes:
                axes = axes + (lay.model_axis,)
            groups.setdefault(axes, []).append(sq)
        total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        for axes, squares in groups.items():
            part = torch.stack(squares).sum()
            total = total + (self._psum(part, axes) if axes else part)
        return torch.sqrt(total)

    def write_back(self, params: dict, new_leaves: list) -> None:
        """The update's new ranges into the stored parameters, gathered over
        the axes the state splits finer than the parameter."""
        with torch.no_grad():
            for (name, p), new in zip(params.items(), new_leaves):
                lay = self.layouts[name]
                if lay.relay:
                    flat = self._gather(new, lay.opt_axes)
                    whole = flat[:lay.whole_numel].view(lay.whole_shape)
                    p.copy_(self._tp_slice(whole, lay))
                    continue
                if not lay.sharded:
                    p.copy_(new)
                    continue
                extra = self._extra_axes(lay)
                if lay.param_ways > 1:
                    k = self._coord(extra)
                    p[k * lay.chunk:(k + 1) * lay.chunk].copy_(new)
                    if extra:
                        p.copy_(self._gather(p[k * lay.chunk:(k + 1) * lay.chunk], extra))
                else:
                    flat = self._gather(new, lay.opt_axes)
                    p.copy_(flat[:lay.numel].view(lay.shape))

    def token_weight(self, batch):
        """This rank's share of the global token mean: its valid-token
        count over the world's (labels ``!= -100``: ``shift_labels``, or
        ``labels`` past the first position), or ``1 / world`` for a batch
        without labels.  None in a world of one."""
        if self.world == 1:
            return None
        labels = None
        if isinstance(batch, dict):
            if "shift_labels" in batch:
                labels = batch["shift_labels"]
            elif "labels" in batch:
                labels = batch["labels"][..., 1:]
        if labels is None:
            return 1.0 / self.world
        count = (labels != -100).sum().to(torch.float32)
        total = collectives.psum(count, self.dp_axes, self.mesh)
        return count / torch.clamp(total, min=1.0)


# -- per-unit gathering (FullyShardedDataParallelPlugin.reshard_after_forward) --

_ACTIVE = threading.local()


def active_units() -> Optional["UnitGathers"]:
    """The per-unit gathers of the step running on this thread, or None."""
    return getattr(_ACTIVE, "units", None)


def unit_weights(names, tensors, iteration: Optional[int] = None, units=None) -> list:
    """A model's unit boundary: ``tensors`` (the leaves ``names``, the
    train state's names, as the forward has them bound) with every leaf the
    step gathers unit by unit replaced by its full tensor, for
    ``iteration`` that iteration's slice of a scanned stack.  The tensors
    as they are outside such a step.  ``units``: the gathers of the forward
    a recompute repeats (:func:`active_units` when the forward ran), for a
    recompute in the backward, outside the forward's region."""
    units = units if units is not None else active_units()
    if units is None:
        return list(tensors)
    return units.gather(list(names), list(tensors), iteration)


def owned_leaves(plan: DataParallelPlan, units) -> list:
    """The leaves a step gathers unit by unit, in the plan's order: split
    over data-parallel axes and named by exactly one of ``units`` (lists
    of leaf names; a leaf two units read, a tied embedding, is gathered
    whole before the forward)."""
    seen: dict = {}
    for unit in units:
        for name in set(unit):
            seen[name] = seen.get(name, 0) + 1
    return [n for n, lay in plan.layouts.items()
            if lay.param_ways > 1 and seen.get(n) == 1]


class _Saved:
    """A gathered weight's place in its unit's gather, saved for the
    backward in its stead."""

    __slots__ = ("unit", "index", "size", "stride", "offset")

    def __init__(self, unit, index, t):
        self.unit, self.index = unit, index
        self.size, self.stride, self.offset = t.size(), t.stride(), t.storage_offset()


class UnitGathers:
    """One rank's per-unit gathers for one step.

    ``ranges`` are the stored ranges the forward reads for the owned
    leaves (leaves that require grad, in the stored width).  A unit's
    :class:`_UnitGather` all-gathers them over the parameter axes in the
    compute width; its backward casts each gradient to the stored width,
    applies ``transform`` (the step's gradient widths) and reduces it with
    :meth:`DataParallelPlan.reduce_leaf`, the op, width and order of the
    whole-tree step's reduction, into :attr:`sink`.  A slice of a scanned
    stack is gathered by itself; its gradient lands in the stack's full
    gradient (:attr:`stacked`), which the step reduces after the
    backward.  With ``reshard`` (ZeRO-3) the gathered tensors are saved
    for the backward as handles (``saved_tensors_hooks``) and the backward
    gathers the unit again; without, the saved tensors keep them."""

    def __init__(self, plan: DataParallelPlan, ranges: dict, compute_dtype, transform,
                 reshard: bool):
        self.plan, self.ranges = plan, ranges
        self.compute_dtype, self.transform, self.reshard = compute_dtype, transform, reshard
        self.sink: dict = {}
        self.stacked: dict = {}
        self.virtual = plan.virtual
        self.rank = plan.mesh.rank if self.virtual else None
        self._roots: dict = {}
        self._seq: dict = {}
        self._sources: list = []
        self._outer = None

    def owns(self, name: str) -> bool:
        return name in self.ranges

    def gather(self, names: list, tensors: list, iteration) -> list:
        idx = [i for i, n in enumerate(names) if n in self.ranges]
        if not idx:
            return tensors
        unit = _Unit(self, [names[i] for i in idx], iteration)
        fulls = _UnitGather.apply(unit, *[tensors[i] for i in idx])
        out = list(tensors)
        for i, f in zip(idx, fulls):
            out[i] = f
        return out

    # -- the saved-tensor hooks -------------------------------------------------

    def register(self, unit, index: int, full: torch.Tensor) -> None:
        root = full._base if full._base is not None else full
        key = id(root)
        self._roots[key] = (weakref.ref(root, lambda _, k=key: self._roots.pop(k, None)),
                            unit, index)

    def pack(self, t):
        root = t._base if t._base is not None else t
        hit = self._roots.get(id(root))
        if hit is not None and hit[0]() is root:
            return _Saved(hit[1], hit[2], t)
        return self._outer[0](t) if self._outer is not None else t

    def unpack(self, x):
        if isinstance(x, _Saved):
            root = x.unit.regathered(x.index)
            return root.as_strided(x.size, x.stride, x.offset)
        return self._outer[1](x) if self._outer is not None else x

    def close(self) -> None:
        """Drop what the backward needed (the virtual exchanges' inputs)."""
        for key in self._sources:
            _VIRTUAL_SOURCES.pop(key, None)
        self._sources.clear()

    @contextlib.contextmanager
    def active(self):
        """The forward's region: :func:`unit_weights` answers from these
        gathers, and under ``reshard`` the saved-tensor hooks hand the
        gathered weights to the backward as handles (composed with any
        hooks already installed)."""
        prev = active_units()
        _ACTIVE.units = self
        try:
            if self.reshard:
                self._outer = _top_hooks()
                with torch.autograd.graph.saved_tensors_hooks(self.pack, self.unpack):
                    yield self
            else:
                yield self
        finally:
            _ACTIVE.units = prev

    # -- the reduction --------------------------------------------------------

    def deposit(self, name: str, g: torch.Tensor) -> None:
        """This rank's gradient of leaf ``name`` (its unit's backward): on a
        gang reduced now; on a virtual mesh held until every rank's is in,
        then reduced in memory in the ranks' order."""
        lay = self.plan.layouts[name]
        if not self.virtual:
            self.sink[name] = self.plan.reduce_leaf(g, lay)
            return
        k = self._seq.get(name, 0)
        self._seq[name] = k + 1
        slot = self.plan.mesh.deposits.setdefault((name, k), {})
        slot[self.rank] = (g, self)
        if len(slot) == self.plan.mesh.size:
            del self.plan.mesh.deposits[(name, k)]
            for r, red in _virtual_reduce(self.plan, lay, {r: v[0] for r, v in slot.items()}
                                          ).items():
                slot[r][1].sink[name] = red

    def grads(self, names: list, grads: list) -> tuple[list, list]:
        """The step's gradients with the owned leaves' reduced ranges (zeros
        where no unit ran) and the scanned stacks' full gradients in, and
        which of them came reduced."""
        out, done = list(grads), [False] * len(grads)
        for i, name in enumerate(names):
            if name not in self.ranges:
                continue
            lay = self.plan.layouts[name]
            if name in self.stacked:
                out[i] = self.stacked[name].view(lay.shape)
                continue
            red = self.sink.get(name)
            if red is None:
                leaf = self.ranges[name]
                red = torch.zeros(lay.chunk, dtype=self.transform(leaf[:1]).dtype,
                                  device=leaf.device)
            out[i], done[i] = red, True
        return out, done


def _virtual_reduce(plan: DataParallelPlan, lay: LeafLayout, gs: dict) -> dict:
    """:meth:`DataParallelPlan.reduce_leaf` of every rank's gradient at
    once, in memory, with the virtual collectives' arithmetic (the group's
    tensors summed in its order)."""
    mesh = plan.mesh

    def groups(axes):
        seen = set()
        for r in range(mesh.size):
            if r in seen:
                continue
            _, _, members = mesh._group_of(r, tuple(axes))
            seen.update(members)
            yield members

    out = dict(gs)
    if lay.sharded:
        flats = {r: plan._flat_range(g, 0, lay.chunk * lay.opt_ways) for r, g in gs.items()}
        for members in groups(lay.opt_axes):
            total = flats[members[0]]
            for m in members[1:]:
                total = total + flats[m]
            for m, piece in zip(members, torch.chunk(total, len(members))):
                out[m] = piece.contiguous()
    rest = plan._rest_axes(lay)
    if _size(rest, mesh) > 1:
        for members in groups(rest):
            total = out[members[0]].contiguous().clone()
            for m in members[1:]:
                total = total + out[m].contiguous()
            for m in members:
                out[m] = total.clone()
    return out


class _Unit:
    """One unit's gather: its owned leaves (for a scanned stack, the
    iteration's slices), gathered again by the backward under reshard."""

    def __init__(self, units: UnitGathers, names: list, iteration):
        self.units, self.names, self.iteration = units, names, iteration
        self.ranges: list = []
        self.sources: Optional[list] = None
        self.cache: Optional[list] = None

    def _pieces(self, lay: LeafLayout):
        """A scanned stack's iteration slice: ``(start, size)`` of the slice
        in the leaf's flatten and each member's overlap with it."""
        per = lay.numel // lay.shape[0]
        start = self.iteration * per
        span = lay.chunk * lay.extra
        ways = lay.param_ways
        spans = [(max(start, k * span), min(start + per, (k + 1) * span)) for k in range(ways)]
        return start, per, [(lo, max(lo, hi)) for lo, hi in spans], span

    def _local(self, i: int, r: torch.Tensor) -> torch.Tensor:
        """What this rank sends for leaf ``i``: its range in the compute
        width, or its padded piece of the iteration's slice."""
        units = self.units
        lay = units.plan.layouts[self.names[i]]
        x = r.detach()
        if x.is_floating_point() and units.compute_dtype is not None:
            x = x.to(units.compute_dtype)
        if self.iteration is None:
            return x
        _, _, spans, span = self._pieces(lay)
        k = units.plan._coord(lay.param_axes)
        width = max(hi - lo for lo, hi in spans)
        lo, hi = spans[k]
        out = torch.zeros(width, dtype=x.dtype, device=x.device)
        out[:hi - lo] = x[lo - k * span:hi - k * span]
        return out

    def _full(self, i: int, flat: torch.Tensor) -> torch.Tensor:
        lay = self.units.plan.layouts[self.names[i]]
        if self.iteration is None:
            return flat[:lay.numel].view(lay.shape)
        _, per, spans, _ = self._pieces(lay)
        width = max(hi - lo for lo, hi in spans)
        parts = [flat[k * width:k * width + hi - lo] for k, (lo, hi) in enumerate(spans)]
        return torch.cat(parts).view(lay.shape[1:])

    def _gather_all(self, ranges: list, record: bool) -> list:
        units, plan = self.units, self.units.plan
        if record:
            self._record(ranges[0])
        flats = []
        for i, r in enumerate(ranges):
            lay = plan.layouts[self.names[i]]
            x = self._local(i, r)
            if units.virtual:
                flat, xs = plan.mesh.collective("unit_gather", x, tuple(lay.param_axes))
                if self.sources is None:
                    self.sources = [None] * len(ranges)
                self.sources[i] = xs
            else:
                flat = plan._gather(x, lay.param_axes)
            flats.append(flat)
        return [self._full(i, f) for i, f in enumerate(flats)]

    def _record(self, x: torch.Tensor) -> None:
        """One gather of the unit, for an open ``record_collectives``."""
        units = self.units
        if collectives._RECORDER is not None:
            axes = units.plan.layouts[self.names[0]].param_axes
            collectives._RECORDER.add("unit_gather", axes, x, units.plan.mesh, rank=units.rank)

    def materialize(self, ranges: list) -> list:
        """The forward's gather (or a recompute's: on a virtual mesh from
        the inputs of the forward's exchange, looked up by the range)."""
        units = self.units
        key = (_key(ranges[0]), self.iteration)
        if units.virtual and getattr(units.plan.mesh, "in_backward", False):
            twin = _VIRTUAL_SOURCES.get(key)
            if twin is None:
                raise RuntimeError("a virtual rank's unit gather ran outside the rank and "
                                   "outside a recompute of its forward")
            self.sources = twin
            self._record(ranges[0])
            return [self._full(i, torch.cat(xs)) for i, xs in enumerate(twin)]
        self.ranges = list(ranges)
        fulls = self._gather_all(ranges, record=True)
        if units.virtual:
            _VIRTUAL_SOURCES[key] = self.sources
            units._sources.append(key)
        return fulls

    def regathered(self, index: int) -> torch.Tensor:
        """The backward's gather of the whole unit (once, kept until the
        unit's gradient is reduced); the root of leaf ``index``."""
        if self.cache is None:
            units = self.units
            if units.virtual:
                self._record(self.sources[0][0])
                fulls = [self._full(i, torch.cat(xs)) for i, xs in enumerate(self.sources)]
            else:
                fulls = self._gather_all(self.ranges, record=True)
            self.cache = [f._base if f._base is not None else f for f in fulls]
        return self.cache[index]

    def reduce(self, grads) -> None:
        units = self.units
        self.cache = None
        for name, g in zip(self.names, grads):
            leaf = units.ranges[name]
            if g is None:
                g = torch.zeros(self._shape(name), dtype=leaf.dtype, device=leaf.device)
            g = units.transform(g.to(leaf.dtype))
            if self.iteration is None:
                units.deposit(name, g)
                continue
            lay = units.plan.layouts[name]
            buf = units.stacked.get(name)
            if buf is None:
                buf = units.stacked[name] = torch.zeros(lay.numel, dtype=g.dtype,
                                                        device=g.device)
            start, per, _, _ = self._pieces(lay)
            buf[start:start + per] = g.reshape(-1)

    def _shape(self, name: str) -> tuple:
        lay = self.units.plan.layouts[name]
        return lay.shape if self.iteration is None else lay.shape[1:]


# the virtual ranks' exchanged inputs of each forward gather, by the
# gathering rank's range: a recompute in the joint backward (remat, the
# boundary offload) gathers from them again
_VIRTUAL_SOURCES: dict = {}


def _key(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), t.numel(), t.dtype)


def _top_hooks():
    """The saved-tensor hooks installed now, or None."""
    top = getattr(torch._C._autograd, "_top_saved_tensors_default_hooks", None)
    return top(False) if top is not None else None


class _UnitGather(torch.autograd.Function):
    """A unit's full weights from the rank's ranges (:class:`_Unit`); the
    backward reduces their gradients into the step's sink and hands the
    ranges none."""

    @staticmethod
    def forward(ctx, unit: _Unit, *ranges):
        # out of sight of a selective checkpoint's dispatch mode (remat
        # "dots"): the gather runs whole in the forward and in the recompute
        from torch.utils._python_dispatch import _disable_current_modes

        with _disable_current_modes():
            fulls = unit.materialize(list(ranges))
        ctx.unit = unit
        if unit.units.reshard:
            for i, f in enumerate(fulls):
                unit.units.register(unit, i, f)
        return tuple(fulls)

    @staticmethod
    def backward(ctx, *grads):
        ctx.unit.reduce(grads)
        return (None,) * (1 + len(grads))


def parallel_align(fsdp_plugin) -> int:
    """The range alignment: the -sr8 recipes' scale block (the plugin's, or
    their default), so no block straddles two ranks."""
    from ..ops.int8_state import DEFAULT_BLOCK_SIZE

    return fsdp_plugin.int8_state_block_size if fsdp_plugin is not None else DEFAULT_BLOCK_SIZE
