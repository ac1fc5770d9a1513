"""The train step's data parallelism under a sharding plan: where the JAX
step lets GSPMD insert the collectives its shardings imply, the port runs
them by hand on plain local tensors.

- At rest each rank holds its shard of every sharded parameter and of its
  optimizer state (:class:`~.sharding.LeafLayout`: padded ranges of the
  row-major flatten), the whole of the others.
- :meth:`DataParallelPlan.gather_params`: the full parameters for the
  forward (``all_gather_into_tensor`` over the parameter's axes), the
  whole tree at once.
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
every step is the single-process step's, bit for bit.
"""

from __future__ import annotations

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

    def gather_params(self, params: dict) -> dict:
        """The parameters the forward reads: gathered over the
        data-parallel axes (the stored tensors where whole), a tp leaf as
        this rank's slice."""
        full = {}
        for name, p in params.items():
            lay = self.layouts[name]
            if lay.param_ways > 1:
                flat = collectives.gather_flat(p, self._group(lay.param_axes))
                full[name] = flat[:lay.numel].view(lay.shape)
            else:
                full[name] = p
        return full

    def whole_params(self, params: dict) -> dict:
        """Whole leaves (:meth:`gather_params`, then the tp slices
        gathered); every rank must call this together."""
        return {name: self._tp_whole(p, self.layouts[name])
                for name, p in self.gather_params(params).items()}

    def reduce_grads(self, grads: list) -> list:
        """Each gradient summed over the data-parallel ranks, as this rank's
        optimizer range (or whole)."""
        import torch.distributed as dist

        out = []
        for g, lay in zip(grads, self.layouts.values()):
            if lay.relay:
                if self.world > 1:
                    g = g.contiguous()
                    dist.all_reduce(g, group=self._group(self.dp_axes))
                whole = self._tp_whole(g, lay)
                out.append(self._flat_range(whole, self._coord(lay.opt_axes) * lay.chunk,
                                            lay.chunk))
                continue
            rest = tuple(a for a in self.dp_axes if a not in lay.opt_axes)
            if lay.sharded:
                flat = self._flat_range(g, 0, lay.chunk * lay.opt_ways)
                g = torch.empty(lay.chunk, dtype=flat.dtype, device=flat.device)
                dist.reduce_scatter_tensor(g, flat, group=self._group(lay.opt_axes))
            if _size(rest, self.mesh) > 1:
                g = g.contiguous()
                dist.all_reduce(g, group=self._group(rest))
            out.append(g)
        return out

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
            total = total + (collectives.psum(part, axes, self.mesh) if axes else part)
        return torch.sqrt(total)

    def write_back(self, params: dict, new_leaves: list) -> None:
        """The update's new ranges into the stored parameters, gathered over
        the axes the state splits finer than the parameter."""
        with torch.no_grad():
            for (name, p), new in zip(params.items(), new_leaves):
                lay = self.layouts[name]
                if lay.relay:
                    flat = collectives.gather_flat(new, self._group(lay.opt_axes))
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
                        p.copy_(collectives.gather_flat(p[k * lay.chunk:(k + 1) * lay.chunk],
                                                        self._group(extra)))
                else:
                    flat = collectives.gather_flat(new, self._group(lay.opt_axes))
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


def parallel_align(fsdp_plugin) -> int:
    """The range alignment: the -sr8 recipes' scale block (the plugin's, or
    their default), so no block straddles two ranks."""
    from ..ops.int8_state import DEFAULT_BLOCK_SIZE

    return fsdp_plugin.int8_state_block_size if fsdp_plugin is not None else DEFAULT_BLOCK_SIZE
