"""Collectives over named dimensions of a ``DeviceMesh`` (mirrors
``accelerate_tpu/parallel/collectives.py``).

The JAX functions run inside ``shard_map`` bodies, each device holding its
shard; here each rank holds its local tensor and the function runs the
``torch.distributed`` collective over the process group of the named mesh
dimensions.  The argument names and the results are the JAX ones: ``psum``
returns the sum without touching its input, ``all_gather`` tiles or
stacks, ``reduce_scatter`` is the tiled ``psum_scatter``, ``ppermute``
leaves a rank no pair sends to with zeros, ``broadcast_from`` checks its
source.  ``axis_names`` is one name or a tuple of names (a joint
dimension, ranked row-major in the order given).  ``mesh`` defaults to
the newest accelerator state's (``state.ambient_mesh``).

JAX's ``partial_manual_kwargs`` (the ``shard_map`` arguments of a region
manual over some axes) has no meaning without ``shard_map`` and is not
ported: every function here is "manual" over the axes it names.

A dimension of size 1 needs no communication: the functions return their
JAX results (copies of the input) without calling ``torch.distributed``.

Gradients (the tensor- and sequence-parallel layers differentiate through
them): given a tensor that requires one, ``ppermute`` / ``ring_permute``
permute the gradient back, ``all_to_all`` runs the inverse exchange,
``all_gather`` and ``reduce_scatter`` are each other's backward, and
``psum``'s backward is the identity.  ``psum`` and :func:`pbroadcast`
(the identity, whose backward is the psum) are Megatron's "g" / "f" pair
around a tensor-parallel region: every rank of ``tp`` computes the same
loss, so a value summed into all ranks passes its gradient through, and a
value all ranks read sums the gradients its readers give it.
:func:`all_gather_invariant` gathers a value every rank then reads whole;
its backward keeps this rank's slice.  :func:`ring_permute_start` issues
a ring hop and returns before waiting on it (the collective matmul's
hop rides under the product of the chunk it already holds).

A :class:`~.virtual.VirtualMesh` runs every rank of a world in one
process (one thread a rank, in turn); each function here then exchanges
the ranks' tensors in memory with the same forward and backward.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

AxisNames = Union[str, Sequence[str]]

# (the mesh's names, ranks and shape, the axes) -> this rank's process
# group over those axes; emptied with the process group
_GROUPS: dict = {}

# the open recording of parallel/hierarchical.record_collectives, or None:
# one check on the path when nothing records
_RECORDER = None


def _record(kind: str, x, names: tuple, mesh) -> None:
    if _RECORDER is not None:
        _RECORDER.add(kind, names, x, mesh)


def _names(axis_names: AxisNames) -> tuple:
    return (axis_names,) if isinstance(axis_names, str) else tuple(axis_names)


def _mesh(mesh):
    if mesh is None:
        from ..state import ambient_mesh

        mesh = ambient_mesh()[0]
        if mesh is None:
            raise RuntimeError("no device mesh: construct an Accelerator with a "
                               "parallelism_config (or pass mesh=)")
    return mesh


def mesh_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or a ``(names, shape)``
    layout."""
    if isinstance(mesh, tuple):
        names, shape = mesh
        return dict(zip(names, shape))
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_size(axis_names: AxisNames, mesh=None) -> int:
    sizes = mesh_sizes(_mesh(mesh))
    return math.prod(int(sizes[a]) for a in _names(axis_names))


def axis_index(axis_names: AxisNames, mesh=None) -> int:
    """This rank's coordinate along the (joint) dimension."""
    mesh = _mesh(mesh)
    sizes = mesh_sizes(mesh)
    idx = 0
    for a in _names(axis_names):
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx


def group(axis_names: AxisNames, mesh=None):
    """The process group of this rank over the named dimensions, or None
    when they span one rank.  A joint dimension's group is made on first
    use (every rank must ask for it together), its ranks ordered row-major
    over the names."""
    import torch.distributed as dist

    mesh = _mesh(mesh)
    names = _names(axis_names)
    if axis_size(names, mesh) == 1:
        return None
    if _virtual(mesh):
        return mesh
    if len(names) == 1:
        return mesh.get_group(names[0])
    ranks = np.asarray(mesh.mesh.tolist())
    key = (tuple(mesh.mesh_dim_names), tuple(ranks.reshape(-1).tolist()), ranks.shape, names)
    if key not in _GROUPS:
        dims = [list(mesh.mesh_dim_names).index(a) for a in names]
        rest = [d for d in range(ranks.ndim) if d not in dims]
        lists = np.transpose(ranks, rest + dims).reshape(-1, axis_size(names, mesh)).tolist()
        _GROUPS[key] = dist.new_subgroups_by_enumeration(lists)[0]
    return _GROUPS[key]


def _virtual(mesh) -> bool:
    return getattr(mesh, "is_virtual", False)


def _wants_grad(x) -> bool:
    return torch.is_grad_enabled() and isinstance(x, torch.Tensor) and x.requires_grad


def _all_reduce(x, axis_names, op_name: str, mesh):
    import torch.distributed as dist

    g = group(axis_names, mesh)
    out = x.clone()
    if g is not None:
        dist.all_reduce(out, op=getattr(dist.ReduceOp, op_name), group=g)
    return out


class _Psum(torch.autograd.Function):
    """The sum over the dimension; the gradient passes through (g)."""

    @staticmethod
    def forward(ctx, x, names, mesh):
        return _all_reduce(x, names, "SUM", mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Pbroadcast(torch.autograd.Function):
    """The identity; the gradient summed over the dimension (f)."""

    @staticmethod
    def forward(ctx, x, names, mesh):
        ctx.names, ctx.mesh = names, mesh
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.names, "SUM", ctx.mesh), None, None


def psum(x, axis_names: AxisNames, mesh=None):
    """The sum over the dimension (an all-reduce); differentiable, with the
    identity for backward."""
    mesh = _mesh(mesh)
    _record("psum", x, _names(axis_names), mesh)
    if _virtual(mesh):
        return mesh.collective("psum", x, _names(axis_names))
    if _wants_grad(x):
        return _Psum.apply(x, _names(axis_names), mesh)
    return _all_reduce(x, axis_names, "SUM", mesh)


def pbroadcast(x, axis_names: AxisNames, mesh=None):
    """``x`` itself, read by every rank of the dimension: its gradient is
    summed over them (Megatron's "f", psum's partner)."""
    mesh = _mesh(mesh)
    if _virtual(mesh):
        return mesh.collective("pbroadcast", x, _names(axis_names))
    if _wants_grad(x) and axis_size(axis_names, mesh) > 1:
        return _Pbroadcast.apply(x, _names(axis_names), mesh)
    return x


def pmean(x, axis_names: AxisNames, mesh=None):
    return psum(x, axis_names, mesh) / axis_size(axis_names, mesh)


def pmax(x, axis_names: AxisNames, mesh=None):
    mesh = _mesh(mesh)
    _record("pmax", x, _names(axis_names), mesh)
    if _virtual(mesh):
        return mesh.collective("pmax", x, _names(axis_names))
    return _all_reduce(x, axis_names, "MAX", mesh)


def pmin(x, axis_names: AxisNames, mesh=None):
    mesh = _mesh(mesh)
    _record("pmin", x, _names(axis_names), mesh)
    if _virtual(mesh):
        return mesh.collective("pmin", x, _names(axis_names))
    return _all_reduce(x, axis_names, "MIN", mesh)


def gather_flat(x: torch.Tensor, g) -> torch.Tensor:
    """``[n * x.numel()]``: every member's contiguous ``x`` in group rank
    order (``x`` itself, flattened, for no group)."""
    import torch.distributed as dist

    x = x.contiguous().reshape(-1)
    if g is None:
        return x
    out = torch.empty(x.numel() * dist.get_world_size(g), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=g)
    return out


def _all_gather(x, names, axis: int, tiled: bool, mesh):
    n = axis_size(names, mesh)
    flat = gather_flat(x, group(names, mesh))
    parts = flat.reshape(n, *x.shape)
    if not tiled:
        return parts.movedim(0, axis).contiguous() if axis else parts.clone()
    return torch.cat(list(parts), dim=axis)


def _reduce_scatter(x, names, axis: int, mesh):
    import torch.distributed as dist

    n = axis_size(names, mesh)
    if x.shape[axis] % n:
        raise ValueError(f"reduce_scatter: dim {axis} of {tuple(x.shape)} not divisible by {n}")
    g = group(names, mesh)
    if g is None:
        return x.clone()
    moved = x.movedim(axis, 0).contiguous()
    out = torch.empty((moved.shape[0] // n, *moved.shape[1:]), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, moved, group=g)
    return out.movedim(0, axis).contiguous()


class _AllGather(torch.autograd.Function):
    """Every rank's ``x`` along ``axis`` (tiled or stacked); the backward
    reduce-scatters the gradient back to its owners."""

    @staticmethod
    def forward(ctx, x, names, axis, tiled, mesh):
        ctx.names, ctx.axis, ctx.tiled, ctx.mesh = names, axis, tiled, mesh
        return _all_gather(x, names, axis, tiled, mesh)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        summed = _reduce_scatter(g, ctx.names, ctx.axis, ctx.mesh)
        return (summed if ctx.tiled else summed.squeeze(ctx.axis)), None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    """The sum, scattered in tiles along ``axis``; the backward all-gathers
    the tiles' gradients."""

    @staticmethod
    def forward(ctx, x, names, axis, mesh):
        ctx.names, ctx.axis, ctx.mesh = names, axis, mesh
        return _reduce_scatter(x, names, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g.contiguous(), ctx.names, ctx.axis, True, ctx.mesh), None, None, None


class _AllGatherInvariant(torch.autograd.Function):
    """Every rank's ``x`` along ``axis``, read whole by every rank; the
    backward keeps this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, names, axis, mesh):
        ctx.names, ctx.axis, ctx.mesh, ctx.size = names, axis, mesh, x.shape[axis]
        return _all_gather(x, names, axis, True, mesh)

    @staticmethod
    def backward(ctx, g):
        i = axis_index(ctx.names, ctx.mesh)
        return g.narrow(ctx.axis, i * ctx.size, ctx.size).contiguous(), None, None, None


def all_gather(x, axis_names: AxisNames, axis: int = 0, tiled: bool = True, mesh=None):
    """Every rank's ``x`` along ``axis``: concatenated (``tiled``) or
    stacked on a new dimension at ``axis``; the backward reduce-scatters."""
    mesh = _mesh(mesh)
    names = _names(axis_names)
    _record("all_gather", x, names, mesh)
    if _virtual(mesh):
        return mesh.collective("all_gather", x, names, axis=axis, tiled=tiled)
    if _wants_grad(x):
        return _AllGather.apply(x.contiguous(), names, axis, tiled, mesh)
    return _all_gather(x, names, axis, tiled, mesh)


def all_gather_invariant(x, axis_names: AxisNames, axis: int = 0, mesh=None):
    """Every rank's ``x`` concatenated along ``axis``, a value every rank
    then reads whole (the vocab-sharded logits gathered for a loss every
    rank computes alike): the backward keeps this rank's slice."""
    mesh = _mesh(mesh)
    names = _names(axis_names)
    _record("all_gather", x, names, mesh)
    if _virtual(mesh):
        return mesh.collective("all_gather_invariant", x, names, axis=axis)
    if _wants_grad(x):
        return _AllGatherInvariant.apply(x.contiguous(), names, axis, mesh)
    return _all_gather(x, names, axis, True, mesh)


def reduce_scatter(x, axis_names: AxisNames, axis: int = 0, mesh=None):
    """The sum over the dimension, scattered in equal tiles along ``axis``:
    rank i keeps tile i (JAX ``psum_scatter(tiled=True)``); the backward
    all-gathers."""
    mesh = _mesh(mesh)
    names = _names(axis_names)
    _record("reduce_scatter", x, names, mesh)
    if _virtual(mesh):
        return mesh.collective("reduce_scatter", x, names, axis=axis)
    if _wants_grad(x):
        return _ReduceScatter.apply(x, names, axis, mesh)
    return _reduce_scatter(x, names, axis, mesh)


def _ppermute_ops(x, axis_name, perm, mesh):
    """Issue the sends and receives of a permutation: ``(out, works,
    local)`` (``local``: this rank's own shard where it maps to itself)."""
    import torch.distributed as dist

    me = axis_index(axis_name, mesh)
    g = group(axis_name, mesh)
    out = torch.zeros_like(x)
    ops, local = [], None
    for src, dst in perm:
        if src == me and dst == me:
            local = x
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(g, dst), g))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(g, src), g))
    works = dist.batch_isend_irecv(ops) if ops else []
    return out, works, local


def _ppermute(x, axis_name, perm, mesh):
    x = x.contiguous()
    if group(axis_name, mesh) is None:
        return x.clone() if any(s == d == 0 for s, d in perm) else torch.zeros_like(x)
    out, works, local = _ppermute_ops(x, axis_name, perm, mesh)
    for work in works:
        work.wait()
    if local is not None:
        out.copy_(local)
    return out


def _inverse(perm):
    return [(d, s) for s, d in perm]


class _Ppermute(torch.autograd.Function):
    """A permutation along one dimension; the backward permutes back.  With
    a ``pending`` list the forward returns before waiting on the
    exchange and leaves its waits there (:func:`ring_permute_start`)."""

    @staticmethod
    def forward(ctx, x, axis_name, perm, mesh, pending):
        ctx.axis_name, ctx.perm, ctx.mesh = axis_name, perm, mesh
        if pending is None:
            return _ppermute(x, axis_name, perm, mesh)
        out, works, local = _ppermute_ops(x.contiguous(), axis_name, perm, mesh)
        if local is not None:
            out.copy_(local)
        pending.extend(works)
        return out

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, ctx.axis_name, _inverse(ctx.perm), ctx.mesh), None, None, None, None


def ppermute(x, axis_name: str, perm: Sequence[tuple[int, int]], mesh=None):
    """Point-to-point permutation along one dimension: the rank at
    coordinate ``src`` sends ``x`` to ``dst`` for each ``(src, dst)``; a
    rank no pair sends to gets zeros.  The backward permutes back."""
    mesh = _mesh(mesh)
    perm = [tuple(p) for p in perm]
    if _virtual(mesh):
        return mesh.collective("ppermute", x, _names(axis_name), perm=perm)
    if _wants_grad(x) and group(axis_name, mesh) is not None:
        return _Ppermute.apply(x.contiguous(), axis_name, perm, mesh, None)
    return _ppermute(x, axis_name, perm, mesh)


def _ring_perm(n: int, shift: int) -> list:
    return [(i, (i + shift) % n) for i in range(n)]


def ring_permute(x, axis_name: str, shift: int = 1, mesh=None):
    """Rotate shards around the ring by ``shift``: coordinate i's shard
    lands on ``(i + shift) % n``."""
    n = axis_size(axis_name, mesh)
    return ppermute(x, axis_name, _ring_perm(n, shift), mesh)


def ring_permute_start(x, axis_name: str, shift: int = 1, mesh=None):
    """:func:`ring_permute` issued but not waited on: ``(out, wait)``, where
    ``out`` holds the neighbour's shard once ``wait()`` has returned.
    Work launched in between overlaps the exchange (on NCCL ``wait`` only
    orders the current stream after it)."""
    mesh = _mesh(mesh)
    if _virtual(mesh) or group(axis_name, mesh) is None:
        out = ring_permute(x, axis_name, shift, mesh)
        return out, lambda: None
    perm = _ring_perm(axis_size(axis_name, mesh), shift)
    pending: list = []
    if _wants_grad(x):
        out = _Ppermute.apply(x.contiguous(), axis_name, perm, mesh, pending)
    else:
        out, pending, _ = _ppermute_ops(x.contiguous(), axis_name, perm, mesh)

    def wait():
        for work in pending:
            work.wait()
        pending.clear()

    return out, wait


def _all_to_all(x, axis_name, split_axis: int, concat_axis: int, tiled: bool, mesh):
    import torch.distributed as dist

    n = axis_size(axis_name, mesh)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} not divisible by {n}")
    g = group(axis_name, mesh)
    chunks = [c.contiguous() for c in torch.chunk(x, n, dim=split_axis)]
    if g is None:
        received = [c.clone() for c in chunks]
    else:
        received = [torch.empty_like(c) for c in chunks]
        dist.all_to_all(received, chunks, group=g)
    if tiled:
        return torch.cat(received, dim=concat_axis)
    return torch.stack(received, dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    """The tiled exchange; the backward runs the inverse one."""

    @staticmethod
    def forward(ctx, x, axis_name, split_axis, concat_axis, mesh):
        ctx.args = (axis_name, concat_axis, split_axis, mesh)
        return _all_to_all(x, axis_name, split_axis, concat_axis, True, mesh)

    @staticmethod
    def backward(ctx, g):
        axis_name, split_axis, concat_axis, mesh = ctx.args
        return _all_to_all(g, axis_name, split_axis, concat_axis, True, mesh), None, None, None, \
            None


def all_to_all(x, axis_name: str, split_axis: int, concat_axis: int, tiled: bool = True,
               mesh=None):
    """Split ``x`` into n chunks along ``split_axis``, send chunk j to
    coordinate j, and concatenate the chunks received along
    ``concat_axis`` in coordinate order (``tiled``; else stacked on a new
    ``concat_axis``).  Tiled, the backward runs the inverse exchange."""
    mesh = _mesh(mesh)
    if _virtual(mesh):
        if not tiled:
            raise ValueError("a virtual mesh exchanges tiled all_to_alls only")
        return mesh.collective("all_to_all", x, _names(axis_name), split_axis=split_axis,
                               concat_axis=concat_axis)
    if tiled and _wants_grad(x):
        return _AllToAll.apply(x, axis_name, split_axis, concat_axis, mesh)
    return _all_to_all(x, axis_name, split_axis, concat_axis, tiled, mesh)


def joint_grad(output, inputs, mesh=None):
    """``torch.autograd.grad(output, inputs, allow_unused=True)`` for this
    rank.  On a virtual mesh every rank's graph meets the others' in the
    in-memory collectives, so the last rank to ask differentiates every
    rank's output at once (:class:`~.virtual.VirtualMesh`)."""
    mesh = _mesh(mesh)
    if _virtual(mesh):
        return mesh.collective("grad", (output, list(inputs)), tuple(mesh.mesh_dim_names))
    return list(torch.autograd.grad(output, list(inputs), allow_unused=True))


def broadcast_from(x, axis_name: str, src: int = 0, mesh=None):
    """The ``src`` coordinate's shard on every rank of the dimension."""
    import torch.distributed as dist

    n = axis_size(axis_name, mesh)
    if not 0 <= src < n:
        raise ValueError(f"broadcast_from src={src} out of range for axis "
                         f"{axis_name!r} of size {n}")
    g = group(axis_name, mesh)
    # bools ride as uint8 (gloo has no bool broadcast)
    out = x.to(torch.uint8) if x.dtype == torch.bool else x.clone()
    if g is not None:
        dist.broadcast(out, src=dist.get_global_rank(g, src), group=g)
    return out.bool() if x.dtype == torch.bool else out
