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
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

AxisNames = Union[str, Sequence[str]]

# (the mesh's names, ranks and shape, the axes) -> this rank's process
# group over those axes; emptied with the process group
_GROUPS: dict = {}


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
    return int(np.prod([sizes[a] for a in _names(axis_names)]))


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


def _all_reduce(x, axis_names, op_name: str, mesh):
    import torch.distributed as dist

    g = group(axis_names, mesh)
    out = x.clone()
    if g is not None:
        dist.all_reduce(out, op=getattr(dist.ReduceOp, op_name), group=g)
    return out


def psum(x, axis_names: AxisNames, mesh=None):
    """The sum over the dimension (an all-reduce)."""
    return _all_reduce(x, axis_names, "SUM", mesh)


def pmean(x, axis_names: AxisNames, mesh=None):
    return psum(x, axis_names, mesh) / axis_size(axis_names, mesh)


def pmax(x, axis_names: AxisNames, mesh=None):
    return _all_reduce(x, axis_names, "MAX", mesh)


def pmin(x, axis_names: AxisNames, mesh=None):
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


def all_gather(x, axis_names: AxisNames, axis: int = 0, tiled: bool = True, mesh=None):
    """Every rank's ``x`` along ``axis``: concatenated (``tiled``) or
    stacked on a new dimension at ``axis``."""
    n = axis_size(axis_names, mesh)
    flat = gather_flat(x, group(axis_names, mesh))
    parts = flat.reshape(n, *x.shape)
    if not tiled:
        return parts.movedim(0, axis).contiguous() if axis else parts.clone()
    return torch.cat(list(parts), dim=axis)


def reduce_scatter(x, axis_names: AxisNames, axis: int = 0, mesh=None):
    """The sum over the dimension, scattered in equal tiles along ``axis``:
    rank i keeps tile i (JAX ``psum_scatter(tiled=True)``)."""
    import torch.distributed as dist

    n = axis_size(axis_names, mesh)
    if x.shape[axis] % n:
        raise ValueError(f"reduce_scatter: dim {axis} of {tuple(x.shape)} not divisible by {n}")
    g = group(axis_names, mesh)
    if g is None:
        return x.clone()
    moved = x.movedim(axis, 0).contiguous()
    out = torch.empty((moved.shape[0] // n, *moved.shape[1:]), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, moved, group=g)
    return out.movedim(0, axis).contiguous()


def ppermute(x, axis_name: str, perm: Sequence[tuple[int, int]], mesh=None):
    """Point-to-point permutation along one dimension: the rank at
    coordinate ``src`` sends ``x`` to ``dst`` for each ``(src, dst)``; a
    rank no pair sends to gets zeros."""
    import torch.distributed as dist

    mesh = _mesh(mesh)
    me = axis_index(axis_name, mesh)
    g = group(axis_name, mesh)
    x = x.contiguous()
    if g is None:
        return x.clone() if any(s == d == 0 for s, d in perm) else torch.zeros_like(x)
    out = torch.zeros_like(x)
    ops, local = [], None
    for src, dst in perm:
        if src == me and dst == me:
            local = x
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(g, dst), g))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(g, src), g))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if local is not None:
        out.copy_(local)
    return out


def ring_permute(x, axis_name: str, shift: int = 1, mesh=None):
    """Rotate shards around the ring by ``shift``: coordinate i's shard
    lands on ``(i + shift) % n``."""
    n = axis_size(axis_name, mesh)
    return ppermute(x, axis_name, [(i, (i + shift) % n) for i in range(n)], mesh)


def all_to_all(x, axis_name: str, split_axis: int, concat_axis: int, tiled: bool = True,
               mesh=None):
    """Split ``x`` into n chunks along ``split_axis``, send chunk j to
    coordinate j, and concatenate the chunks received along
    ``concat_axis`` in coordinate order (``tiled``; else stacked on a new
    ``concat_axis``)."""
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
