"""PowerSGD low-rank gradient compression with error feedback (mirrors
``accelerate_tpu/parallel/powersgd.py``).

The DDP PowerSGD communication hook (Vogels et al., NeurIPS 2019): each
rank compresses its *local* gradient into rank-``r`` factors, the ranks
all-reduce only the factors, and each decompresses the same average; a
per-rank error buffer feeds what the factors lost of that rank's gradient
back into its next step.

The JAX function runs inside a ``shard_map`` over the data-parallel axes;
here each rank holds its own gradient and the factors are averaged with
``parallel/collectives.pmean`` over the named axes (the process group, or
a :class:`~.virtual.VirtualMesh`).  Each rank keeps only its own residual,
``[*leaf.shape]``: the JAX package holds a ``[dp_size, *leaf.shape]``
array sharded over the dp axes, whose row ``r`` is rank ``r``'s residual
here.  The warm-start Q of leaf ``i`` is drawn from a ``torch.Generator``
seeded ``seed + i`` (JAX: ``jax.random.key(seed + i)``), identical on
every rank.

Eligibility: floating leaves with ndim >= 2 whose factor traffic beats the
dense leaf (``r*(n+m) < n*m``); everything else (biases, norm scales,
scalars) is averaged dense.  All math in f32; Gram–Schmidt is a reduced
QR (``torch.linalg.qr``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import collectives


def _matrix_view(shape) -> tuple[int, int]:
    """[n, m] view a leaf compresses through: dim 0 stays, the rest fold."""
    return int(shape[0]), int(np.prod(shape[1:]))


def _is_floating(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.is_floating_point()
    return np.issubdtype(np.asarray(leaf).dtype, np.floating)


def eligible(leaf, rank: int) -> bool:
    if not hasattr(leaf, "shape") or len(leaf.shape) < 2:
        return False
    if not _is_floating(leaf):
        return False
    n, m = _matrix_view(leaf.shape)
    return rank * (n + m) < n * m


def warm_start_q(rows: int, rank: int, seed: int, device=None) -> torch.Tensor:
    """The ``[rows, rank]`` f32 warm-start factor drawn from ``seed``."""
    gen = torch.Generator().manual_seed(int(seed))
    q = torch.randn((rows, rank), generator=gen, dtype=torch.float32)
    return q.to(device) if device is not None else q


def init_powersgd_state(params: dict, rank: int, seed: int = 0, device=None):
    """``(qs, errs)`` dicts keyed like ``params``: a warm-start Q ``[m, r]``
    for each eligible leaf (the same on every rank) and this rank's zero
    residual ``[*leaf.shape]``; ineligible leaves carry ``None`` in both."""
    qs, errs = {}, {}
    for i, (name, leaf) in enumerate(params.items()):
        if eligible(leaf, rank):
            _, m = _matrix_view(leaf.shape)
            dev = device if device is not None else getattr(leaf, "device", None)
            qs[name] = warm_start_q(m, rank, seed + i, dev)
            errs[name] = torch.zeros(tuple(leaf.shape), dtype=torch.float32, device=dev)
        else:
            qs[name] = errs[name] = None
    return qs, errs


def _orthonormalize(p: torch.Tensor) -> torch.Tensor:
    # reduced QR: the factor psum sums rank-r spans; an orthonormal P keeps
    # the projection well-conditioned across steps
    return torch.linalg.qr(p, mode="reduced")[0]


def _pmean(x: torch.Tensor, axis_names, mesh) -> torch.Tensor:
    return collectives.pmean(x, axis_names, mesh) if axis_names else x


def compress_decompress(grads: dict, qs: dict, errs: dict, axis_names, rank: int,
                        mesh=None):
    """This rank's gradients -> the average over ``axis_names`` of every
    rank's low-rank approximation.  Returns ``(grads_hat, new_qs,
    new_errs)`` keyed like ``grads``; ineligible leaves are averaged dense
    with ``None`` state.  Every rank must call this together, with the same
    leaves in the same order.  ``axis_names`` empty: a world of one (the
    codec still compresses)."""
    axis_names = tuple(axis_names)
    out_g, out_q, out_e = {}, {}, {}
    for name, g in grads.items():
        q = qs.get(name)
        if q is None:
            out_g[name], out_q[name], out_e[name] = _pmean(g, axis_names, mesh), None, None
            continue
        shape = g.shape
        n, m = _matrix_view(shape)
        mtx = g.float().reshape(n, m) + errs[name].reshape(n, m)
        p = _orthonormalize(_pmean(mtx @ q, axis_names, mesh))     # [n, r]
        q_local = mtx.T @ p                                        # [m, r], this rank's
        new_q = _pmean(q_local, axis_names, mesh)
        g_hat = p @ new_q.T                                        # [n, m], averaged
        # the residual is against this rank's own approximation: what the
        # factor average lost of *its* gradient comes back next step
        new_e = mtx - p @ q_local.T
        out_g[name] = g_hat.reshape(shape).to(g.dtype)
        out_q[name] = new_q
        out_e[name] = new_e.reshape(shape)
    return out_g, out_q, out_e


def wire_bytes_report(params, rank: int) -> dict:
    """Per-step all-reduce traffic: the dense reduction against the
    PowerSGD factor reductions (JAX's dict)."""
    dense = compressed = 0
    n_eligible = n_dense = 0
    leaves = params.values() if isinstance(params, dict) else params
    for leaf in leaves:
        if not hasattr(leaf, "shape"):
            continue
        size = int(np.prod(tuple(leaf.shape))) * 4
        dense += size
        if eligible(leaf, rank):
            n, m = _matrix_view(leaf.shape)
            # per step: the P reduction moves n*r floats, the Q one m*r
            compressed += rank * (n + m) * 4
            n_eligible += 1
        else:
            compressed += size
            n_dense += 1
    return {
        "dense_bytes_per_step": dense,
        "compressed_bytes_per_step": compressed,
        "ratio": compressed / max(dense, 1),
        "eligible_leaves": n_eligible,
        "dense_leaves": n_dense,
        "rank": rank,
    }


def residual_norms(errs: dict) -> dict:
    """``{name: ||residual||}`` of the leaves that carry one."""
    return {n: float(torch.linalg.vector_norm(e)) for n, e in errs.items()
            if e is not None}


__all__ = ["compress_decompress", "eligible", "init_powersgd_state", "residual_norms",
           "warm_start_q", "wire_bytes_report"]

