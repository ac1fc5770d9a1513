"""Hierarchical intra-node -> inter-node gradient reduction for multi-node
data parallelism (mirrors ``accelerate_tpu/parallel/hierarchical.py``).

A launch over several nodes builds its mesh with an outermost ``dcn`` axis
(``parallelism_config.py``): ranks that differ only in their dcn
coordinate sit on different nodes, and traffic across that axis rides the
network between nodes.  A *flat* data-parallel all-reduce over the joint
``(dcn, dp_*)`` axes sends, after the intra-node reduction, ``p``
redundant full-size copies over that slow link.  The hierarchical
schedule runs three phases, each on the tier it belongs to:

1. **reduce-scatter inside the node** (``ici`` axes): each of the node's
   ``p`` ranks ends up owning the node's sum of a disjoint ``1/p`` slab
   of the gradient;
2. **all-reduce across ``dcn``**: each rank all-reduces only its slab, so
   the inter-node cut carries ``1/p`` of the flat schedule's bytes.
   Optionally the slab crosses PowerSGD-compressed (``powersgd.py``,
   rank-``r`` factors with a per-rank residual);
3. **all-gather inside the node**: the reduced slabs reassemble into the
   whole mean gradient.

The JAX axis names stay: ``ici`` is the fast tier inside a node (on the
H100, NVLink 4), ``dcn`` the network between nodes (one NDR InfiniBand
port per GPU).  Each rank holds its own gradients and calls the
collectives of ``parallel/collectives.py`` over the named axes (the
process group, or a :class:`~.virtual.VirtualMesh`).

The accounting twins follow ``tp_comm_accounting``:
:func:`dcn_comm_accounting` predicts each rank's DCN bytes from the
parameter shapes alone, and :func:`measure_dcn_bytes` prices the
collectives :func:`record_collectives` saw run over ``dcn`` (the JAX
package walks a traced program's jaxpr; an eager program is recorded as
it runs).  On a clean run the two agree exactly.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from . import collectives
from .powersgd import _is_floating, compress_decompress, warm_start_q

# A published link rate, not a measurement: one 400 Gb/s NDR InfiniBand
# port per GPU between nodes, 50 GB/s a direction (inside an H100 node,
# NVLink 4 gives 450 GB/s a direction: tp_comm_accounting's figure).
DCN_GBS_DEFAULT = 50.0


def ring_reduce_factor(d: int) -> float:
    """One ring all-reduce of ``b`` bytes over ``d`` members moves
    ``2 * b * (d-1)/d`` per member (reduce-scatter + all-gather halves)."""
    d = max(1, int(d))
    return 2.0 * (d - 1) / d if d > 1 else 0.0


# ---------------------------------------------------------------------------
# slab geometry: how a leaf lays out across the intra-node ring
# ---------------------------------------------------------------------------


def slab_geometry(leaf_size: int, ici_size: int) -> dict:
    """The slab layout of a leaf of ``leaf_size`` elements reduce-scattered
    over ``ici_size`` ranks: ``chunk`` is each rank's slab (the leaf
    zero-padded to ``padded`` so the ring divides it); ``rows`` x ``cols``
    the near-square view the PowerSGD codec compresses the slab through
    (zero-padded again to ``rows*cols``: exact under sums, and the padding
    lands in the residual like any other coordinate)."""
    p = max(1, int(ici_size))
    chunk = -(-int(leaf_size) // p)
    rows = max(1, int(math.isqrt(chunk)))
    cols = -(-chunk // rows)
    return {"size": int(leaf_size), "ici_size": p, "chunk": chunk,
            "padded": chunk * p, "rows": rows, "cols": cols}


def _numel(leaf) -> int:
    return int(np.prod(tuple(leaf.shape))) if len(leaf.shape) else 1


def slab_eligible(leaf, ici_size: int, rank: int) -> bool:
    """PowerSGD eligibility of a leaf's *slab*: floating dtype and factor
    traffic that beats the dense slab (``rank*(rows+cols) < rows*cols``)."""
    if not hasattr(leaf, "shape") or not _is_floating(leaf):
        return False
    g = slab_geometry(_numel(leaf), ici_size)
    return rank * (g["rows"] + g["cols"]) < g["rows"] * g["cols"]


def init_dcn_powersgd_state(params: dict, rank: int, ici_size: int, seed: int = 0,
                            device=None):
    """``(qs, errs)`` dicts keyed like ``params`` for the DCN codec: a
    warm-start Q ``[cols, rank]`` per eligible leaf (the same on every rank;
    leaf ``i`` from a generator seeded ``seed + i``) and this rank's zero
    slab residual ``[rows, cols]`` (JAX: ``[dp_world, rows, cols]`` sharded
    over the dp axes).  Ineligible leaves carry ``None`` in both."""
    qs, errs = {}, {}
    for i, (name, leaf) in enumerate(params.items()):
        if slab_eligible(leaf, ici_size, rank):
            g = slab_geometry(_numel(leaf), ici_size)
            dev = device if device is not None else getattr(leaf, "device", None)
            qs[name] = warm_start_q(g["cols"], rank, seed + i, dev)
            errs[name] = torch.zeros((g["rows"], g["cols"]), dtype=torch.float32, device=dev)
        else:
            qs[name] = errs[name] = None
    return qs, errs


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------


def hierarchical_sync(grads: dict, ici_axes: Sequence[str], dcn_axis: str = "dcn", *,
                      qs: Optional[dict] = None, errs: Optional[dict] = None, rank: int = 4,
                      mesh=None):
    """Mean-reduce this rank's gradients over the ``dcn`` x ``ici`` world
    with the three-phase schedule (the same result as the flat mean).

    Returns ``(mean_grads, new_qs, new_errs)`` keyed like ``grads``.  With
    ``qs`` / ``errs`` None the DCN hop is a dense slab all-reduce; a leaf
    with codec state (:func:`init_dcn_powersgd_state`, this rank's ``[rows,
    cols]`` residual) sends its slab through the PowerSGD codec instead,
    the residual carried to the next call.  Every rank calls this together.
    Axes of size 1 should be left out of ``ici_axes``."""
    ici_axes = tuple(ici_axes)
    p = collectives.axis_size(ici_axes, mesh) if ici_axes else 1
    d = collectives.axis_size(dcn_axis, mesh)
    world = p * d
    out_g, out_q, out_e = {}, {}, {}
    for name, g in grads.items():
        q = qs.get(name) if qs is not None else None
        shape, dtype = g.shape, g.dtype
        size = _numel(g)
        geo = slab_geometry(size, p)
        flat = g.float().reshape(-1)
        if geo["padded"] != size:
            flat = torch.nn.functional.pad(flat, (0, geo["padded"] - size))
        # phase 1: the node's sum, each rank keeping its 1/p slab
        slab = collectives.reduce_scatter(flat, ici_axes, axis=0, mesh=mesh) if p > 1 else flat
        new_q = new_e = None
        if q is not None:
            # phase 2, compressed: only the rank-r factors cross dcn; the
            # codec averages over the nodes and keeps what the factors lost
            # of this rank's slab for the next step
            mat_len = geo["rows"] * geo["cols"]
            mtx = slab if mat_len == geo["chunk"] else torch.nn.functional.pad(
                slab, (0, mat_len - geo["chunk"]))
            mtx = mtx.reshape(geo["rows"], geo["cols"])
            hat, nq, ne = compress_decompress({"s": mtx}, {"s": q}, {"s": errs[name]},
                                              (dcn_axis,), rank, mesh)
            new_q, new_e = nq["s"], ne["s"]
            # averaged over dcn; / p makes it the world mean
            slab = hat["s"].reshape(-1)[: geo["chunk"]] / p
        else:
            # phase 2, dense: the slab, not the whole gradient, crosses dcn
            slab = collectives.psum(slab, dcn_axis, mesh) / world
        # phase 3: reassemble inside the node
        full = collectives.all_gather(slab, ici_axes, axis=0, tiled=True, mesh=mesh) \
            if p > 1 else slab
        out_g[name] = full[:size].reshape(shape).to(dtype)
        out_q[name], out_e[name] = new_q, new_e
    return out_g, out_q, out_e


# ---------------------------------------------------------------------------
# predicted / measured accounting twins (the tp_comm_accounting pattern)
# ---------------------------------------------------------------------------


def dcn_comm_accounting(params, *, ici_size: int, dcn_size: int,
                        compression: Optional[str] = None, rank: int = 4,
                        dtype_bytes: int = 4, dcn_gbs: float = DCN_GBS_DEFAULT,
                        step_compute_s: Optional[float] = None) -> dict:
    """Predicted DCN bytes a rank moves a step: hierarchical against flat.

    Per rank, a ring all-reduce over ``d`` nodes moving ``2*(d-1)/d`` of
    its operand: the *flat* schedule all-reduces the whole gradient across
    ``dcn``; the *hierarchical* one only this rank's ``1/ici_size`` slab
    (padding included), and under ``compression='powersgd'`` an eligible
    leaf's slab as its factors (``rank*(rows+cols)`` f32).
    ``dcn_s_per_step`` prices the bytes at ``dcn_gbs`` GB/s (1e9 bytes);
    ``dcn_overlap_frac`` is the share of the hop ``step_compute_s`` of
    compute could hide.  ``dcn_size <= 1`` gives zeros.  Records the
    predicted side of the ``dcn_comm.dcn_bytes`` twin."""
    d = max(1, int(dcn_size))
    p = max(1, int(ici_size))
    factor = ring_reduce_factor(d)
    total_bytes = hier_bytes = 0
    n_eligible = n_dense = 0
    leaves = params.values() if isinstance(params, dict) else params
    for leaf in leaves:
        if not hasattr(leaf, "shape"):
            continue
        size = _numel(leaf)
        total_bytes += size * dtype_bytes
        geo = slab_geometry(size, p)
        if compression == "powersgd" and slab_eligible(leaf, p, rank):
            hier_bytes += rank * (geo["rows"] + geo["cols"]) * dtype_bytes
            n_eligible += 1
        else:
            hier_bytes += geo["chunk"] * dtype_bytes
            n_dense += 1
    dcn_bytes = int(factor * hier_bytes)
    dcn_bytes_flat = int(factor * total_bytes)
    dcn_s = dcn_bytes / (dcn_gbs * 1e9) if d > 1 else 0.0
    if d <= 1:
        overlap = 0.0
    elif step_compute_s is None or dcn_s <= 0:
        overlap = 1.0 if dcn_s <= 0 else 0.0
    else:
        overlap = min(1.0, step_compute_s / dcn_s)
    from ..telemetry import twin_registry

    twin_registry().record_predicted("dcn_comm.dcn_bytes", dcn_bytes,
                                     source="parallel/hierarchical.dcn_comm_accounting")
    return {
        "dcn_size": d,
        "ici_size": p,
        "compression": compression,
        "rank": rank if compression == "powersgd" else None,
        "dcn_bytes": dcn_bytes,
        "dcn_bytes_flat": dcn_bytes_flat,
        "ratio": dcn_bytes / max(dcn_bytes_flat, 1),
        "eligible_leaves": n_eligible,
        "dense_leaves": n_dense,
        "dcn_s_per_step": round(dcn_s, 9),
        "dcn_overlap_frac": round(overlap, 4),
        "kind": "predicted",
    }


class CollectiveRecord:
    """The collectives run while :func:`record_collectives` is open: one
    row each, ``{"rank", "kind", "axes", "operand_bytes"}`` (``rank``: the
    virtual rank, or this process's)."""

    def __init__(self):
        self.rows: list = []
        self._lock = threading.Lock()

    def add(self, kind: str, axes: tuple, x: torch.Tensor, mesh, rank=None) -> None:
        """One collective of ``rank`` (the calling rank's by default: a
        virtual mesh's running rank, else this process's)."""
        if rank is None and getattr(mesh, "is_virtual", False):
            rank = mesh.rank
        elif rank is None:
            from ..state import world

            rank = world()[1]
        row = {"rank": rank, "kind": kind, "axes": tuple(axes),
               "operand_bytes": x.numel() * x.element_size()}
        with self._lock:
            self.rows.append(row)


@contextlib.contextmanager
def record_collectives():
    """Record every collective of ``parallel/collectives.py`` run inside the
    block (one ``None`` check on the path when no recording is open)."""
    rec = CollectiveRecord()
    saved, collectives._RECORDER = collectives._RECORDER, rec
    try:
        yield rec
    finally:
        collectives._RECORDER = saved


def measure_dcn_bytes(record: CollectiveRecord, *, dcn_axis: str = "dcn", dcn_size: int,
                      rank: Optional[int] = None) -> dict:
    """Measured twin: the DCN bytes one rank's recorded collectives moved
    (``rank``: the lowest recorded by default).  Each collective whose axes
    include ``dcn_axis`` costs, per JAX's primitives, a psum
    ``2*(d-1)/d`` of its operand bytes, an all-gather ``(d-1)`` times, a
    reduce-scatter ``(d-1)/d``; comparable to :func:`dcn_comm_accounting`'s
    ``dcn_bytes``.  Records the measured side of ``dcn_comm.dcn_bytes``."""
    d = max(1, int(dcn_size))
    ranks = sorted({r["rank"] for r in record.rows})
    if rank is None:
        rank = ranks[0] if ranks else 0
    per_rank: dict = {}
    rows = []
    for r in record.rows:
        if dcn_axis not in r["axes"]:
            continue
        nbytes = r["operand_bytes"]
        if r["kind"] == "all_gather":
            cost = (d - 1) * nbytes
        elif r["kind"] == "reduce_scatter":
            cost = (d - 1) / d * nbytes
        else:  # psum / all-reduce family
            cost = ring_reduce_factor(d) * nbytes
        per_rank[r["rank"]] = per_rank.get(r["rank"], 0.0) + cost
        if r["rank"] == rank:
            rows.append({"primitive": r["kind"], "axes": r["axes"],
                         "operand_bytes": nbytes, "dcn_bytes": int(cost)})
    total = int(per_rank.get(rank, 0.0))
    from ..telemetry import twin_registry

    twin_registry().record_measured("dcn_comm.dcn_bytes", total,
                                    source="parallel/hierarchical.measure_dcn_bytes")
    return {"dcn_bytes": total, "dcn_size": d, "collectives": rows,
            "per_rank": {k: int(v) for k, v in per_rank.items()}, "kind": "measured"}
