"""Ring collective matmul: the tensor- and sequence-parallel collectives
inside the products they feed (mirrors
``accelerate_tpu/ops/collective_matmul.py``).

A monolithic all-gather must end before the product that reads it starts,
and a reduce-scatter cannot start before the product that feeds it ends.
Decomposed into ring hops over the ring axis, each hop's exchange rides
under the product of the chunk a rank already holds (Pope et al. 2022;
Wang et al. 2023).  Each rank runs the bodies below on its own shards;
a hop's ``batch_isend_irecv`` is issued before the chunk's product and
waited on after it (``parallel/collectives.ring_permute_start``), so on
NCCL the hop can run under the product.  The chunk products are
``F.linear`` (cuBLAS on the card): the JAX package computes them outside
any Pallas kernel.  Gradients come from autograd through the
differentiable ring permute, as ``jax.grad`` goes through ``ppermute``.

Two schedules, the Megatron column / row split (``parallel/sharding.py``
``TRANSFORMER_TP_RULES``), weights in the port's ``[out, in]`` layout:

- **all-gather -> matmul** (column entry): ``x`` ``[B, T/p, K]``
  (sequence-sharded over the ring), ``w`` ``[N/p, K]`` (the rank's rows of
  the output features) -> ``[B, T, N/p]``;
- **matmul -> reduce-scatter** (row exit): ``x`` ``[B, T, K/p]``
  (contraction-sharded), ``w`` ``[N, K/p]`` -> ``[B, T/p, N]``, the
  rank's fully reduced sequence chunk.

The bidirectional ring sends two opposing streams, ``ceil((p - 1) / 2)``
hops deep.  The mode (``off`` / ``ring`` / ``bidir``) is the
``FullyShardedDataParallelPlugin.collective_matmul`` knob the Accelerator
installs, the env ``ACCELERATE_COLLECTIVE_MATMUL``, or the
:func:`collective_matmul` context manager; it is read when a forward
runs.  JAX's clause for old ``shard_map`` versions has no meaning here and
is dropped from :func:`ring_supported`.
"""

from __future__ import annotations

import functools
import os
from contextlib import contextmanager
from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel import collectives as C

MODES = ("off", "ring", "bidir")

# the mode override (None: the env default); set by the Accelerator from
# the plugin knob or by the collective_matmul context manager
_MODE_OVERRIDE: list = [None]

_NORMALIZE = {
    "off": "off", "false": "off", "0": "off", "none": "off", "": "off",
    "on": "ring", "ring": "ring", "true": "ring", "1": "ring", "uni": "ring",
    "bidir": "bidir", "bidirectional": "bidir",
}


def normalize_mode(mode) -> str:
    """Canonical mode string ('off' | 'ring' | 'bidir') or ValueError."""
    norm = _NORMALIZE.get(str(mode).strip().lower())
    if norm is None:
        raise ValueError(
            f"collective_matmul mode {mode!r} not one of "
            f"{sorted(set(_NORMALIZE))} (canonical: {MODES})"
        )
    return norm


def set_collective_matmul(mode: Optional[str]) -> Optional[str]:
    """Set the ambient mode (``None`` clears back to the env default).
    Returns the previous override."""
    prev = _MODE_OVERRIDE[0]
    _MODE_OVERRIDE[0] = None if mode is None else normalize_mode(mode)
    return prev


def collective_matmul_mode() -> str:
    """The effective mode: explicit override, else env
    ``ACCELERATE_COLLECTIVE_MATMUL``, else 'off'."""
    if _MODE_OVERRIDE[0] is not None:
        return _MODE_OVERRIDE[0]
    return normalize_mode(os.environ.get("ACCELERATE_COLLECTIVE_MATMUL", "off"))


@contextmanager
def collective_matmul(mode: str):
    """Scoped mode override (test and A/B harnesses)."""
    prev = set_collective_matmul(mode)
    try:
        yield
    finally:
        _MODE_OVERRIDE[0] = prev


def ring_supported(mesh, axis_name: str) -> bool:
    """Whether the ring path is usable on ``mesh`` over ``axis_name``: the
    axis exists and spans more than one rank (a trivial ring has nothing
    to hide)."""
    if mesh is None:
        return False
    sizes = C.mesh_sizes(mesh)
    return sizes.get(axis_name, 1) > 1


# ---------------------------------------------------------------------------
# the bodies, on this rank's shards
# ---------------------------------------------------------------------------


def linear(x, w, out_dtype: Optional[torch.dtype] = None):
    """``x @ w.T`` for ``w`` ``[N, K]``; with ``out_dtype=torch.float32``
    on narrower operands, accumulated and returned in f32 (one cuBLAS GEMM
    writing f32 on the card, the operands widened on the CPU)."""
    if out_dtype is None or out_dtype == x.dtype:
        return F.linear(x, w)
    if out_dtype != torch.float32:
        raise ValueError(f"out_dtype must be None or torch.float32, got {out_dtype}")
    if x.device.type == "cuda":
        from ..models.llama import _F32Logits

        shape = x.shape[:-1]
        return _F32Logits.apply(x.reshape(-1, x.shape[-1]), w).reshape(*shape, -1)
    return F.linear(x.float(), w.float())


def ring_all_gather_matmul(x, w, axis_name: str, *, bidirectional: bool = False,
                           out_dtype: Optional[torch.dtype] = None, mesh=None):
    """``all_gather(x, seq) @ w.T`` as a ring of chunk products.  ``x``
    ``[B, T/p, K]``, ``w`` ``[N/p, K]``; returns ``[B, T, N/p]``.  Each
    hop is issued before the resident chunk's product and waited on after
    it; the chunks are the monolithic product's rows, computed chunk by
    chunk (no reduction reordered)."""
    p = C.axis_size(axis_name, mesh)
    i = C.axis_index(axis_name, mesh)
    outs: list = [None] * p
    if not bidirectional:
        cur = x
        for s in range(p):
            if s + 1 < p:
                nxt, wait = C.ring_permute_start(cur, axis_name, 1, mesh=mesh)
            outs[(i - s) % p] = linear(cur, w, out_dtype)
            if s + 1 < p:
                wait()
                cur = nxt
        return torch.cat(outs, dim=1)
    hops = p // 2                        # ceil((p - 1) / 2) opposing hops
    fwd = bwd = x
    if hops:
        f_next, f_wait = C.ring_permute_start(fwd, axis_name, 1, mesh=mesh)
        b_next, b_wait = C.ring_permute_start(bwd, axis_name, -1, mesh=mesh)
    outs[i] = linear(x, w, out_dtype)
    for s in range(1, hops + 1):
        f_wait()
        b_wait()
        fwd, bwd = f_next, b_next
        if s < hops:
            f_next, f_wait = C.ring_permute_start(fwd, axis_name, 1, mesh=mesh)
            b_next, b_wait = C.ring_permute_start(bwd, axis_name, -1, mesh=mesh)
        outs[(i - s) % p] = linear(fwd, w, out_dtype)
        if (2 * s) % p != 0:             # even p: the final hop's two shards coincide
            outs[(i + s) % p] = linear(bwd, w, out_dtype)
    return torch.cat(outs, dim=1)


def ring_matmul_reduce_scatter(x, w, axis_name: str, *, bidirectional: bool = False,
                               out_dtype: Optional[torch.dtype] = None, mesh=None):
    """``reduce_scatter(x @ w.T, seq)`` as a ring of accumulators.  ``x``
    ``[B, T, K/p]``, ``w`` ``[N, K/p]``; returns ``[B, T/p, N]``, the
    rank's reduced sequence chunk.  The accumulator made at rank ``d``
    targets chunk ``(d - 1) % p`` and takes one local partial a hop; the
    next chunk's product runs while the accumulator is in flight.
    ``bidirectional`` splits the partials between two opposing
    accumulators."""
    p = C.axis_size(axis_name, mesh)
    i = C.axis_index(axis_name, mesh)
    tc = x.shape[1] // p

    def chunk_mm(c):
        return linear(x[:, c * tc:(c + 1) * tc], w, out_dtype)

    def chain(acc, hops, shift, chunk_of):
        for s in range(1, hops + 1):
            flight, wait = C.ring_permute_start(acc, axis_name, shift, mesh=mesh)
            part = chunk_mm(chunk_of(s))            # the product overlaps the hop
            wait()
            acc = flight + part
        return acc

    if not bidirectional:
        return chain(chunk_mm((i - 1) % p), p - 1, 1, lambda s: (i - s - 1) % p)
    hf = p // 2                  # ceil((p - 1) / 2) forward hops
    hb = (p - 1) // 2            # the rest travel backward
    facc = chain(chunk_mm((i + hf) % p), hf, 1, lambda s: (i - s + hf) % p)
    if hb == 0:
        return facc
    bacc = chain(chunk_mm((i - hb) % p), hb - 1, -1, lambda s: (i + s - hb) % p)
    bacc = C.ring_permute(bacc, axis_name, -1, mesh=mesh)   # the target adds nothing
    return facc + bacc


def all_gather_matmul_monolithic(x, w, axis_name: str, *,
                                 out_dtype: Optional[torch.dtype] = None, mesh=None):
    """The baseline body: one blocking gather of the sequence, then the
    product."""
    return linear(C.all_gather(x, axis_name, axis=1, mesh=mesh), w, out_dtype)


def matmul_reduce_scatter_monolithic(x, w, axis_name: str, *,
                                     out_dtype: Optional[torch.dtype] = None, mesh=None):
    """The baseline body: the whole partial product, then one blocking
    scatter of the sequence."""
    return C.reduce_scatter(linear(x, w, out_dtype), axis_name, axis=1, mesh=mesh)


# ---------------------------------------------------------------------------
# the mesh-bound entry and the layer hook
# ---------------------------------------------------------------------------


def make_collective_dense(mesh, axis_name: str = "tp", kind: str = "column",
                          mode: str = "ring", out_dtype: Optional[torch.dtype] = None):
    """``fn(x, w)`` over ``mesh``'s ``axis_name`` on this rank's shards:
    ``kind='column'`` the all-gather -> matmul, ``'row'`` the matmul ->
    reduce-scatter (shapes in the module doc).  ``mode``: 'ring' | 'bidir'
    | 'monolithic' (the A/B baseline on the same shards)."""
    if kind not in ("column", "row"):
        raise ValueError(f"kind must be 'column' or 'row', got {kind!r}")
    if mode == "monolithic":
        body = (all_gather_matmul_monolithic if kind == "column"
                else matmul_reduce_scatter_monolithic)
        return functools.partial(body, axis_name=axis_name, out_dtype=out_dtype, mesh=mesh)
    body = ring_all_gather_matmul if kind == "column" else ring_matmul_reduce_scatter
    return functools.partial(body, axis_name=axis_name, bidirectional=(mode == "bidir"),
                             out_dtype=out_dtype, mesh=mesh)


def _ambient_mesh():
    from ..state import ambient_mesh

    return ambient_mesh()[0]


def _shapes_divide(x, w, kind: str, p: int) -> bool:
    """Whether this rank's operands fit the ring: ``x`` 3-D, ``w`` 2-D,
    the contraction dims equal, and for the row ring a sequence that
    splits into ``p`` chunks."""
    if x.ndim != 3 or w.ndim != 2 or x.shape[-1] != w.shape[1]:
        return False
    if kind == "row":
        t = x.shape[1]
        return t % p == 0 and t >= p
    return x.shape[1] >= 1


def dense_collective_matmul(x, w, kind: str, *, axis_name: str = "tp",
                            out_dtype: Optional[torch.dtype] = None):
    """The tensor-parallel layer hook: this rank's ``x @ w.T`` through the
    ring schedule, or ``None`` where the caller takes its plain path (JAX
    :315): the mode is off, no mesh is ambient, the ring axis is trivial,
    the kind is neither 'column' nor 'row', or the operands do not fit
    the ring (:func:`_shapes_divide`)."""
    mode = collective_matmul_mode()
    if mode == "off" or kind not in ("column", "row"):
        return None
    mesh = _ambient_mesh()
    if not ring_supported(mesh, axis_name):
        return None
    if not _shapes_divide(x, w, kind, C.axis_size(axis_name, mesh)):
        return None
    return make_collective_dense(mesh, axis_name, kind, mode, out_dtype)(x, w)


def ulysses_sp_boundary(num_heads: int, num_kv_heads: int, seq_len: int,
                        axis_name: str = "sp") -> bool:
    """Whether the Ulysses attention boundary runs as collective matmuls
    over ``sp`` (JAX :338): the q/k/v projections as column rings that
    gather the sequence while slicing heads (all_to_all #1 absorbed), and
    o_proj as a row ring that scatters the sequence back (all_to_all #2).
    Needs the mode on, a ring over ``sp``, a trivial ``tp`` (composed sp x
    tp keeps the all_to_alls), and both head counts and the global
    ``seq_len`` dividing ``sp``."""
    if collective_matmul_mode() == "off":
        return False
    mesh = _ambient_mesh()
    if not ring_supported(mesh, axis_name):
        return False
    sizes = C.mesh_sizes(mesh)
    if sizes.get("tp", 1) > 1:
        return False
    sp = sizes[axis_name]
    return num_heads % sp == 0 and num_kv_heads % sp == 0 and seq_len % sp == 0


# ---------------------------------------------------------------------------
# overlap accounting (predicted)
# ---------------------------------------------------------------------------

# The card's own figures: an H100 SXM's NVLink 4 carries 450 GB/s in each
# direction (900 GB/s both ways, NVIDIA's H100 SXM specification), and its
# dense bf16 tensor-core peak is 989 TFLOP/s.
H100_NVLINK_GBS = 450.0
H100_BF16_FLOPS = 989e12


def tp_comm_accounting(m_tokens: int, k: int, n: int, ring_size: int, *,
                       dtype_bytes: int = 2, bidirectional: bool = False,
                       link_gbs: float = H100_NVLINK_GBS,
                       peak_flops: float = H100_BF16_FLOPS) -> dict:
    """Predicted hideable share of a ring's link traffic for an
    all-gather -> matmul of ``[m_tokens, k] @ [k, n]`` over a
    ``ring_size`` ring (JAX's formula): a tick's product (``2 * m/p * k *
    ceil(n/p)`` FLOPs) runs while one hop (``m/p * k`` elements) is in
    flight, hidden when its wire time fits under the product's.  Defaults
    are an H100 SXM's (``link_gbs`` GB/s a direction, ``peak_flops``);
    a bidirectional ring halves the hop count, not a hop's time.  Records
    the prediction as the ``tp_comm.overlap_frac`` twin."""
    p = max(1, int(ring_size))
    if p == 1:
        return {
            "ring_size": 1, "steps": 0, "bytes_per_hop": 0,
            "mm_s_per_step": 0.0, "comm_s_per_step": 0.0,
            "tp_overlap_frac": 0.0, "kind": "predicted",
        }
    steps = p // 2 if bidirectional else p - 1
    bytes_per_hop = (m_tokens // p) * k * dtype_bytes
    mm_flops_per_step = 2 * (m_tokens // p) * k * (-(-n // p))
    mm_s = mm_flops_per_step / peak_flops
    comm_s = bytes_per_hop / (link_gbs * 1e9)
    overlap = 1.0 if comm_s <= 0 else min(1.0, mm_s / comm_s)
    from ..telemetry import twin_registry

    twin_registry().record_predicted(
        "tp_comm.overlap_frac", overlap,
        source="ops/collective_matmul.tp_comm_accounting",
    )
    return {
        "ring_size": p,
        "steps": steps,
        "bytes_per_hop": int(bytes_per_hop),
        "mm_s_per_step": round(mm_s, 9),
        "comm_s_per_step": round(comm_s, 9),
        "tp_overlap_frac": round(overlap, 4),
        "kind": "predicted",
    }
