"""Host-to-device streaming: byte accounting, the layer prefetcher and the
chunked optimizer offload's pieces (mirrors ``accelerate_tpu/ops/streaming.py``:
``tree_bytes`` :64, ``HOST_BYTES_PER_PARAM`` :81, ``StreamStats`` :92,
``predicted_overlap`` :148, ``offload_transfer_accounting`` :156,
``chunk_groups`` :208, ``slice_congruent`` :244, ``merge_congruent`` :261,
``stage_put`` :284, ``LayerPrefetcher`` :304).

On the card an upload is a copy from pinned host memory with
``non_blocking=True`` on a side CUDA stream (:func:`stage_tree`): the
copy runs while the compute stream works, an event marks its end, and
:meth:`StagedTree.wait` makes the compute stream (not the host) wait on
that event before the tree is read.  On the CPU a "staged" tree is the
host tree itself.  ``generation.generate_streamed`` streams a model's
layers through the prefetcher.  The ZeRO-offload train step
(``Accelerator`` with ``FullyShardedDataParallelPlugin(cpu_offload=True)``)
splits its host update into :func:`chunk_groups`, slices and merges the
optimizer state over them (:func:`slice_congruent`,
:func:`merge_congruent`) and stages each chunk's gradients device-to-host
with :func:`stage_put`; :func:`offload_transfer_accounting` predicts its
bytes.

A tensor in host memory that is not page-locked (an ``OffloadStore``
memory map: the disk tier) goes through :class:`PinnedStaging` first: its
bytes land in a reusable page-locked slot, from which the card's copy is
asynchronous; ``generate_streamed`` and ``hooks.AlignDevicesHook`` share
it.  The streamed decode fills the slot by a (multi-threaded) copy through
the memory map: once faulted in, the map's pages are a memory copy away,
where a ``pread`` would re-read the file every forward
(``chip_smoke.py`` times both, the streamed case's ``staging_gb_s``).  The
hook's ``io_buffer`` keeps JAX's meaning: the native engine's parallel
``pread`` of the file (:func:`file_span`).
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
import weakref
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from ..resilience.faults import maybe_fail_transfer
from ..resilience.retry import DEFAULT_POLICY, RetryPolicy, with_retries

# ---------------------------------------------------------------------------
# Byte accounting
# ---------------------------------------------------------------------------


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def tree_bytes(tree) -> int:
    """Total payload bytes of a tree's tensor / numpy leaves (nested dicts,
    lists and tuples; a :class:`StagedTree` counts its device tree)."""
    if isinstance(tree, StagedTree):
        tree = tree.tree
    total = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif hasattr(leaf, "nbytes"):
            total += int(leaf.nbytes)
    return total


# Host bytes touched per param per offloaded step, by optimizer recipe (the
# JAX package's host-byte ladder; the denominator of the per-adapter state
# accounting in ``ops/lora.py``).
HOST_BYTES_PER_PARAM: dict[str, float] = {
    "adamw": 28.0,
    "lion": 16.0,
    "adamw-sr": 14.0,
    "lion-sr": 10.0,
    "adamw-sr8": 10.1,
    "lion-sr8": 8.1,
}


@dataclasses.dataclass
class StreamStats:
    """Overlap accounting for one streaming run (JAX's fields).

    ``h2d_bytes``/``d2h_bytes`` are exact (summed from leaf bytes);
    ``fetch_wait_s`` is the host time spent waiting on an in-flight
    transfer — on the card the compute stream waits on the copy's event and
    the host does not, so it stays near 0 there; ``prefetch_hits`` counts
    fetches that were already in flight when requested.  ``ici_bytes`` /
    ``tp_overlap_frac`` carry a ring collective matmul's bytes permuted a
    step and its predicted hidden share
    (``ops/collective_matmul.tp_comm_accounting``); they join the report
    only when set."""

    h2d_bytes: int = 0
    d2h_bytes: int = 0
    fetches: int = 0
    prefetch_hits: int = 0
    fetch_wait_s: float = 0.0
    wall_s: float = 0.0
    ici_bytes: int = 0
    tp_overlap_frac: Optional[float] = None
    transfer_retries: int = 0

    def overlap_report(self, serial_transfer_s: Optional[float] = None) -> dict:
        rep = {
            "h2d_bytes": int(self.h2d_bytes),
            "d2h_bytes": int(self.d2h_bytes),
            "fetches": self.fetches,
            "prefetch_hits": self.prefetch_hits,
            "fetch_wait_s": round(self.fetch_wait_s, 4),
            "wall_s": round(self.wall_s, 4),
        }
        if self.wall_s > 0:
            rep["stall_frac"] = round(self.fetch_wait_s / self.wall_s, 4)
        if serial_transfer_s:
            rep["overlap_frac"] = round(
                max(0.0, 1.0 - self.fetch_wait_s / serial_transfer_s), 4
            )
        if self.ici_bytes:
            rep["ici_bytes"] = int(self.ici_bytes)
        if self.tp_overlap_frac is not None:
            rep["tp_overlap_frac"] = round(self.tp_overlap_frac, 4)
        if self.transfer_retries:
            rep["transfer_retries"] = self.transfer_retries
        return rep


def predicted_overlap(transfer_s: float, compute_s: float) -> float:
    """Fraction of serial transfer time a perfect double buffer hides: the
    transfer can only disappear under compute that exists to hide it."""
    if transfer_s <= 0:
        return 1.0
    return min(1.0, max(0.0, compute_s / transfer_s))


# ---------------------------------------------------------------------------
# Staging on a side stream
# ---------------------------------------------------------------------------


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


@dataclasses.dataclass
class StagedTree:
    """A device tree whose upload may still be in flight: ``event`` marks
    the end of its copy on the side stream (None on the CPU), ``source``
    holds the pinned host tensors the copy reads until it has ended."""

    tree: Any
    event: Optional[torch.cuda.Event] = None
    source: Any = None
    device: Optional[torch.device] = None
    start: Optional[torch.cuda.Event] = None   # a timed stage's start (stage_put)

    def copy_ms(self) -> float:
        """The stage's copy time on its stream (a timed stage whose copy
        has ended; 0 for one on the CPU)."""
        return self.start.elapsed_time(self.event) if self.start is not None else 0.0

    def wait(self) -> Any:
        """Make the current stream wait on the copy (the host does not
        wait) and return the device tree."""
        if self.event is not None:
            torch.cuda.current_stream(self.device).wait_event(self.event)
        return self.tree

    def wait_host(self) -> Any:
        """Block the host until the copy has ended (a device-to-host stage
        read by host code) and return the tree."""
        if self.event is not None:
            self.event.synchronize()
        return self.tree

    def done(self) -> bool:
        return self.event is None or self.event.query()


_SIDE_STREAMS: dict = {}


def _side_stream(device: torch.device):
    key = device.index if device.index is not None else torch.cuda.current_device()
    if key not in _SIDE_STREAMS:
        _SIDE_STREAMS[key] = torch.cuda.Stream(device=key)
    return _SIDE_STREAMS[key]


def stage_tree(host_tree, device) -> StagedTree:
    """Start the upload of ``host_tree`` (nested dict of CPU tensors) to
    ``device``.  On the card: each leaf is pinned (a copy, unless it already
    is), the device buffers are allocated on the current stream, and the
    copies run with ``non_blocking=True`` on a side stream that first waits
    for the current stream; each buffer is marked as used by the side
    stream, so the allocator never hands it out while its copy is in
    flight, even if the staged tree is dropped unread.  On the CPU the
    tree is returned as it is."""
    device = torch.device(device)
    if device.type != "cuda":
        return StagedTree(_map(host_tree, lambda t: t.to(device)))
    source = _map(host_tree, lambda t: t if t.is_pinned() else t.pin_memory())
    dest = _map(source, lambda t: torch.empty(t.shape, dtype=t.dtype, device=device))
    side = _side_stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for src, dst in zip(_leaves(source), _leaves(dest)):
            dst.copy_(src, non_blocking=True)
            dst.record_stream(side)
        event = torch.cuda.Event()
        event.record(side)
    return StagedTree(dest, event, source, device)


# ---------------------------------------------------------------------------
# The chunked optimizer offload
# ---------------------------------------------------------------------------


def offload_transfer_accounting(n_params: int, *, optimizer: str = "lion-sr",
                                grad_bytes_per_param: int = 2, fetch_bytes_per_param: int = 2,
                                offload_params: bool = True, host_rate_gibs: float = 1.61,
                                pcie_rate_gibs: float = 8.0) -> dict:
    """The offloaded update's predicted bytes and overlap a step (JAX
    :156): ``d2h_bytes`` the gradients at their width, ``h2d_bytes`` the
    compute-width param fetch (0 when the params stay on the card), the
    host update's bytes from the recipe's row of
    :data:`HOST_BYTES_PER_PARAM`; times from the given host and PCIe
    rates (JAX's defaults; the port's chip run reports its own), and the
    share of the transfer a perfect pipeline hides under the host update.
    Recorded as the predicted side of the ``offload_transfer.overlap_frac``
    twin."""
    d2h = n_params * grad_bytes_per_param
    h2d = n_params * fetch_bytes_per_param if offload_params else 0
    host_b = n_params * HOST_BYTES_PER_PARAM.get(optimizer, 16.0)
    transfer_s = (d2h + h2d) / (pcie_rate_gibs * 2**30)
    host_s = host_b / (host_rate_gibs * 2**30)
    from ..telemetry import twin_registry

    twin_registry().record_predicted(
        "offload_transfer.overlap_frac", predicted_overlap(transfer_s, host_s),
        source="ops/streaming.offload_transfer_accounting")
    return {
        "h2d_bytes": int(h2d),
        "d2h_bytes": int(d2h),
        "host_update_bytes": int(host_b),
        "transfer_s_pred": round(transfer_s, 3),
        "host_update_s_pred": round(host_s, 3),
        "overlap_frac": round(predicted_overlap(transfer_s, host_s), 4),
        "kind": "predicted",
    }


def chunk_groups(params, chunk_bytes: int, itemsize: int = 4) -> list[list[int]]:
    """Partition the leaf indices of ``params`` (a list, or a mapping in
    the train state's order: JAX's flatten order) into contiguous groups
    whose ``itemsize``-wide footprint stays under ``chunk_bytes`` (an
    oversized leaf is a group of its own), as JAX :208.  The boundaries are
    a numerics contract: the -sr / -sr8 recipes salt by the group-relative
    leaf index, so every schedule over the same groups is bitwise the
    same."""
    leaves = list(params.values()) if isinstance(params, Mapping) else list(params)
    groups: list[list[int]] = []
    cur: list[int] = []
    size = 0
    for i, leaf in enumerate(leaves):
        n = (int(np.prod(tuple(leaf.shape))) if hasattr(leaf, "shape") else 1) * itemsize
        if cur and size + n > chunk_bytes:
            groups.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += n
    if cur:
        groups.append(cur)
    return groups


def slice_congruent(state, n_leaves: int, idxs: list[int]):
    """``state`` (an optimizer state NamedTuple, or a list of leaves) with
    every params-congruent field — a list of ``n_leaves`` tensors: the
    moments, their scales — replaced by its ``idxs`` elements; counts and
    hyperparameters pass whole (JAX :244)."""
    if isinstance(state, (list, tuple)) and not hasattr(state, "_fields"):
        return [state[i] for i in idxs]
    return type(state)(*[[v[i] for i in idxs] if isinstance(v, list) and len(v) == n_leaves
                         else v for v in state])


def merge_congruent(template, group_outs: list, n_leaves: int, groups: list[list[int]]):
    """Inverse of :func:`slice_congruent` over all groups (JAX :261):
    each congruent field rebuilt from the groups' outputs, every other
    field (a count every group advanced alike) from group 0."""
    def merged(outs):
        leaves: list = [None] * n_leaves
        for idxs, out in zip(groups, outs):
            for j, i in enumerate(idxs):
                leaves[i] = out[j]
        return leaves

    if isinstance(template, (list, tuple)) and not hasattr(template, "_fields"):
        return merged(group_outs)
    fields = []
    for k, v in enumerate(template):
        if isinstance(v, list) and len(v) == n_leaves:
            fields.append(merged([out[k] for out in group_outs]))
        else:
            fields.append(group_outs[0][k])
    return type(template)(*fields)


def stage_put(tensors: list, buffers: list, device=None) -> StagedTree:
    """One device-to-host stage (JAX :284): copy each of ``tensors`` into
    the page-locked buffer at its place in ``buffers`` (allocated at the
    first call, reused while shape and dtype agree) with ``non_blocking``
    on the side stream, after the work the current stream has queued.  The
    returned tree holds the host buffers; ``wait_host()`` blocks the host
    until the copies are done, ``copy_ms()`` then gives their time.  CPU tensors are already on the host: they
    come back as they are."""
    if not tensors or tensors[0].device.type != "cuda":
        return StagedTree(list(tensors))
    dev = tensors[0].device
    side = _side_stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    out = []
    with torch.cuda.stream(side):
        start = torch.cuda.Event(enable_timing=True)
        start.record(side)
        for i, t in enumerate(tensors):
            buf = buffers[i] if i < len(buffers) else None
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                if i < len(buffers):
                    buffers[i] = buf
                else:
                    buffers.append(buf)
            buf.copy_(t, non_blocking=True)
            t.record_stream(side)
            out.append(buf)
        event = torch.cuda.Event(enable_timing=True)
        event.record(side)
    return StagedTree(out, event, device=dev, start=start)


# ---------------------------------------------------------------------------
# Staging from pageable and file-backed host memory
# ---------------------------------------------------------------------------

# data_ptr -> (weak reference to the memory map, file path, bytes) of every
# live tensor that ``big_modeling`` made over a whole ``.dat`` file
_FILE_BACKED: dict[int, tuple] = {}


def register_file_backed(t: torch.Tensor, mapping: np.ndarray, path) -> torch.Tensor:
    """Record that ``t``'s bytes are the whole of file ``path``, as mapped
    by ``mapping`` (read-only by contract): :func:`file_span` then knows it
    for the disk tier, which ``generate_streamed`` streams and
    :class:`PinnedStaging` may read from the file; returns ``t``.  The
    entry lapses with the map."""
    for ptr in [p for p, (ref, _, _) in _FILE_BACKED.items() if ref() is None]:
        del _FILE_BACKED[ptr]
    _FILE_BACKED[t.data_ptr()] = (weakref.ref(mapping), str(path), t.numel() * t.element_size())
    return t


def file_span(x) -> Optional[tuple[str, int]]:
    """``(path, offset)`` where a host tensor's or array's bytes lie as
    they are in a file (a registered tensor, or a read-only or shared
    ``np.memmap`` over the rest of its file), else None."""
    if isinstance(x, np.memmap):
        if x.filename is None or x.mode == "c" or not x.flags.c_contiguous:
            return None
        if x.offset + x.nbytes != os.path.getsize(x.filename):
            return None
        return x.filename, x.offset
    if isinstance(x, torch.Tensor) and x.device.type == "cpu" and x.is_contiguous():
        entry = _FILE_BACKED.get(x.data_ptr())
        if entry is not None and entry[0]() is not None \
                and entry[2] == x.numel() * x.element_size():
            return entry[1], 0
    return None


def _torch_dtype(x) -> torch.dtype:
    if isinstance(x, torch.Tensor):
        return x.dtype
    return torch.from_numpy(np.empty(0, np.asarray(x).dtype)).dtype


class PinnedStaging:
    """Reusable host slots that sources in pageable memory are copied into
    before their upload: a copy to the card from pageable memory is
    synchronous and ends any overlap.  Each slot is one page-locked buffer
    (``pin=False``: a plain one, on a host without a card) grown to the
    largest set of tensors staged in it.  A source is copied in; with
    ``read_files``, a file-backed one (:func:`file_span`) is read from its
    file with the native engine's parallel ``pread`` instead.  A slot is
    reused only once the event given with :meth:`release` has completed,
    i.e. the copy that read it has ended."""

    def __init__(self, slots: int, pin: bool = True, read_files: bool = False):
        self.pin = pin
        self.read_files = read_files
        self.buffers: list = [None] * slots
        self.events: list = [None] * slots
        self.next = 0

    def stage(self, sources: Mapping[str, Any],
              like: Optional[Mapping[str, torch.Tensor]] = None) -> tuple[dict, int]:
        """The bytes of each source (a host tensor or a numpy array) in the
        next slot, as a tensor of ``like[name]``'s dtype and shape (default:
        the source's own), by name; and the slot's index."""
        from .. import native

        slot = self.next
        self.next = (slot + 1) % len(self.buffers)
        if self.events[slot] is not None:
            self.events[slot].synchronize()
            self.events[slot] = None
        specs = []
        for name, x in sources.items():
            ref = like[name] if like is not None and name in like else x
            dtype = _torch_dtype(ref)
            n = int(np.prod(ref.shape, dtype=np.int64)) * dtype.itemsize
            if n != (x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes):
                raise ValueError(f"{name}: {tuple(x.shape)} {getattr(x, 'dtype', '')} does not "
                                 f"hold the bytes of {tuple(ref.shape)} {dtype}")
            specs.append((name, x, dtype, tuple(ref.shape), n))
        spans = [-(-n // 256) * 256 for *_, n in specs]
        buf = self.buffers[slot]
        if buf is None or buf.numel() < sum(spans):
            self.buffers[slot] = None
            buf = self.buffers[slot] = torch.empty(sum(spans), dtype=torch.uint8,
                                                   pin_memory=self.pin)
        out, off = {}, 0
        for (name, x, dtype, shape, n), span in zip(specs, spans):
            raw = buf[off:off + n]
            where = file_span(x) if (self.read_files and n) else None
            if where is not None:
                native.read_file(where[0], nbytes=n, offset=where[1], out=raw.numpy())
            elif n:
                if not isinstance(x, torch.Tensor):
                    with warnings.catch_warnings():     # a read-only map: only read here
                        warnings.simplefilter("ignore", UserWarning)
                        x = torch.from_numpy(np.ascontiguousarray(x))
                raw.copy_(x.detach().contiguous().reshape(-1).view(torch.uint8))
            out[name] = raw.view(dtype).view(shape)
            off += span
        return out, slot

    def release(self, slot: int, event) -> None:
        """``event`` (None: nothing in flight) marks the end of the copies
        that read slot ``slot``."""
        self.events[slot] = event


# ---------------------------------------------------------------------------
# The layer prefetcher
# ---------------------------------------------------------------------------


class LayerPrefetcher:
    """Host-driven double buffer over per-layer weight trees (JAX
    ``LayerPrefetcher``).

    ``fetch(i)`` must *dispatch* the upload of layer ``i``'s tree and
    return at once — a :class:`StagedTree` from :func:`stage_tree`, or a
    plain tree.  ``get(i)`` first issues the prefetch of the next ``depth``
    layers, then resolves layer ``i``: for a staged tree, the current
    stream waits on its copy.  With ``wrap=True`` the lookahead wraps past
    the last layer (layer 0's weights for the next token stream in under
    the head and the sampling).  ``depth=0`` keeps the slots but no sequential
    lookahead: the caller prefetches explicitly (:meth:`prefetch`), as the
    adapter pool does for the scheduler's waiting queue.  ``enabled=False``
    degrades to a fetch per ``get`` whose copy the host waits for.

    A resolved tree's pinned source stays referenced until its copy has
    ended (not its device tree: that lives as long as the caller holds
    it).  ``retry_policy`` bounds re-attempts of a failing ``fetch``
    (None: fail on the first error).
    """

    def __init__(self, fetch: Callable[[int], Any], n_layers: int, *,
                 depth: int = 1, wrap: bool = False, enabled: bool = True,
                 stats: Optional[StreamStats] = None,
                 retry_policy: Optional[RetryPolicy] = DEFAULT_POLICY):
        if n_layers < 1:
            raise ValueError(f"n_layers must be >= 1, got {n_layers}")
        if depth < 0:
            raise ValueError(f"depth must be >= 0, got {depth}")
        self.fetch = fetch
        self.n_layers = n_layers
        self.depth = depth
        self.wrap = wrap
        self.enabled = enabled
        self.stats = stats
        self.retry_policy = retry_policy
        self._slots: dict[int, Any] = {}
        self._in_flight: list[StagedTree] = []

    def _on_retry(self, site, attempt, exc):
        if self.stats is not None:
            self.stats.transfer_retries += 1

    def _issue(self, i: int):
        def attempt():
            maybe_fail_transfer("transfer")
            return self.fetch(i)

        if self.retry_policy is not None:
            tree = with_retries(attempt, policy=self.retry_policy,
                                site=f"layer-prefetch[{i}]", on_retry=self._on_retry)
        else:
            tree = attempt()
        if self.stats is not None:
            self.stats.h2d_bytes += tree_bytes(tree)
            self.stats.fetches += 1
        return tree

    def _resolve(self, tree, block: bool):
        if not isinstance(tree, StagedTree):
            return tree
        t0 = time.perf_counter()
        if block and tree.event is not None:
            tree.event.synchronize()
        out = tree.wait()
        if self.stats is not None:
            self.stats.fetch_wait_s += time.perf_counter() - t0
        self._in_flight = [s for s in self._in_flight if not s.done()]
        if not tree.done():
            # keeps its pinned source alive, not its device tree
            self._in_flight.append(StagedTree(None, tree.event, tree.source, tree.device))
        return out

    def get(self, i: int):
        """The device tree for layer ``i``; issues the next prefetches first."""
        if not (0 <= i < self.n_layers):
            raise IndexError(f"layer {i} out of range [0, {self.n_layers})")
        if not self.enabled:
            return self._resolve(self._issue(i), block=True)
        tree = self._slots.pop(i, None)
        if tree is None:
            # cold miss: issue the layer needed now before any lookahead
            tree = self._issue(i)
        elif self.stats is not None:
            self.stats.prefetch_hits += 1
        for d in range(1, self.depth + 1):
            j = (i + d) % self.n_layers if self.wrap else i + d
            if j < self.n_layers and j != i and j not in self._slots:
                self._slots[j] = self._issue(j)
        return self._resolve(tree, block=False)

    def prefetch(self, i: int) -> bool:
        """Dispatch layer ``i``'s upload now without waiting for it.  Returns
        True when a transfer was issued (False: already in flight, or
        prefetch disabled)."""
        if not (0 <= i < self.n_layers):
            raise IndexError(f"layer {i} out of range [0, {self.n_layers})")
        if not self.enabled or i in self._slots:
            return False
        self._slots[i] = self._issue(i)
        return True

    def invalidate(self, i: int) -> None:
        """Discard layer ``i``'s staged upload if one is in flight — its
        source changed, so the staged copy must never be served."""
        self._slots.pop(i, None)

    def drop(self):
        """Release every staged upload."""
        self._slots.clear()
