"""Data pipeline (mirrors ``accelerate_tpu/data_loader.py``).

The same sampler and sharding semantics as the JAX package —
``BatchSamplerShard`` (:244) index-level stride/split modes with
``even_batches`` head-sample padding, ``IterableDatasetShard`` (:376),
the seedable sampler (:221) drawing numpy's ``default_rng(seed + epoch)``
(so the index stream equals the JAX package's), the dispatcher (:785),
skip/resume (:1137-1181) and the loaders' stateful resume
(:759-783) — with the device boundary in PyTorch: each batch is a tree of
tensors on the accelerator's device.

Host-to-device: the loaders keep the JAX package's one-batch lookahead.
On a CUDA device a batch is pinned and copied ``non_blocking`` on a side
stream; the step's stream waits on the copy's event before the batch is
handed out, so the copy of batch k+1 overlaps the step on batch k.  With
``prefetch_size >= 2`` and the native runtime built, a producer thread
stages the next batches' bytes through the native ring
(``native/src/ring.cc``, the twin of JAX's ``_RingPrefetcher`` :81) while
the step runs.  The staging runs under the bounded retry of
``resilience/retry.py`` with the ``transfer`` fault site inside each
attempt.

In a world of several processes each process reads its own share:
``BatchSamplerShard`` / ``IterableDatasetShard`` shard the index stream by
the process group's rank, and the dispatcher has process 0 read each batch
and broadcast it for every process to slice.  Under a parallelism config
the processes of one data-parallel group (cp peers) read identical batches
(the JAX package's rank remap, ``process_index // non_data_parallel_size``).
The mesh helpers map a batch spec to row blocks by rank
(``batch_rows_by_rank``, ``process_local_rows``, ``shard_global_batch``):
one process drives one card, so a device of the JAX mesh is a rank.
"""

from __future__ import annotations

import contextlib

import math
import queue
import threading
import time
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import native
from .ops.operations import (
    broadcast_object_list,
    find_batch_size,
    recursively_apply,
    slice_tensors,
)
from .resilience.faults import maybe_fail_transfer
from .resilience.retry import DEFAULT_POLICY, with_retries
from .state import GradientState
from .utils.random import get_root_seed


def _is_torch_loader(obj) -> bool:
    return isinstance(obj, torch.utils.data.DataLoader)


def _to_tensors(batch):
    """A batch tree with every numpy array (and numpy scalar) as a CPU
    tensor; tensors and other leaves pass through."""
    def conv(x):
        if isinstance(x, (np.ndarray, np.generic)):
            return torch.from_numpy(np.ascontiguousarray(x))
        return x

    return pytree.tree_map(conv, batch)


class _Stager:
    """Host-to-device placement of batch trees on one device.

    On a CUDA device each tensor leaf is pinned and copied with
    ``non_blocking`` on a side stream; :meth:`ready` makes the consumer's
    stream wait for the copy and records the batch's tensors on that
    stream for the caching allocator.  On the CPU the batch is used as it
    is.  ``non_blocking=False`` copies on the current stream and waits."""

    def __init__(self, device, non_blocking: bool = True):
        self.device = torch.device(device)
        self.non_blocking = non_blocking and self.device.type == "cuda"
        self._stream = None
        self.h2d_s = 0.0     # host seconds spent issuing copies

    def stage(self, batch):
        t0 = time.perf_counter()
        leaves, spec = pytree.tree_flatten(batch)
        if not self.non_blocking:
            out = [x.to(self.device) if isinstance(x, torch.Tensor) else x for x in leaves]
            self.h2d_s += time.perf_counter() - t0
            return pytree.tree_unflatten(out, spec), None
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        pinned = [x.pin_memory() if isinstance(x, torch.Tensor) and x.device.type == "cpu"
                  and not x.is_pinned() else x for x in leaves]
        with torch.cuda.stream(self._stream):
            out = [x.to(self.device, non_blocking=True) if isinstance(x, torch.Tensor) else x
                   for x in pinned]
            event = torch.cuda.Event()
            event.record(self._stream)
        self.h2d_s += time.perf_counter() - t0
        return pytree.tree_unflatten(out, spec), event

    def ready(self, staged):
        batch, event = staged
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for x in pytree.tree_leaves(batch):
                if isinstance(x, torch.Tensor) and x.device.type == "cuda":
                    x.record_stream(stream)
        return batch


class _RingPrefetcher:
    """Background host staging over the native staging ring (JAX
    ``_RingPrefetcher``).

    A producer thread pulls batches from the inner iterable and copies
    their bytes into an aligned slot of the native ring (large copies
    release the GIL).  The consumer rebuilds the batch from the slot into
    memory of its own (pinned for a CUDA device), hands the slot back and
    places the batch through ``device_put``.  Batches that do not fit a
    slot ride the queue directly (the slot size is the first batch's bytes
    with headroom).
    """

    _ALIGN = 64

    def __init__(self, inner: Iterable, device_put: Callable, depth: int = 2,
                 pin_memory: bool = False):
        self.inner = inner
        self.device_put = device_put
        self.depth = max(2, depth)
        self.pin_memory = pin_memory
        self._queue: queue.Queue = queue.Queue(maxsize=self.depth + 1)
        self._ring = None
        self._closed = False
        self._thread = None

    # -- producer -----------------------------------------------------------

    def _stage(self, batch) -> Optional[tuple]:
        """Copy a batch's tensor leaves into a ring slot; returns a
        descriptor: ("ring", spec, layout), ("raw", spec, leaves) for a
        batch larger than a slot, or None when the ring closed."""
        leaves, spec = pytree.tree_flatten(_to_tensors(batch))
        leaves = [x.contiguous() if isinstance(x, torch.Tensor) else x for x in leaves]
        layout, offset = [], 0
        for x in leaves:
            if isinstance(x, torch.Tensor):
                nbytes = x.numel() * x.element_size()
                layout.append((offset, x.dtype, tuple(x.shape), nbytes))
                offset += -(-nbytes // self._ALIGN) * self._ALIGN
            else:
                layout.append(x)
        if self._ring is None:
            self._ring = native.StagingRing(self.depth, max(int(offset * 1.5), 1 << 20))
        if offset > self._ring.slot_bytes:
            return ("raw", spec, leaves)
        slot = self._ring.acquire()
        if slot is None:
            return None
        for x, lay in zip(leaves, layout):
            if isinstance(x, torch.Tensor) and lay[3]:
                off, _, _, nbytes = lay
                np.copyto(slot[off:off + nbytes], x.reshape(-1).view(torch.uint8).numpy())
        self._ring.commit(slot, offset)
        return ("ring", spec, layout)

    def _put(self, item) -> bool:
        """Bounded put that gives up when the consumer is gone."""
        while not self._closed:
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self):
        try:
            for batch in self.inner:
                if self._closed:
                    return
                desc = self._stage(batch)
                if desc is None or not self._put(desc):
                    return
            self._put(None)
        except BaseException as e:  # noqa: BLE001 — raised again in the consumer
            self._put(("err", e))

    # -- consumer -----------------------------------------------------------

    def _unstage(self, view, layout) -> list:
        out = []
        for lay in layout:
            if not isinstance(lay, tuple):
                out.append(lay)
                continue
            off, dtype, shape, nbytes = lay
            t = torch.empty(shape, dtype=dtype, pin_memory=self.pin_memory)
            if nbytes:
                t.reshape(-1).view(torch.uint8).copy_(torch.from_numpy(view[off:off + nbytes]))
            out.append(t)
        return out

    def __iter__(self):
        self._thread = threading.Thread(target=self._produce, daemon=True, name="port-prefetch")
        self._thread.start()
        try:
            while True:
                desc = self._queue.get()
                if desc is None:
                    return
                if desc[0] == "err":
                    raise desc[1]
                if desc[0] == "raw":
                    yield self.device_put(pytree.tree_unflatten(desc[2], desc[1]))
                    continue
                _, spec, layout = desc
                view = self._ring.pop()
                if view is None:
                    return
                # copied out of the slot before it is handed back
                leaves = self._unstage(view, layout)
                self._ring.release(view)
                yield self.device_put(pytree.tree_unflatten(leaves, spec))
        finally:
            self.close()

    def close(self):
        self._closed = True
        if self._ring is not None:
            self._ring.close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            if self._thread.is_alive():
                # producer stuck (e.g. a slow dataset read): leak the ring
                # rather than free memory the thread may still touch
                return
        if self._ring is not None:
            self._ring.destroy()
            self._ring = None


class SeedableRandomSampler:
    """Deterministic shuffling reseeded per epoch with ``seed + epoch``
    (reference SeedableRandomSampler data_loader.py:73-107)."""

    def __init__(self, data_source_len: int, seed: Optional[int] = None, epoch: int = 0):
        self.data_source_len = data_source_len
        self.initial_seed = seed if seed is not None else get_root_seed()
        self.epoch = epoch

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return self.data_source_len

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng(self.initial_seed + self.epoch)
        yield from rng.permutation(self.data_source_len).tolist()
        self.epoch += 1


class BatchSamplerShard:
    """Shard a batch sampler's index batches across ``num_processes``
    (reference BatchSamplerShard data_loader.py:110-263).

    - ``split_batches=False`` (stride): process k yields batch k of every
      consecutive group of ``num_processes`` batches.
    - ``split_batches=True``: each global batch is sliced into
      ``num_processes`` chunks.
    - ``even_batches=True`` pads the tail by cycling samples from the
      beginning so every process yields the same number of equally-sized
      batches (the duplicates are dropped later by ``gather_for_metrics``).
    """

    def __init__(
        self,
        batch_sampler: Iterable[list[int]],
        num_processes: int = 1,
        process_index: int = 0,
        split_batches: bool = False,
        even_batches: bool = True,
    ):
        if split_batches and getattr(batch_sampler, "batch_size", None) is not None:
            if batch_sampler.batch_size % num_processes != 0:
                raise ValueError(
                    f"batch_size {batch_sampler.batch_size} must be divisible by num_processes "
                    f"{num_processes} when split_batches=True"
                )
        self.batch_sampler = batch_sampler
        self.num_processes = num_processes
        self.process_index = process_index
        self.split_batches = split_batches
        self.even_batches = even_batches
        self.batch_size = getattr(batch_sampler, "batch_size", None)
        self.drop_last = getattr(batch_sampler, "drop_last", False)

    @property
    def total_length(self):
        return len(self.batch_sampler)

    def __len__(self):
        n = len(self.batch_sampler)
        if self.split_batches:
            return n
        if n % self.num_processes == 0:
            return n // self.num_processes
        if self.even_batches and not self.drop_last:
            return math.ceil(n / self.num_processes)
        return n // self.num_processes + (
            0 if self.even_batches or self.drop_last else int(self.process_index < n % self.num_processes)
        )

    def set_epoch(self, epoch: int):
        if hasattr(self.batch_sampler, "set_epoch"):
            self.batch_sampler.set_epoch(epoch)
        sampler = getattr(self.batch_sampler, "sampler", None)
        if sampler is not None and hasattr(sampler, "set_epoch"):
            sampler.set_epoch(epoch)

    def __iter__(self):
        return self._iter_with_split() if self.split_batches else self._iter_with_stride()

    def _iter_with_split(self):
        initial_data: list[int] = []
        for idx, batch in enumerate(self.batch_sampler):
            if idx == 0:
                initial_data = list(batch)
            if self.batch_size is None:
                # unknown batch size: infer from first batch
                self.batch_size = len(batch)
            chunk = self.batch_size // self.num_processes
            if len(batch) == self.batch_size:
                yield batch[self.process_index * chunk : (self.process_index + 1) * chunk]
            else:  # smaller tail batch
                if self.drop_last:
                    return
                if not self.even_batches:
                    piece = batch[self.process_index * chunk : (self.process_index + 1) * chunk]
                    if len(piece):
                        yield piece
                else:
                    while len(batch) < self.batch_size:
                        batch = batch + initial_data[: self.batch_size - len(batch)]
                    yield batch[self.process_index * chunk : (self.process_index + 1) * chunk]

    def _iter_with_stride(self):
        initial_data: list[int] = []
        batch_to_yield: Optional[list[int]] = None
        cycle_pos = -1
        batch_size = self.batch_size
        for idx, batch in enumerate(self.batch_sampler):
            if batch_size is None:
                batch_size = len(batch)
            # collect one full cycle of batches for tail padding
            if idx < self.num_processes:
                initial_data += list(batch)
            cycle_pos = idx % self.num_processes
            if cycle_pos == self.process_index:
                batch_to_yield = list(batch)
            if cycle_pos == self.num_processes - 1:
                if len(batch) == batch_size or (not self.even_batches and batch_to_yield):
                    yield batch_to_yield
                    batch_to_yield = None
                elif self.even_batches and not self.drop_last:
                    # last batch of the cycle is short: pad it (and this
                    # rank's batch if short) by cycling initial samples
                    if batch_to_yield is not None:
                        while len(batch_to_yield) < batch_size:
                            batch_to_yield += initial_data[: batch_size - len(batch_to_yield)]
                        yield batch_to_yield
                        batch_to_yield = None
        if cycle_pos == self.num_processes - 1 or cycle_pos == -1:
            return
        # dataloader ended mid-cycle
        if self.drop_last:
            return
        if not self.even_batches:
            if batch_to_yield:
                yield batch_to_yield
            return
        # even_batches: every rank must yield one more batch; ranks beyond the
        # cycle end cycle through initial samples
        if batch_to_yield is None:
            start = (self.process_index - cycle_pos - 1) * (batch_size or 1)
            pool = initial_data
            while len(pool) < start + (batch_size or 1):
                pool = pool + initial_data
            batch_to_yield = pool[start : start + (batch_size or 1)]
        while batch_size is not None and len(batch_to_yield) < batch_size:
            batch_to_yield += initial_data[: batch_size - len(batch_to_yield)]
        yield batch_to_yield


class IterableDatasetShard:
    """Shard an iterable dataset: buffer ``num_processes * batch_size`` items,
    take this process's slice (reference IterableDatasetShard
    data_loader.py:266-365)."""

    def __init__(
        self,
        dataset: Iterable,
        batch_size: int = 1,
        drop_last: bool = False,
        num_processes: int = 1,
        process_index: int = 0,
        split_batches: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_processes = num_processes
        self.process_index = process_index
        self.split_batches = split_batches

    def set_epoch(self, epoch: int):
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self):
        n = len(self.dataset)
        real_batch = self.batch_size if self.split_batches else self.batch_size * self.num_processes
        if self.drop_last:
            return (n // real_batch) * real_batch // self.num_processes
        return math.ceil(n / real_batch) * real_batch // self.num_processes

    def __iter__(self):
        real_batch_size = self.batch_size if self.split_batches else self.batch_size * self.num_processes
        process_batch_size = self.batch_size // self.num_processes if self.split_batches else self.batch_size
        first_batch = None
        buffer: list = []
        for element in self.dataset:
            buffer.append(element)
            if len(buffer) == real_batch_size:
                start = self.process_index * process_batch_size
                yield from buffer[start : start + process_batch_size]
                if first_batch is None:
                    first_batch = buffer.copy()
                buffer = []
        if not self.drop_last and len(buffer) > 0:
            if first_batch is None:
                first_batch = buffer.copy()
            while len(buffer) < real_batch_size:
                buffer += first_batch[: real_batch_size - len(buffer)]
            start = self.process_index * process_batch_size
            yield from buffer[start : start + process_batch_size]




# ---------------------------------------------------------------------------
# the rows of a global batch each rank feeds
# ---------------------------------------------------------------------------


def _layout(mesh) -> tuple[tuple, tuple]:
    """``(names, shape)`` of a ``DeviceMesh`` or of a layout."""
    if isinstance(mesh, tuple):
        return tuple(mesh[0]), tuple(mesh[1])
    return tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape)


def batch_rows_by_rank(mesh, spec, shape) -> dict:
    """``{rank: (start, stop)}``, the rows of the global batch dimension each
    rank owns under ``spec`` (JAX ``batch_rows_by_device`` :435, a rank for
    a device): dim 0's entry names the mesh axes the rows split over, in
    blocks ranked row-major over those axes; ranks that differ only in
    other axes own the same block.  ``mesh`` is a ``DeviceMesh`` or a
    ``(names, shape)`` layout; rank r sits at the row-major position r of
    the mesh shape."""
    names, mesh_shape = _layout(mesh)
    entry = spec[0] if len(spec) else None
    axes = () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))
    sizes = dict(zip(names, mesh_shape))
    blocks = int(np.prod([sizes[a] for a in axes])) if axes else 1
    rows = shape[0]
    if rows % blocks:
        raise ValueError(f"global batch dim {rows} not divisible by the {blocks} row blocks "
                         f"of spec {tuple(spec)}")
    per = rows // blocks
    out = {}
    for rank in range(int(np.prod(mesh_shape))):
        coords = dict(zip(names, np.unravel_index(rank, mesh_shape)))
        block = 0
        for a in axes:
            block = block * sizes[a] + int(coords[a])
        out[rank] = (block * per, (block + 1) * per)
    return out


def process_local_rows(mesh, spec, shape, process_index: Optional[int] = None) -> slice:
    """The ``[start, stop)`` rows of the global batch that
    ``process_index`` (this process's rank by default; on a virtual mesh,
    the running rank's) feeds under ``(mesh, spec)`` (JAX :471)."""
    from .state import world

    if process_index is not None:
        pid = process_index
    elif getattr(mesh, "is_virtual", False):
        pid = mesh.rank
    else:
        pid = world()[1]
    rows = batch_rows_by_rank(mesh, spec, shape)
    if pid not in rows:
        raise ValueError(f"process {pid} owns no position of the mesh {_layout(mesh)}")
    return slice(*rows[pid])


def shard_global_batch(batch, mesh, spec):
    """This process's rows of a global batch every process holds (JAX
    :493): each tensor leaf sliced to :func:`process_local_rows` of its
    shape; ``spec`` may be a callable of the leaf.  One process owns the
    whole batch, so a stream consumed this way is the same at any process
    count."""

    def _take(x):
        rows = process_local_rows(mesh, spec(x) if callable(spec) else spec, tuple(x.shape))
        return x[rows.start:rows.stop]

    return recursively_apply(_take, batch, error_on_other_type=True)


class DataLoaderStateMixin:
    """end-of-dataloader / remainder signalling into ``GradientState``."""

    def __init_subclass__(cls, **kwargs):
        cls.end_of_dataloader = False
        cls.remainder = -1

    def reset(self):
        self.end_of_dataloader = False
        self.remainder = -1

    def begin(self):
        self.reset()
        try:
            length = self.total_dataset_length
            total_batch_size = self.total_batch_size
            if length is not None and total_batch_size:
                self.remainder = length % total_batch_size
        except TypeError:  # length-less iterable dataset
            pass
        self.gradient_state._add_dataloader(self)

    def end(self):
        self.gradient_state._remove_dataloader(self)

    def set_epoch(self, epoch: int):
        self.iteration = epoch
        _set_epoch(self.inner, epoch)

    @property
    def total_dataset_length(self):
        return len(getattr(self.inner, "dataset", self.inner))

    # -- stateful resume: positions count batches of this process's passes --

    def state_dict(self):
        by, it = self._batches_yielded, self.iteration
        try:
            full = len(self.inner)
        except TypeError:  # length-less iterable
            full = None
        if full is not None and by >= full > 0:
            # saved on the pass's last batch (before the epoch-end reset ran):
            # the position is the next epoch's start
            by, it = 0, it + 1
        return {"batches_yielded": by, "iteration": it}

    def load_state_dict(self, state_dict):
        # the resume-time skip applies to the next pass only; a
        # skip_first_batches-built wrapper keeps its persistent skip
        self.skip_batches = state_dict.get("batches_yielded", 0)
        self._skip_once = self.skip_batches > 0
        self.iteration = state_dict.get("iteration", 0)
        self._batches_yielded = self.skip_batches


def _set_epoch(inner, epoch: int) -> None:
    """Hand ``epoch`` to the inner iterable, or to the sampler of a torch
    data loader (the seedable sampler draws ``seed + epoch``), so a loader
    restored mid-run shuffles as the run it resumes did."""
    if hasattr(inner, "set_epoch"):
        inner.set_epoch(epoch)
        return
    batch_sampler = getattr(inner, "batch_sampler", None)
    for sampler in (batch_sampler, getattr(batch_sampler, "sampler", None)):
        if sampler is not None and hasattr(sampler, "set_epoch"):
            sampler.set_epoch(epoch)
            return


def _lookahead(source, skip: int, loader):
    """Yield ``source``'s staged batches one behind (the next one is staged
    while the current one is consumed), past the first ``skip``; flips
    ``loader.end_of_dataloader`` before the last one and counts each
    handed-out batch in ``loader._batches_yielded`` before yielding it."""
    batch_idx = 0
    current, have_current = None, False
    for nxt in source:
        if have_current and batch_idx > skip:
            loader._batches_yielded += 1
            yield current
        current, have_current = nxt, True
        batch_idx += 1
    if have_current:
        loader.end_of_dataloader = True
        if batch_idx > skip:
            loader._batches_yielded += 1
            yield current


class DataLoaderShard(DataLoaderStateMixin):
    """The device loader: wraps an inner batch iterable and hands out each
    batch on ``device`` with one-batch lookahead (JAX ``DataLoaderShard``
    :538).  ``data_wait_s`` accumulates the host seconds the consumer
    waited on the inner iterable (or on the prefetch ring)."""

    def __init__(
        self,
        inner: Iterable,
        device=None,
        rng_types: Optional[list] = None,
        synchronized_generator=None,
        skip_batches: int = 0,
        put_on_device: bool = True,
        prefetch_size: int = 0,
        even_batches: bool = True,
        _non_blocking: bool = True,
        _loader_batch_size: Optional[int] = None,
        transfer_retry_policy=None,
        on_transfer_retry=None,
        gradient_state: Optional[GradientState] = None,
        _num_processes: int = 1,
        _split_batches: bool = False,
    ):
        self.inner = inner
        self.device = torch.device(device) if device is not None else None
        self.even_batches = even_batches
        # the global batch across processes: what the remainder counts in
        self._num_processes = 1 if _split_batches else _num_processes
        self.rng_types = rng_types
        self.synchronized_generator = synchronized_generator
        self.skip_batches = skip_batches
        self.put_on_device = put_on_device and self.device is not None
        self.prefetch_size = prefetch_size
        self.gradient_state = gradient_state or GradientState()
        self.iteration = 0
        self._loader_batch_size = _loader_batch_size
        self._batches_yielded = 0  # intra-epoch stateful-resume position
        self._skip_once = False    # skip_batches came from load_state_dict
        self._retry_policy = transfer_retry_policy or DEFAULT_POLICY
        self._on_transfer_retry = on_transfer_retry
        self._stager = _Stager(self.device, _non_blocking) if self.put_on_device else None
        self.data_wait_s = 0.0
        # the Accelerator's TrainTimeline (data_wait / h2d_staging), when armed
        self._timeline = None
        # a host transform of each batch before it is staged (the Accelerator
        # sets this rank's sequence slice under sp)
        self._batch_fn = None

    # -- device placement ---------------------------------------------------

    def _device_put_batch(self, batch):
        """Stage ``batch`` toward the device under the bounded retry (the
        ``transfer`` fault fires inside each attempt); returns what
        :meth:`_ready` turns into the batch on the device.  The timeline's
        ``h2d_staging`` phase when one is attached."""
        batch = _to_tensors(batch)
        if self._batch_fn is not None:
            batch = self._batch_fn(batch)
        if not self.put_on_device:
            return batch, None

        def _send():
            maybe_fail_transfer("transfer")
            return self._stager.stage(batch)

        with _phase(self._timeline, "h2d_staging"):
            return with_retries(_send, site="dataloader-h2d", policy=self._retry_policy,
                                on_retry=self._on_transfer_retry)

    def _ready(self, staged):
        if self._stager is None:
            return staged[0]
        return self._stager.ready(staged)

    def _timed(self, it):
        """Yield from ``it``, adding the seconds each ``next`` blocks to
        ``data_wait_s`` (and to the timeline's ``data_wait`` phase when one
        is attached)."""
        while True:
            t0 = time.perf_counter()
            try:
                with _phase(self._timeline, "data_wait"):
                    item = next(it)
            except StopIteration:
                return
            finally:
                self.data_wait_s += time.perf_counter() - t0
            yield item

    def __iter__(self):
        self.begin()
        _set_epoch(self.inner, self.iteration)
        # intra-epoch position, skipped batches included (see state_dict)
        self._batches_yielded = self.skip_batches
        prefetcher = None
        try:
            if self.prefetch_size >= 2 and self.put_on_device and native.is_available():
                prefetcher = _RingPrefetcher(self.inner, self._device_put_batch,
                                             self.prefetch_size,
                                             pin_memory=self.device.type == "cuda")
                source = self._timed(iter(prefetcher))
            else:
                source = (self._device_put_batch(b) for b in self._timed(iter(self.inner)))
            for staged in _lookahead(source, self.skip_batches, self):
                yield self._ready(staged)
        finally:
            if prefetcher is not None:
                prefetcher.close()
            self.iteration += 1
            if self.end_of_dataloader:
                # a completed pass consumed any restore-time skip; the next
                # epoch starts at batch 0
                self._batches_yielded = 0
                if self._skip_once:
                    self.skip_batches, self._skip_once = 0, False
            self.end()

    def __len__(self):
        return max(len(self.inner) - self.skip_batches, 0)

    @property
    def total_batch_size(self):
        """The global batch: the loader's batch times the processes (the
        loader's batch itself under ``split_batches``)."""
        bs = self._loader_batch_size
        if bs is None:
            bs = getattr(self.inner, "batch_size", None)
        if bs is None:
            bs = getattr(getattr(self.inner, "batch_sampler", None), "batch_size", None)
        return bs * self._num_processes if bs is not None else None


def _phase(timeline, name: str):
    """``timeline.phase(name)``, or a null context without a timeline."""
    return timeline.phase(name) if timeline is not None else contextlib.nullcontext()


def _slice_tensors(batch, sl: slice):
    return slice_tensors(batch, sl)


def _find_batch_size(batch) -> int:
    size = find_batch_size(batch)
    if size is None:
        raise ValueError("cannot find the batch size of a batch without tensors")
    return size


class DataLoaderDispatcher(DataLoaderStateMixin):
    """Process 0 reads the data and every process slices its share (JAX
    ``DataLoaderDispatcher`` :785): for iterable sources.  In a world of
    several processes, process 0 reads one global batch (``split_batches``)
    or one batch per process, concatenated, and broadcasts it with the end
    flag; process k slices rows ``[k * n / P, (k + 1) * n / P)``
    (``slice_fn``).  One process slices the whole batch.  The lookahead,
    placement and resume are :class:`DataLoaderShard`'s."""

    def __init__(
        self,
        inner: Iterable,
        split_batches: bool = False,
        device=None,
        skip_batches: int = 0,
        slice_fn: Optional[Callable] = None,
        _loader_batch_size: Optional[int] = None,
        transfer_retry_policy=None,
        on_transfer_retry=None,
        _non_blocking: bool = True,
        gradient_state: Optional[GradientState] = None,
        num_processes: int = 1,
        process_index: int = 0,
    ):
        self.inner = inner
        self.split_batches = split_batches
        self.num_processes = num_processes
        self.process_index = process_index
        self.device = torch.device(device) if device is not None else None
        self.skip_batches = skip_batches
        self.slice_fn = slice_fn or _slice_tensors
        self.gradient_state = gradient_state or GradientState()
        self.iteration = 0
        self._loader_batch_size = _loader_batch_size
        self._batches_yielded = 0
        self._skip_once = False
        self._retry_policy = transfer_retry_policy or DEFAULT_POLICY
        self._on_transfer_retry = on_transfer_retry
        self._stager = _Stager(self.device, _non_blocking) if self.device is not None else None
        self.data_wait_s = 0.0
        # the Accelerator's TrainTimeline (data_wait / h2d_staging), when armed
        self._timeline = None
        # a host transform of each batch before it is staged (the Accelerator
        # sets this rank's sequence slice under sp)
        self._batch_fn = None

    def _read(self, iterator):
        """The next batch to slice, or None at the end: process 0 reads
        and, in a world of several processes, broadcasts."""
        if self.num_processes == 1:
            return next(iterator, None)
        payload = [None]
        if self.process_index == 0:
            if self.split_batches:
                payload = [next(iterator, None)]
            else:
                parts = [next(iterator, None) for _ in range(self.num_processes)]
                if all(p is not None for p in parts):
                    parts = [_to_tensors(p) for p in parts]
                    payload = [pytree.tree_map(lambda *xs: torch.cat(xs)
                                               if isinstance(xs[0], torch.Tensor) else xs[0],
                                               *parts)]
        broadcast_object_list(payload, from_process=0)
        return payload[0]

    def _prepare_local(self, batch):
        batch = _to_tensors(batch)
        whole = _find_batch_size(batch)
        per = whole // self.num_processes
        local = self.slice_fn(batch, slice(self.process_index * per,
                                           (self.process_index + 1) * per))

        def _place():
            maybe_fail_transfer("transfer")
            if self._stager is None:
                return local, None
            return self._stager.stage(local)

        return with_retries(_place, site="dataloader-h2d", policy=self._retry_policy,
                            on_retry=self._on_transfer_retry)

    def __iter__(self):
        self.begin()
        _set_epoch(self.inner, self.iteration)
        self._batches_yielded = self.skip_batches
        main_iterator = iter(self.inner) if self.process_index == 0 else None
        completed = False

        def source():
            nonlocal completed
            while True:
                t0 = time.perf_counter()
                try:
                    with _phase(self._timeline, "data_wait"):
                        batch = self._read(main_iterator)
                finally:
                    self.data_wait_s += time.perf_counter() - t0
                if batch is None:
                    completed = True
                    return
                with _phase(self._timeline, "h2d_staging"):
                    staged = self._prepare_local(batch)
                yield staged

        try:
            for staged in _lookahead(source(), self.skip_batches, self):
                yield staged[0] if self._stager is None else self._stager.ready(staged)
        finally:
            self.iteration += 1
            if completed:
                self._batches_yielded = 0
                if self._skip_once:
                    self.skip_batches, self._skip_once = 0, False
            self.end()

    def __len__(self):
        return len(self.inner)

    @property
    def total_batch_size(self):
        bs = self._loader_batch_size or getattr(self.inner, "batch_size", None)
        if bs is None:
            return None
        return bs if self.split_batches else bs * self.num_processes


def prepare_data_loader(
    dataloader,
    device=None,
    num_processes: Optional[int] = None,
    process_index: Optional[int] = None,
    split_batches: bool = False,
    put_on_device: bool = True,
    rng_types: Optional[list] = None,
    dispatch_batches: Optional[bool] = None,
    even_batches: bool = True,
    slice_fn_for_dispatch: Optional[Callable] = None,
    use_seedable_sampler: bool = False,
    data_seed: Optional[int] = None,
    non_blocking: bool = True,
    use_stateful_dataloader: bool = False,
    prefetch_size: int = 0,
    transfer_retry_policy=None,
    on_transfer_retry=None,
    gradient_state: Optional[GradientState] = None,
    parallelism_config=None,
):
    """Re-wrap a data loader (a ``torch.utils.data.DataLoader`` or any batch
    iterable) for sampler-level sharding and device placement (JAX
    ``prepare_data_loader`` :961).  ``num_processes`` / ``process_index``
    (the process group's size and rank by default) shard the sampler's
    index batches (``BatchSamplerShard``), an iterable dataset's items
    (``IterableDatasetShard``) or the dispatcher's broadcast batches; under
    a ``parallelism_config`` with non-data-parallel axes the ranks of one
    data-parallel group read the same batches (``process_index //
    non_data_parallel_size``).  ``device=None`` leaves batches on the
    host."""
    from .state import world

    size, rank = world()
    num_processes = size if num_processes is None else num_processes
    process_index = rank if process_index is None else process_index
    if parallelism_config is not None and parallelism_config.non_data_parallel_size > 1:
        non_dp = parallelism_config.non_data_parallel_size
        if num_processes % non_dp == 0 and non_dp <= num_processes:
            process_index = process_index // non_dp
            num_processes = num_processes // non_dp
    if dispatch_batches is None:
        dispatch_batches = (_is_torch_loader(dataloader)
                            and not hasattr(dataloader.dataset, "__getitem__")
                            and put_on_device)
    if dispatch_batches:
        return DataLoaderDispatcher(
            dataloader, split_batches=split_batches,
            device=device if put_on_device else None, slice_fn=slice_fn_for_dispatch,
            _loader_batch_size=getattr(dataloader, "batch_size", None),
            transfer_retry_policy=transfer_retry_policy, on_transfer_retry=on_transfer_retry,
            _non_blocking=non_blocking, gradient_state=gradient_state,
            num_processes=num_processes, process_index=process_index,
        )

    inner = dataloader
    if _is_torch_loader(dataloader):
        dataset = dataloader.dataset
        if isinstance(dataset, torch.utils.data.IterableDataset):
            if num_processes > 1:
                dataset = IterableDatasetShard(
                    dataset, batch_size=dataloader.batch_size, drop_last=dataloader.drop_last,
                    num_processes=num_processes, process_index=process_index,
                    split_batches=split_batches,
                )
            inner = torch.utils.data.DataLoader(
                dataset,
                batch_size=(dataloader.batch_size // num_processes if split_batches
                            else dataloader.batch_size),
                collate_fn=dataloader.collate_fn, num_workers=dataloader.num_workers,
                drop_last=dataloader.drop_last,
            )
        else:
            batch_sampler = dataloader.batch_sampler
            sampler = getattr(batch_sampler, "sampler", None)
            if use_seedable_sampler and isinstance(sampler, torch.utils.data.RandomSampler):
                seedable = SeedableRandomSampler(len(dataset), seed=data_seed)
                batch_sampler = torch.utils.data.BatchSampler(
                    seedable, batch_sampler.batch_size, batch_sampler.drop_last
                )
            if num_processes > 1:
                batch_sampler = BatchSamplerShard(
                    batch_sampler, num_processes=num_processes, process_index=process_index,
                    split_batches=split_batches, even_batches=even_batches,
                )
            inner = torch.utils.data.DataLoader(
                dataset, batch_sampler=batch_sampler, collate_fn=dataloader.collate_fn,
                num_workers=dataloader.num_workers,
            )

    return DataLoaderShard(
        inner,
        device=device if put_on_device else None,
        rng_types=rng_types,
        put_on_device=put_on_device,
        prefetch_size=prefetch_size,
        even_batches=even_batches,
        _non_blocking=non_blocking,
        _loader_batch_size=getattr(dataloader, "batch_size", None),
        transfer_retry_policy=transfer_retry_policy,
        on_transfer_retry=on_transfer_retry,
        gradient_state=gradient_state,
        _num_processes=num_processes,
        _split_batches=split_batches,
    )


# ---------------------------------------------------------------------------
# skip / resume
# ---------------------------------------------------------------------------


class SkipBatchSampler:
    """Yield batches of an inner batch sampler starting at ``skip_batches``."""

    def __init__(self, batch_sampler, skip_batches: int = 0):
        self.batch_sampler = batch_sampler
        self.skip_batches = skip_batches
        self.batch_size = getattr(batch_sampler, "batch_size", None)
        self.drop_last = getattr(batch_sampler, "drop_last", False)

    def __iter__(self):
        for idx, batch in enumerate(self.batch_sampler):
            if idx >= self.skip_batches:
                yield batch

    def __len__(self):
        return max(len(self.batch_sampler) - self.skip_batches, 0)


class SkipDataLoader:
    """Iterate a data loader skipping its first N batches."""

    def __init__(self, dataloader, skip_batches: int = 0):
        self.dataloader = dataloader
        self.skip_batches = skip_batches

    def __iter__(self):
        for idx, batch in enumerate(self.dataloader):
            if idx >= self.skip_batches:
                yield batch

    def __len__(self):
        return max(len(self.dataloader) - self.skip_batches, 0)

    def __getattr__(self, name):
        return getattr(self.__dict__["dataloader"], name)


def skip_first_batches(dataloader, num_batches: int = 0):
    """Fast-forward a (prepared or raw) data loader for mid-epoch resume."""
    if isinstance(dataloader, (DataLoaderShard, DataLoaderDispatcher)):
        dataloader.skip_batches = num_batches
        return dataloader
    return SkipDataLoader(dataloader, skip_batches=num_batches)
