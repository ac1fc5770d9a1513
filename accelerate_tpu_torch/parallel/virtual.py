"""Every rank of a world in one process: the card runs tensor parallelism
through the per-rank code of a gang this way (one H100, and NCCL runs one
rank a GPU).

:class:`VirtualMesh` stands for a ``DeviceMesh`` over ``shape`` ranks.
:meth:`VirtualMesh.run` runs ``fn(rank)`` for every rank, each in a
thread of its own, one at a time in rank order: a rank runs until it
calls a collective (``parallel/collectives.py`` hands the call to
:meth:`VirtualMesh.collective`), and the last rank to arrive exchanges
every rank's tensor in memory, after which rank 0 goes on.  The order is
fixed, so a run is deterministic; kernels launch on the one stream in
that order.  Each rank runs its own module (:func:`module_replica`).

Each collective has the gang's forward and backward.  The exchanges that
are linear maps with their transposes for backward (``all_gather``,
``reduce_scatter``, ``all_to_all``, ``ppermute``) are plain tensor ops
across the ranks' tensors, so autograd gives their backward; ``psum``
(gradient passed through), ``pbroadcast`` (gradient summed) and
``all_gather_invariant`` (gradient sliced) are autograd functions over
all the ranks' tensors at once.  The backward then runs in one call
(``torch.autograd.backward`` on every rank's loss, from any thread): it
calls no collective, so nothing waits on another rank.  Ranks' tensors
are never shared: each rank receives tensors of its own.

A rank's train step (``Accelerator.prepare_train_step`` inside
:meth:`VirtualMesh.run`) reaches that one backward through
``collectives.joint_grad``: the last rank to ask runs
``torch.autograd.grad`` over every rank's loss and leaves at once and hands
each rank its gradients.  Work a gang does inside the backward (the
sharded step's per-unit gathers, ``parallel/fsdp.py``) is done there in
memory: ``unit_gather`` hands each rank the gathered tensor with the
group's inputs, from which a backward re-gather rebuilds it, and
:attr:`VirtualMesh.deposits` collects each rank's gradient of a unit until
every rank's is in, then reduces them in the ranks' order.
"""

from __future__ import annotations

import copy
import queue
import threading
from typing import Callable, Optional

import numpy as np
import torch


def module_replica(module: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``module`` for one virtual rank, its parameters on
    ``meta`` (the rank's tensors come in through
    ``torch.func.functional_call``), its buffers copied.  Ranks need
    modules of their own: ``functional_call`` swaps the tensors of the
    module it runs, and the ranks take turns in the middle of a call."""
    memo = {id(p): torch.nn.Parameter(torch.empty_like(p, device="meta"),
                                      requires_grad=p.requires_grad)
            for p in module.parameters()}
    return copy.deepcopy(module, memo)


class _Sum(torch.autograd.Function):
    """``psum``: every rank gets the sum (in rank order); each rank's
    gradient passes through to its own input."""

    @staticmethod
    def forward(ctx, *xs):
        total = xs[0].clone()
        for x in xs[1:]:
            total = total + x
        return tuple(total.clone() for _ in xs)

    @staticmethod
    def backward(ctx, *gs):
        return gs


class _Broadcast(torch.autograd.Function):
    """``pbroadcast``: each rank keeps its tensor; every rank's input gets
    the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, *xs):
        return tuple(x.clone() for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        total = gs[0].clone()
        for g in gs[1:]:
            total = total + g
        return tuple(total.clone() for _ in gs)


class _GatherInvariant(torch.autograd.Function):
    """``all_gather_invariant``: every rank gets the concatenation; each
    rank's input gets its slice of its own rank's gradient."""

    @staticmethod
    def forward(ctx, axis, *xs):
        ctx.axis, ctx.sizes = axis, [x.shape[axis] for x in xs]
        full = torch.cat(xs, dim=axis)
        return tuple(full.clone() for _ in xs)

    @staticmethod
    def backward(ctx, *gs):
        out, start = [], 0
        for g, size in zip(gs, ctx.sizes):
            out.append(g.narrow(ctx.axis, start, size).contiguous())
            start += size
        return (None, *out)


def _exchange(kind: str, xs: list, kw: dict) -> list:
    """One collective over one group's tensors (in group-rank order)."""
    n = len(xs)
    if kind == "psum":
        if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
            return list(_Sum.apply(*xs))
        return list(_Sum.forward(None, *xs))
    if kind == "pbroadcast":
        if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
            return list(_Broadcast.apply(*xs))
        return xs
    if kind in ("pmax", "pmin"):
        op = torch.maximum if kind == "pmax" else torch.minimum
        total = xs[0]
        for x in xs[1:]:
            total = op(total, x)
        return [total.clone() for _ in xs]
    if kind == "all_gather":
        axis = kw["axis"]
        if kw["tiled"]:
            return [torch.cat(xs, dim=axis) for _ in xs]
        return [torch.stack(xs, dim=axis) for _ in xs]
    if kind == "call":
        return kw["fn"](xs)
    if kind == "unit_gather":
        return [(torch.cat(xs), list(xs)) for _ in xs]
    if kind == "grad":
        losses = [x[0] for x in xs]
        leaves = [t for x in xs for t in x[1]]
        got = torch.autograd.grad(losses, leaves, allow_unused=True)
        out, start = [], 0
        for x in xs:
            out.append(list(got[start:start + len(x[1])]))
            start += len(x[1])
        return out
    if kind == "all_gather_invariant":
        if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
            return list(_GatherInvariant.apply(kw["axis"], *xs))
        return [torch.cat(xs, dim=kw["axis"]) for _ in xs]
    if kind == "reduce_scatter":
        axis = kw["axis"]
        total = xs[0]
        for x in xs[1:]:
            total = total + x
        return [t.contiguous() for t in torch.chunk(total, n, dim=axis)]
    if kind == "all_to_all":
        split, concat = kw["split_axis"], kw["concat_axis"]
        parts = [torch.chunk(x, n, dim=split) for x in xs]
        return [torch.cat([parts[q][r] for q in range(n)], dim=concat) for r in range(n)]
    if kind == "ppermute":
        out: list = [None] * n
        for src, dst in kw["perm"]:
            out[dst] = xs[src].clone()
        return [o if o is not None else torch.zeros_like(xs[r]) for r, o in enumerate(out)]
    raise ValueError(f"unknown collective {kind!r}")


class VirtualMesh:
    """A ``DeviceMesh`` stand-in over ``shape`` ranks named ``names`` in one
    process (see the module doc).  ``mesh`` is the rank grid, as a
    ``DeviceMesh``'s; :meth:`get_local_rank` answers for the calling
    rank's thread."""

    is_virtual = True

    def __init__(self, names, shape):
        self.mesh_dim_names = tuple(names)
        self.mesh = torch.arange(int(np.prod(shape))).reshape(tuple(shape))
        self.size = int(np.prod(shape))
        self._local = threading.local()
        self._cv = threading.Condition()
        self._turn = 0
        self._pending: dict = {}
        self._results: dict = {}
        self._error: Optional[BaseException] = None
        self.calls: dict = {}   # collective kind -> calls per rank, last run
        # the backward's unit gradients awaiting every rank's (parallel/fsdp.py)
        self.deposits: dict = {}
        self.in_backward = False   # the joint backward is running
        self._tasks: Optional[queue.Queue] = None   # on_caller's, while run runs
        # each rank's coordinates and groups, worked out once (a decode
        # tick asks for them at every dense and collective)
        self._coords: dict = {}
        self._groups: dict = {}

    # -- the DeviceMesh surface ------------------------------------------------

    @property
    def rank(self) -> int:
        rank = getattr(self._local, "rank", None)
        if rank is None:
            raise RuntimeError("a VirtualMesh's collectives run inside VirtualMesh.run")
        return rank

    def get_local_rank(self, axis: str) -> int:
        rank = self.rank
        if rank not in self._coords:
            self._coords[rank] = tuple(int(c) for c in np.unravel_index(
                rank, tuple(self.mesh.shape)))
        return self._coords[rank][self.mesh_dim_names.index(axis)]

    def _group_of(self, rank: int, names: tuple) -> tuple:
        """(the group key, this rank's index in it, its ranks in order)."""
        if (rank, names) not in self._groups:
            self._groups[rank, names] = self._make_group(rank, names)
        return self._groups[rank, names]

    def _make_group(self, rank: int, names: tuple) -> tuple:
        shape = tuple(self.mesh.shape)
        coords = list(np.unravel_index(rank, shape))
        dims = [self.mesh_dim_names.index(a) for a in names]
        key = tuple(c for d, c in enumerate(coords) if d not in dims)
        members = []
        for idx in np.ndindex(*[shape[d] for d in dims]):
            c = list(coords)
            for d, i in zip(dims, idx):
                c[d] = i
            members.append(int(np.ravel_multi_index(c, shape)))
        return key, members.index(rank), members

    # -- running the ranks -----------------------------------------------------

    def collective(self, kind: str, x, names: tuple, **kw):
        """This rank's part of a collective every rank calls alike."""
        r = self.rank
        with self._cv:
            self._pending[r] = (kind, x, names, kw)
            if r == self.size - 1:
                try:
                    self._results = self._complete()
                except BaseException as exc:   # the other ranks must stop too
                    self._error = exc
                    self._cv.notify_all()
                    raise
                self._pending = {}
            self._turn = (r + 1) % self.size
            self._cv.notify_all()
            self._wait_turn(r)
            return self._results.pop(r)

    def _complete(self) -> dict:
        kinds = {(v[0], v[2]) for v in self._pending.values()}
        if len(kinds) != 1 or len(self._pending) != self.size:
            raise RuntimeError(f"the ranks called different collectives: "
                               f"{ {r: v[:1] + v[2:3] for r, v in self._pending.items()} }")
        kind, _, names, kw = self._pending[0]
        self.calls[kind] = self.calls.get(kind, 0) + 1
        out = {}
        done = set()
        for r in range(self.size):
            if r in done:
                continue
            _, _, members = self._group_of(r, names)
            self.in_backward = kind == "grad"
            try:
                got = _exchange(kind, [self._pending[m][1] for m in members], kw)
            finally:
                self.in_backward = False
            for m, t in zip(members, got):
                out[m] = t
            done.update(members)
        return out

    def on_caller(self, task: Callable[[], object]):
        """``task()`` run on the thread that called :meth:`run` while this
        rank waits (called outside a rank, run here): host work that wants
        the CPU's cores (the ZeRO-offload host update), where a rank's thread
        runs its CPU ops on one core (:meth:`run`)."""
        if getattr(self._local, "rank", None) is None or self._tasks is None:
            return task()
        box = {"done": threading.Event()}
        self._tasks.put((task, box))
        box["done"].wait()
        if "error" in box:
            raise box["error"]
        return box["result"]

    def _wait_turn(self, r: int) -> None:
        self._cv.wait_for(lambda: self._turn == r or self._error is not None)
        if self._error is not None:
            raise RuntimeError("another virtual rank failed") from self._error

    def run(self, fn: Callable[[int], object], config=None) -> list:
        """``[fn(0), ..., fn(n - 1)]``, the ranks run in turn (see the
        module doc), with this mesh as the ambient one (``config``, a
        ``ParallelismConfig``, beside it).  Re-raises the first rank's
        error."""
        from .. import state

        results: list = [None] * self.size
        self._turn, self._pending, self._results, self._error = 0, {}, {}, None
        self.calls, self.deposits = {}, {}
        grad = torch.is_grad_enabled()
        # each rank's thread works on the caller's card with its context
        # current: a kernel library launched from a thread that has run no
        # CUDA call yet would find none (its TMA descriptors need one)
        device = (torch.cuda.current_device()
                  if torch.cuda.is_available() and torch.cuda.is_initialized() else None)

        # a rank's CPU ops run on one core: each thread that parallelises a
        # CPU op masters an OpenMP team of its own, and the ranks' idle teams
        # slow every other team's ops several times over; the caller's own
        # count comes back after the run (host work that wants the cores runs
        # on the caller: on_caller)
        threads_before = torch.get_num_threads()

        def worker(r):
            self._local.rank = r
            torch.set_num_threads(1)
            try:
                if device is not None:
                    torch.cuda.set_device(device)
                with self._cv:
                    self._wait_turn(r)
                with torch.set_grad_enabled(grad):
                    results[r] = fn(r)
                with self._cv:
                    self._turn = r + 1
                    self._cv.notify_all()
            except BaseException as exc:
                with self._cv:
                    if self._error is None:
                        self._error = exc
                    self._cv.notify_all()

        saved = dict(state._AMBIENT)
        state._AMBIENT.update(mesh=self, config=config)
        self._tasks = queue.Queue()
        try:
            threads = [threading.Thread(target=worker, args=(r,), daemon=True)
                       for r in range(self.size)]
            for t in threads:
                t.start()
            # the caller's thread runs what the ranks hand it (on_caller)
            while any(t.is_alive() for t in threads):
                try:
                    task, box = self._tasks.get(timeout=0.01)
                except queue.Empty:
                    continue
                try:
                    box["result"] = task()
                except BaseException as exc:   # handed back to the rank
                    box["error"] = exc
                box["done"].set()
            for t in threads:
                t.join()
        finally:
            self._tasks = None
            torch.set_num_threads(threads_before)
            state._AMBIENT.clear()
            state._AMBIENT.update(saved)
        if self._error is not None:
            raise self._error
        return results
