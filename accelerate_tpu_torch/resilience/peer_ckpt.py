"""Peer-redundant hot checkpoints: buddy-rank host-RAM snapshots for training
(mirrors ``accelerate_tpu/resilience/peer_ckpt.py``).

A gang that lost ONE rank's state should not pay a filesystem round trip
to recover it.  Gemini (Wang et al., SOSP'23) keeps the newest snapshots
in a *peer's* host RAM; CheckFreq (Mohan et al., FAST'21) makes the
snapshot nearly free, the device-to-host copy its only synchronous part.
:class:`PeerSnapshotter` is that middle rung of the recovery ladder:

- **Two-phase snapshot.**  Phase 1 (synchronous): every train-state leaf
  copied to host memory.  The copy is load-bearing: the port's step
  updates params and optimizer state in place, and on the CPU
  ``t.cpu()`` is ``t`` itself, so a snapshot taken without a copy would
  train along with the model.  Phase 2: the wave is broadcast to the
  buddy rank (``rank ^ 1``) in sorted wire-name order, every rank issuing
  the same collectives, receivers passing schema-sized zeros.  Host
  payloads ride a gloo group beside an NCCL world (NCCL takes no CPU
  tensors), each leaf as its raw bytes (``uint8``), the dtype restored
  by a view on receipt.
- **Schema gate.**  Construction derives :func:`snapshot_schema` from the
  template and all-gathers its 8-byte digest; ranks whose templates
  disagree fail at arm time, not with a shape error mid-exchange.
- **CRC-verified recovery.**  :meth:`PeerSnapshotter.recover` intersects
  the waves every rank can still obtain (its own host copies and what its
  buddy holds for it), agrees on the newest with fixed-shape int64
  collectives, re-streams missing copies from buddies, re-verifies every
  leaf's crc32 and rebuilds the state on the template's devices.  A torn
  copy (the ``partial_ckpt`` fault) fails its crc and drops out; past the
  RAM horizon the caller falls back to the disk rung
  (:meth:`~accelerate_tpu_torch.Accelerator.recover`).

Wire names are the port's train-state names, as its checkpoint writes
them (``params.<name>``, ``opt_state.<i>``, ``step``, ``rng``, ...); the
``torch.Generator`` travels as its ``get_state()`` bytes.
:func:`peer_ckpt_accounting` prices a wave from the schema alone (the
predicted side of ``recovery.peer_snapshot_bytes``); each capture records
the measured side.  Tolerance 0.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import Optional

import numpy as np
import torch

from .. import native


class PeerSchemaError(RuntimeError):
    """Ranks tried to arm peer snapshots over disagreeing state schemas, or
    over a state whose leaves are not whole on every rank."""


class PeerSnapshotCorruptError(RuntimeError):
    """A peer-held snapshot failed crc re-verification after re-streaming."""


def _int(v: int) -> torch.Tensor:
    return torch.tensor(int(v), dtype=torch.int64)


def _flat_leaves(train_state) -> dict[str, torch.Tensor]:
    """Wire name -> tensor of a :class:`~..accelerator.TrainState` (or of a
    plain name -> tensor / array dict), in wire-name order."""
    if isinstance(train_state, dict):
        out = {k: (v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v)))
               for k, v in train_state.items()}
        return dict(sorted(out.items()))
    from ..optimizer import flatten_opt_state

    s = train_state
    out = {f"params.{n}": p for n, p in s.params.items()}
    opt_tensors, meta = flatten_opt_state(s.opt_state)
    out.update({f"opt_state.{i}": t for i, t in enumerate(opt_tensors)})
    out.update({f"opt_state.hyper.{k}": v for k, v in meta["hyperparams"].items()
                if isinstance(v, torch.Tensor)})
    out.update({f"opt_state.field.{k}": _int(v) for k, v in meta["fields"].items()})
    out["step"] = _int(s.step)
    out["accum_step"] = _int(s.accum_step)
    if s.rng is not None:
        out["rng"] = s.rng.get_state()
    for k, v in (s.guard_state or {}).items():
        out[f"guard_state.{k}"] = v
    for i, g in enumerate(s.grad_accum or []):
        out[f"grad_accum.{i}"] = g
    if s.loss_scale is not None:
        out["loss_scale.scale"] = s.loss_scale.scale
        out["loss_scale.counter"] = s.loss_scale.counter
    for name, m in (s.fp8_state or {}).items():
        out[f"fp8_state.{name}.amax_history"] = m.amax_history
        out[f"fp8_state.{name}.scale"] = m.scale
    if s.comm_state is not None:
        qs, errs = s.comm_state
        out.update({f"comm_state.q.{n}": q for n, q in qs.items() if q is not None})
        out.update({f"comm_state.e.{n}": e for n, e in errs.items() if e is not None})
    return dict(sorted(out.items()))


def _dtype_str(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def snapshot_schema(train_state) -> dict:
    """Wire schema of one snapshot wave: per-leaf shape and dtype plus the
    total byte price.  The construction-time cross-rank gate and
    :func:`peer_ckpt_accounting` both read this dict."""
    leaves = {}
    total = 0
    for name, t in _flat_leaves(train_state).items():
        leaves[name] = {"shape": [int(s) for s in t.shape], "dtype": _dtype_str(t)}
        total += t.numel() * t.element_size()
    return {"leaves": leaves, "snapshot_bytes": int(total)}


def check_snapshot_schemas(a: dict, b: dict) -> None:
    """Raise :class:`PeerSchemaError` unless two schemas agree exactly."""
    if a != b:
        extra = sorted(set(a["leaves"]) ^ set(b["leaves"]))
        raise PeerSchemaError(
            "peer snapshot schemas disagree"
            + (f" (leaf set differs: {extra})" if extra else
               f" (byte price {a['snapshot_bytes']} != {b['snapshot_bytes']}"
               " or per-leaf shape/dtype mismatch)"))


def peer_ckpt_accounting(train_state) -> dict:
    """Predicted byte price of one peer snapshot wave; records the
    predicted side of the ``recovery.peer_snapshot_bytes`` twin."""
    schema = snapshot_schema(train_state)
    from ..telemetry import twin_registry

    twin_registry().record_predicted("recovery.peer_snapshot_bytes",
                                     float(schema["snapshot_bytes"]),
                                     source="resilience/peer_ckpt.peer_ckpt_accounting")
    return {"leaves": len(schema["leaves"]), "snapshot_bytes": schema["snapshot_bytes"],
            "kind": "predicted"}


def _bytes(t: torch.Tensor) -> np.ndarray:
    """The raw bytes of a contiguous host tensor, as a uint8 array (no copy)."""
    return t.reshape(-1).view(torch.uint8).numpy()


def _crc(t: torch.Tensor) -> int:
    return native.crc32(_bytes(t)) & 0xFFFFFFFF


@dataclasses.dataclass
class HostSnapshot:
    """One captured wave: host leaves by wire name and their crc32s."""

    step: int
    leaves: dict
    crc: dict
    nbytes: int
    taken_at: float

    def verify(self) -> bool:
        return all(_crc(v) == self.crc[k] for k, v in self.leaves.items())


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A detached host copy of ``t`` that no later in-place update reaches:
    a card tensor into page-locked memory, a host tensor cloned."""
    t = t.detach()
    if t.device.type == "cpu":
        return t.clone(memory_format=torch.contiguous_format)
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def capture_host_snapshot(train_state, step: int = 0) -> HostSnapshot:
    """Phase 1 alone: a crc-tagged host copy of a live state (also a cheap
    way to clone a state, a harness's per-pass reset)."""
    leaves = _flat_leaves(train_state)
    host = {k: _host_copy(v) for k, v in leaves.items()}
    if any(v.device.type == "cuda" for v in leaves.values()):
        torch.cuda.current_stream().synchronize()
    return HostSnapshot(step=int(step), leaves=host,
                        crc={k: _crc(v) for k, v in host.items()},
                        nbytes=sum(v.numel() * v.element_size() for v in host.values()),
                        taken_at=time.monotonic())


def restore_host_snapshot(snap: HostSnapshot, template):
    """Host wave -> a state on the template's devices.  A train state's
    params are copied into the template's own tensors (a module trains in
    place) and its generator takes the wave's state; the rest are new
    tensors.  A plain dict template gives a dict."""
    host = snap.leaves
    if isinstance(template, dict):
        return {k: host[k].to(v.device if isinstance(v, torch.Tensor) else "cpu",
                              copy=True).reshape(tuple(np.shape(v)))
                for k, v in template.items()}
    from ..optimizer import flatten_opt_state, unflatten_opt_state

    t = template

    def on(src, like):
        return src.reshape(like.shape).to(like.device, copy=True)

    tmpl_tensors, meta = flatten_opt_state(t.opt_state)
    hyper = dict(meta["hyperparams"])
    hyper.update({k: float(host[f"opt_state.hyper.{k}"]) for k, v in hyper.items()
                  if isinstance(v, torch.Tensor)})
    fields = {k: int(host[f"opt_state.field.{k}"]) for k in meta["fields"]}
    opt_state = unflatten_opt_state(t.opt_state, [host[f"opt_state.{i}"]
                                                  for i in range(len(tmpl_tensors))],
                                    fields, hyper)
    guard = ({k: on(host[f"guard_state.{k}"], v) for k, v in t.guard_state.items()}
             if t.guard_state is not None else None)
    accum = ([on(host[f"grad_accum.{i}"], g) for i, g in enumerate(t.grad_accum)]
             if t.grad_accum is not None else None)
    loss_scale = t.loss_scale
    if loss_scale is not None:
        loss_scale = type(loss_scale)(on(host["loss_scale.scale"], loss_scale.scale),
                                      loss_scale.growth_factor, loss_scale.backoff_factor,
                                      loss_scale.growth_interval,
                                      on(host["loss_scale.counter"], loss_scale.counter))
    fp8_state = t.fp8_state
    if fp8_state is not None:
        fp8_state = {n: type(m)(on(host[f"fp8_state.{n}.amax_history"], m.amax_history),
                                on(host[f"fp8_state.{n}.scale"], m.scale))
                     for n, m in fp8_state.items()}
    comm_state = t.comm_state
    if comm_state is not None:
        qs, errs = comm_state
        comm_state = ({n: on(host[f"comm_state.q.{n}"], q) if q is not None else None
                       for n, q in qs.items()},
                      {n: on(host[f"comm_state.e.{n}"], e) if e is not None else None
                       for n, e in errs.items()})
    with torch.no_grad():
        for name, p in t.params.items():
            p.copy_(host[f"params.{name}"].reshape(p.shape))
    if t.rng is not None and "rng" in host:
        t.rng.set_state(host["rng"].clone())
    return t.replace(step=int(host["step"]), accum_step=int(host["accum_step"]),
                     params=t.params, opt_state=opt_state, guard_state=guard,
                     grad_accum=accum, loss_scale=loss_scale, fp8_state=fp8_state,
                     comm_state=comm_state)


def _buddy(rank: int, world: int) -> int:
    """Pair adjacent ranks (0 <-> 1, 2 <-> 3, ...); the odd rank out buddies
    itself (its 'peer' copies are extra local waves, still crc-verified)."""
    b = rank ^ 1
    return b if b < world else rank


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class PeerSnapshotter:
    """Interval-driven buddy-rank host-RAM snapshots of one train state.

    Armed by the prepared step when ``ResiliencePlugin.peer_snapshot_every
    > 0`` (``accelerator.peer_snapshotter``).  Holds the newest ``keep``
    waves of its OWN state (``local``) and of its buddy's (``peer``).
    ``plan``: the train state's :class:`~..parallel.fsdp.DataParallelPlan`
    (None outside a world), for the gate that every leaf is whole here."""

    def __init__(self, template, interval: int, *, keep: int = 2, plan=None):
        if interval <= 0:
            raise ValueError("peer snapshot interval must be positive")
        if keep < 1:
            raise ValueError("peer_snapshot_keep must be >= 1")
        from ..state import world

        self.world, self.rank = world()
        self.buddy = _buddy(self.rank, self.world)
        self.interval = int(interval)
        self.keep = int(keep)
        self.schema = snapshot_schema(template)
        self.local: list[HostSnapshot] = []   # my waves, newest last
        self.peer: list[HostSnapshot] = []    # my buddy's waves I hold for it

        # gate 1: a buddy can re-stream only whole leaves; a rank's range of
        # a sharded leaf, or its tp / ep slice, is not the state it lost
        if plan is not None and (plan.any_sharded or plan.tp > 1 or plan.ep > 1):
            parts = [n for n, lay in plan.layouts.items() if lay.sharded or lay.tp_dim is not None]
            raise PeerSchemaError(
                f"peer snapshots need state that is whole on every rank, but "
                f"{len(parts)} leaves (e.g. {parts[:3]}) are ranges or slices under this "
                "plan (FULL_SHARD / HYBRID_SHARD / SHARD_GRAD_OP, tp or ep); use "
                "NO_SHARD data parallelism or disk checkpoints")

        self._group = None
        if self.world > 1:
            import torch.distributed as dist

            # host payloads on gloo: beside an NCCL world, a group of its own
            if dist.get_backend() != "gloo":
                self._group = dist.new_group(backend="gloo")
            # gate 2: the same schema on every rank, or a loud failure at arm
            # time on all of them at once
            digest = hashlib.sha256(json.dumps(self.schema, sort_keys=True).encode()).digest()[:8]
            mine = torch.from_numpy(np.frombuffer(digest, dtype=np.int64).copy())
            gathered = self._all_gather(mine)
            if not (gathered == gathered[0]).all():
                raise PeerSchemaError("peer snapshot schema hash differs across ranks: "
                                      "templates disagree in shape, dtype or leaf set")

    # -- collectives on host tensors -------------------------------------

    def _all_gather(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        out = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(out, x, group=self._group)
        return torch.stack(out)

    def _broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        import torch.distributed as dist

        dist.broadcast(x, src=src, group=self._group)
        return x

    def _names(self) -> list:
        return sorted(self.schema["leaves"])

    def _zeros(self, name: str) -> torch.Tensor:
        spec = self.schema["leaves"][name]
        return torch.zeros(spec["shape"], dtype=_torch_dtype(spec["dtype"]))

    def _stream(self, src: int, snap: Optional[HostSnapshot], keep_it: bool):
        """One wave from ``src`` (``snap`` there, None elsewhere): crcs first,
        then each leaf's bytes in sorted wire-name order.  Returns ``(leaves,
        crcs)`` where ``keep_it``, else ``(None, None)``."""
        names = self._names()
        crc_in = torch.zeros(len(names), dtype=torch.int64)
        if snap is not None:
            crc_in = torch.tensor([snap.crc[n] for n in names], dtype=torch.int64)
        crcs = self._broadcast(crc_in, src) & 0xFFFFFFFF
        received = {}
        for name in names:
            payload = snap.leaves[name] if snap is not None else self._zeros(name)
            # the raw bytes: every dtype crosses gloo as it is (a receiver's
            # zeros take them in place)
            out = self._broadcast(torch.from_numpy(_bytes(payload)), src)
            if keep_it:
                spec = self.schema["leaves"][name]
                received[name] = out.view(_torch_dtype(spec["dtype"])).reshape(spec["shape"])
        if not keep_it:
            return None, None
        return received, {n: int(crcs[i]) for i, n in enumerate(names)}

    # -- phase 1 + 2: capture and exchange ---------------------------------

    def maybe_snapshot(self, train_state, step: int) -> Optional[HostSnapshot]:
        if step % self.interval != 0:
            return None
        return self.snapshot(train_state, step)

    def snapshot(self, train_state, step: int) -> HostSnapshot:
        """Capture one wave (synchronous device-to-host copy) and stream it
        to the buddy.  EVERY rank must call this at the same step: phase 2
        is collective."""
        snap = capture_host_snapshot(train_state, step)
        from ..telemetry import twin_registry

        twin_registry().record_measured("recovery.peer_snapshot_bytes", float(snap.nbytes),
                                        source="resilience/peer_ckpt.PeerSnapshotter")
        self.local.append(snap)
        del self.local[: -self.keep]
        if self.world > 1:
            self._exchange(snap)
        self._maybe_tear()
        return snap

    def _exchange(self, snap: HostSnapshot) -> None:
        """Phase 2: every rank broadcasts its wave in turn; each keeps only
        its buddy's copy (none it sent itself)."""
        for src in range(self.world):
            keep_it = _buddy(src, self.world) == self.rank and src != self.rank
            leaves, crcs = self._stream(src, snap if src == self.rank else None, keep_it)
            if keep_it:
                self.peer.append(HostSnapshot(
                    step=snap.step, leaves=leaves, crc=crcs,
                    nbytes=sum(v.numel() * v.element_size() for v in leaves.values()),
                    taken_at=time.monotonic()))
                del self.peer[: -self.keep]

    def _maybe_tear(self) -> None:
        """The ``partial_ckpt`` fault: flip one byte of the newest stored
        copy (the peer's if any, else our own) without updating its crc, so
        recovery's re-verification must skip the wave."""
        from .faults import fault_point

        for ev in fault_point("peer_snapshot"):
            if ev.kind != "partial_ckpt":
                continue
            store = self.peer if self.peer else self.local
            if not store:
                continue
            snap = store[-1]
            leaf = snap.leaves[sorted(snap.leaves)[0]]
            raw = leaf.reshape(-1).view(torch.uint8)
            raw[0] ^= 0xFF

    # -- rank-loss bookkeeping ---------------------------------------------

    def forget_local(self) -> None:
        """This rank's state is gone (the ``rank_loss`` fault): drop every
        wave of our own state.  What the buddy holds for us survives."""
        self.local.clear()

    def reset(self) -> None:
        self.local.clear()
        self.peer.clear()

    # -- recovery -------------------------------------------------------------

    def newest_restorable_step(self) -> Optional[int]:
        """Newest crc-valid wave THIS rank could restore alone (no
        collectives)."""
        steps = [s.step for s in self.local if s.verify()]
        if self.buddy == self.rank:
            steps += [s.step for s in self.peer if s.verify()]
        return max(steps) if steps else None

    def recover(self, template):
        """Agree on the newest wave EVERY rank can restore, re-stream the
        copies ranks lost from their buddies, and rebuild the state on the
        template's devices: ``(train_state, step)``, or None when no common
        wave survives (the caller falls back to disk).  Every rank calls
        this together."""
        if self.world <= 1:
            candidates = [s for s in self.local + self.peer if s.verify()]
            if not candidates:
                return None
            snap = max(candidates, key=lambda s: s.step)
            return self._restore(snap, template), snap.step

        def vec(snaps):
            steps = sorted({s.step for s in snaps if s.verify()})[-self.keep:]
            v = torch.full((self.keep,), -1, dtype=torch.int64)
            v[: len(steps)] = torch.tensor(steps, dtype=torch.int64)
            return v

        mine = self._all_gather(vec(self.local))
        held = self._all_gather(vec(self.peer))
        # the same on every rank: rank r can obtain a wave it still holds,
        # or one its buddy holds for it
        common: Optional[set] = None
        for r in range(self.world):
            obtainable = {int(s) for s in mine[r] if s >= 0}
            obtainable |= {int(s) for s in held[_buddy(r, self.world)] if s >= 0}
            common = obtainable if common is None else common & obtainable
        if not common:
            return None
        agreed = max(common)
        snap = next((s for s in self.local if s.step == agreed and s.verify()), None)
        # re-send legs: for every rank missing the agreed wave its buddy
        # streams the held copy back, in rank order, every rank issuing the
        # same collectives
        for r in range(self.world):
            if any(int(s) == agreed for s in mine[r]):
                continue
            src = _buddy(r, self.world)
            src_snap = None
            if src == self.rank:
                src_snap = next((s for s in self.peer if s.step == agreed and s.verify()), None)
            leaves, crcs = self._stream(src, src_snap, r == self.rank)
            if r == self.rank:
                snap = HostSnapshot(
                    step=agreed, leaves=leaves, crc=crcs,
                    nbytes=sum(v.numel() * v.element_size() for v in leaves.values()),
                    taken_at=time.monotonic())
                if not snap.verify():
                    raise PeerSnapshotCorruptError(
                        f"re-streamed wave {agreed} failed crc re-verification")
        if snap is None:  # the agreement guarantees a copy
            return None
        return self._restore(snap, template), agreed

    def _restore(self, snap: HostSnapshot, template):
        return restore_host_snapshot(snap, template)


__all__ = ["HostSnapshot", "PeerSchemaError", "PeerSnapshotCorruptError", "PeerSnapshotter",
           "capture_host_snapshot", "check_snapshot_schemas", "peer_ckpt_accounting",
           "restore_host_snapshot", "snapshot_schema"]
